"""Config registry of the port.

``get_config(arch_id)`` returns the full-size ArchConfig; ``smoke_config``
returns the reduced same-family variant (<= 2 layers, d_model 128) the
CPU tests use.  The port runs starcoder2-15b; the other nine
architectures of the JAX package raise ``NotImplementedError`` naming the
ROADMAP item (Queue 1) that ports what they need.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ArchConfig

_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
}

# architectures of the JAX package not ported yet -> their ROADMAP item
_NOT_PORTED = {
    "granite-moe-3b-a800m": "item 13 (MoE FFN)",
    "hymba-1.5b": "item 14 (mamba and hybrid blocks)",
    "deepseek-coder-33b": "item 17 (the other configs)",
    "phi3-medium-14b": "item 17 (the other configs)",
    "xlstm-125m": "item 15 (xLSTM blocks)",
    "deepseek-v3-671b": "item 12 (MLA attention)",
    "paligemma-3b": "item 16 (modality frontends)",
    "qwen2-72b": "item 17 (the other configs)",
    "hubert-xlarge": "item 16 (modality frontends)",
}

ARCH_IDS: list[str] = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported to repro_torch yet: ROADMAP Queue 1 "
            f"{_NOT_PORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


# reduced layer plans preserving each family's block mix (the reference's
# table, for the architectures the port runs)
_SMOKE_PLANS = {
    "starcoder2-15b": ((("attn",), 2),),
}


def smoke_config(arch_id: str) -> ArchConfig:
    cfg = get_config(arch_id)
    plan = _SMOKE_PLANS[arch_id]
    n_layers = sum(len(c) * r for c, r in plan)
    d_model = 128
    n_heads = min(cfg.n_heads, 4)
    ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_kv = max(n_heads // ratio, 1)
    updates = dict(
        n_layers=n_layers,
        layer_plan=plan,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_model // n_heads,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab=min(cfg.vocab, 512),
        window=min(cfg.window, 32) if cfg.window else None,
        mlstm_chunk=8,
        dtype="float32",
        remat=False,
        fl_m=1,
    )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **updates)
