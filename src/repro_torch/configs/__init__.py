"""Config registry of the port.

``get_config(arch_id)`` returns the full-size ArchConfig; ``smoke_config``
returns the reduced same-family variant (<= 2 layers, d_model 128) the
CPU tests use.  The port runs all ten of the JAX package's architectures:
starcoder2-15b, granite-moe-3b-a800m, deepseek-v3-671b, hymba-1.5b,
xlstm-125m, paligemma-3b, hubert-xlarge, deepseek-coder-33b,
phi3-medium-14b and qwen2-72b; on the card every block type trains,
xLSTM's sLSTM through its backward kernel (``kernels.slstm.ops``'s
``SLSTMScan``).  qwen2-72b's 145.4 GB of bf16 weights need several cards:
it runs over a device mesh's ``model`` axis (``models/sharding.py``), as
do the other dense attention configs; every architecture runs over a
mesh's ``data`` axis in replica mode.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ArchConfig, FrontendStub, MLAConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-125m": "xlstm_125m",
    "paligemma-3b": "paligemma_3b",
    "hubert-xlarge": "hubert_xlarge",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-72b": "qwen2_72b",
}

# architectures of the JAX package not ported yet -> their ROADMAP item
_NOT_PORTED: dict[str, str] = {}

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
    "granite-moe-3b-a800m": ((("moe",), 2),),
    "starcoder2-15b": ((("attn",), 2),),
    "deepseek-v3-671b": ((("mla",), 1), (("mla_moe",), 1)),
    "hymba-1.5b": ((("hybrid_g",), 1), (("hybrid",), 1)),
    "xlstm-125m": ((("mlstm", "slstm"), 1),),
    "paligemma-3b": ((("attn",), 2),),
    "hubert-xlarge": ((("attn",), 2),),
    "deepseek-coder-33b": ((("attn",), 2),),
    "phi3-medium-14b": ((("attn",), 2),),
    "qwen2-72b": ((("attn",), 2),),
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
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_expert=64,
            n_shared=min(cfg.moe.n_shared, 1), impl="dense")
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.frontend is not None:
        updates["frontend"] = FrontendStub(
            kind=cfg.frontend.kind,
            tokens=4 if cfg.frontend.kind == "vision" else 0,
            dim=32)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **updates)
