"""Block assembly: one (init, seq, decode, init_cache) quadruple per block
type, with uniform signatures so a stage runs as a loop over its stacked
per-layer params (port of ``repro/models/blocks.py``).

The port runs block types ``attn`` and ``attn_g`` (the ``_g`` suffix =
global attention, ignores cfg.window).  The others raise
``NotImplementedError`` naming their ROADMAP item (Queue 1).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp, init_norm,
                                       split_keys)

_NOT_PORTED = {
    "moe": "item 13 (MoE FFN)",
    "mla": "item 12 (MLA attention)",
    "mla_moe": "item 12 (MLA attention) and item 13 (MoE FFN)",
    "hybrid": "item 14 (mamba and hybrid blocks)",
    "hybrid_g": "item 14 (mamba and hybrid blocks)",
    "mamba": "item 14 (mamba and hybrid blocks)",
    "mlstm": "item 15 (xLSTM blocks)",
    "slstm": "item 15 (xLSTM blocks)",
}


def _check_ported(block_type: str) -> None:
    if block_type in _NOT_PORTED:
        raise NotImplementedError(
            f"block type {block_type!r} is not ported to repro_torch yet: "
            f"ROADMAP Queue 1 {_NOT_PORTED[block_type]}")
    if block_type not in ("attn", "attn_g"):
        raise ValueError(f"unknown block type {block_type!r}")


def block_window(cfg: ArchConfig, block_type: str) -> Optional[int]:
    if block_type.endswith("_g"):
        return None
    return cfg.window


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(cfg: ArchConfig, block_type: str, gen, dtype, device="cpu") -> dict:
    _check_ported(block_type)
    ks = split_keys(gen, 6)  # the reference's split; ks[0] attention, ks[2] ffn
    p: dict[str, Any] = {"norm1": init_norm(cfg, cfg.d_model, dtype, device),
                         "attn": attn.init_attention(cfg, ks[0], dtype, device)}
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_mlp(cfg, ks[2], cfg.d_model, cfg.d_ff, dtype, device)
    return p


# ---------------------------------------------------------------------------
# sequence (prefill) forward
# ---------------------------------------------------------------------------

def block_seq(
    cfg: ArchConfig,
    block_type: str,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    prefix_len=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, aux_loss)."""
    _check_ported(block_type)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    y = attn.attention_seq(cfg, p["attn"], h, positions,
                           layer_window=block_window(cfg, block_type),
                           prefix_len=prefix_len)
    x = x + y
    if "ffn" in p:
        h2 = apply_norm(cfg, p["norm2"], x)
        x = x + apply_mlp(cfg, p["ffn"], h2)
    return x, aux


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, block_type: str, batch: int, cache_len: int,
                     dtype, device="cpu"):
    _check_ported(block_type)
    w = block_window(cfg, block_type)
    eff = cache_len if w is None else min(cache_len, w)
    return {"kv": attn.init_kv_cache(cfg, batch, eff, dtype, device)}


def block_decode(
    cfg: ArchConfig,
    block_type: str,
    p,
    x_t: torch.Tensor,
    cache,
    t: int,
) -> tuple[torch.Tensor, Any]:
    """One-token block step; the KV cache is updated in place."""
    _check_ported(block_type)
    h = apply_norm(cfg, p["norm1"], x_t)
    new_cache = dict(cache)
    y, new_cache["kv"] = attn.attention_decode(
        cfg, p["attn"], h, cache["kv"], t,
        layer_window=block_window(cfg, block_type))
    x_t = x_t + y
    if "ffn" in p:
        h2 = apply_norm(cfg, p["norm2"], x_t)
        x_t = x_t + apply_mlp(cfg, p["ffn"], h2)
    return x_t, new_cache
