"""Block assembly: one (init, seq, decode, init_cache) quadruple per block
type, with uniform signatures so a stage runs as a loop over its stacked
per-layer params (port of ``repro/models/blocks.py``).

Block types: ``attn`` and ``attn_g`` (the ``_g`` suffix = global
attention, ignores cfg.window), ``moe`` (attention + MoE FFN), ``mla`` (MLA
+ dense MLP), ``mla_moe`` (MLA + MoE FFN), ``mamba`` (a Mamba SSM alone),
hymba's ``hybrid`` / ``hybrid_g`` (attention and Mamba heads on the same
normed input, averaged, + dense MLP), and xLSTM's ``mlstm`` and ``slstm``
(the recurrent core on the normed input + the residual; the core carries
its own projections, so no second norm and no FFN).

Under ``sharding.tensor_parallel`` (a mesh ``model`` axis over 1) the
``attn`` and ``attn_g`` blocks run tensor-parallel; every other block type
raises, naming the ROADMAP item that lays it out (19b).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as S
from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp, init_norm,
                                       split_keys)

_BLOCK_TYPES = ("attn", "attn_g", "moe", "mla", "mla_moe", "hybrid", "hybrid_g", "mamba",
                "mlstm", "slstm")
# xLSTM blocks: (init, sequence form, decode, cache init) of the core
_XLSTM = {
    "mlstm": (ssm.init_mlstm, ssm.mlstm_seq, ssm.mlstm_decode, ssm.init_mlstm_cache),
    "slstm": (ssm.init_slstm, ssm.slstm_seq, ssm.slstm_decode, ssm.init_slstm_cache),
}


_TENSOR_PARALLEL = ("attn", "attn_g")  # the block types laid over a model axis


def _check_known(block_type: str) -> None:
    if block_type not in _BLOCK_TYPES:
        raise ValueError(f"unknown block type {block_type!r}")
    if S.model_axis() is not None and block_type not in _TENSOR_PARALLEL:
        S.refuse(f"block type {block_type!r}")


def block_window(cfg: ArchConfig, block_type: str) -> Optional[int]:
    if block_type.endswith("_g"):
        return None
    return cfg.window


def _has_attn(block_type: str) -> bool:
    return block_type in ("attn", "attn_g", "moe", "hybrid", "hybrid_g")


def _is_mla(block_type: str) -> bool:
    return block_type in ("mla", "mla_moe")


def _has_mlp(cfg: ArchConfig, block_type: str) -> bool:
    return block_type in ("attn", "attn_g", "mla", "hybrid", "hybrid_g") and cfg.d_ff > 0


def _has_moe(block_type: str) -> bool:
    return block_type in ("moe", "mla_moe")


def _has_mamba(block_type: str) -> bool:
    return block_type in ("hybrid", "hybrid_g", "mamba")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(cfg: ArchConfig, block_type: str, gen, dtype, device="cpu") -> dict:
    _check_known(block_type)
    # the reference's split: ks[0] attention (or the xLSTM core), ks[1]
    # mamba, ks[2] ffn
    ks = split_keys(gen, 6)
    p: dict[str, Any] = {"norm1": init_norm(cfg, cfg.d_model, dtype, device)}
    if block_type in _XLSTM:
        p["core"] = _XLSTM[block_type][0](cfg, ks[0], dtype, device)
        return p
    if _is_mla(block_type):
        p["attn"] = attn.init_mla(cfg, ks[0], dtype, device)
    elif _has_attn(block_type):
        p["attn"] = attn.init_attention(cfg, ks[0], dtype, device)
    if _has_mamba(block_type):
        # hymba: mamba heads run in parallel with attention on the same input
        p["mamba"] = ssm.init_mamba(cfg, ks[1], dtype, device)
    if _has_mlp(cfg, block_type) or _has_moe(block_type):
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
    if _has_moe(block_type):
        p["ffn"] = moe_mod.init_moe(cfg, ks[2], dtype, device)
    elif _has_mlp(cfg, block_type):
        p["ffn"] = init_mlp(cfg, ks[2], cfg.d_model, cfg.d_ff, dtype, device)
    return p


# ---------------------------------------------------------------------------
# sequence (train / prefill) forward
# ---------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, block_type: str, p, x) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN half, x + ffn(norm2(x)), and the MoE aux loss (0
    without a router)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" not in p:
        return x, aux
    h2 = apply_norm(cfg, p["norm2"], x)
    if _has_moe(block_type):
        out, aux = moe_mod.moe_ffn(cfg, p["ffn"], h2)
    else:
        out = apply_mlp(cfg, p["ffn"], h2)
    return x + out, aux


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
    _check_known(block_type)
    h = apply_norm(cfg, p["norm1"], x)
    if block_type in _XLSTM:
        return _ffn(cfg, block_type, p, x + _XLSTM[block_type][1](cfg, p["core"], h))
    if block_type == "mamba":
        return _ffn(cfg, block_type, p, x + ssm.mamba_seq(cfg, p["mamba"], h))
    if _is_mla(block_type):
        y = attn.mla_seq(cfg, p["attn"], h, positions, prefix_len=prefix_len)
    else:
        y = attn.attention_seq(cfg, p["attn"], h, positions,
                               layer_window=block_window(cfg, block_type),
                               prefix_len=prefix_len)
    if _has_mamba(block_type):  # hymba: parallel heads, fused by averaging
        y = 0.5 * (y + ssm.mamba_seq(cfg, p["mamba"], h))
    return _ffn(cfg, block_type, p, x + y)


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, block_type: str, batch: int, cache_len: int,
                     dtype, device="cpu"):
    _check_known(block_type)
    if block_type in _XLSTM:
        return {block_type: _XLSTM[block_type][3](cfg, batch, dtype, device)}
    cache: dict[str, Any] = {}
    if _is_mla(block_type):
        cache["mla"] = attn.init_mla_cache(cfg, batch, cache_len, dtype, device)
    elif _has_attn(block_type):
        w = block_window(cfg, block_type)
        eff = cache_len if w is None else min(cache_len, w)
        cache["kv"] = attn.init_kv_cache(cfg, batch, eff, dtype, device)
    if _has_mamba(block_type):
        d_inner = cfg.ssm_expand * cfg.d_model
        cache["mamba"] = ssm.init_mamba_cache(cfg, batch, d_inner, dtype, device)
    return cache


def block_decode(
    cfg: ArchConfig,
    block_type: str,
    p,
    x_t: torch.Tensor,
    cache,
    t: int,
) -> tuple[torch.Tensor, Any]:
    """One-token block step; the KV (or MLA latent) cache and the Mamba
    and xLSTM states are updated in place."""
    _check_known(block_type)
    h = apply_norm(cfg, p["norm1"], x_t)
    new_cache = dict(cache)
    if block_type in _XLSTM:
        y, new_cache[block_type] = _XLSTM[block_type][2](cfg, p["core"], h, cache[block_type])
        return x_t + y, new_cache
    if block_type == "mamba":
        y, new_cache["mamba"] = ssm.mamba_decode(cfg, p["mamba"], h, cache["mamba"])
        return x_t + y, new_cache
    if _is_mla(block_type):
        y, new_cache["mla"] = attn.mla_decode(cfg, p["attn"], h, cache["mla"], t)
    else:
        y, new_cache["kv"] = attn.attention_decode(
            cfg, p["attn"], h, cache["kv"], t,
            layer_window=block_window(cfg, block_type))
    if _has_mamba(block_type):
        ym, new_cache["mamba"] = ssm.mamba_decode(cfg, p["mamba"], h, cache["mamba"])
        y = 0.5 * (y + ym)
    x_t, _ = _ffn(cfg, block_type, p, x_t + y)
    return x_t, new_cache
