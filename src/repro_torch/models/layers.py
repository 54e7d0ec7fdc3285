"""Shared layers: norms, activations, MLPs, RoPE, embeddings, init
(port of ``repro/models/layers.py``).

Initializers draw from an explicit ``torch.Generator``, or from a
``repro_torch.prng`` key: with a key they reproduce the JAX package's
threefry init bit for bit (the same ``split`` of the key at each level and
the same ``normal`` draws), as the simulator's deep models need; with a
Generator they draw their own stream (the serving path's tests carry the
reference's weights across instead).  On the ``meta`` device they allocate
nothing and draw nothing, which gives the parameter tree's shapes and
dtypes alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models import sharding as S
from repro_torch.models.common import ArchConfig


def torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def is_key(gen) -> bool:
    """Whether ``gen`` is a ``repro_torch.prng`` key (else a Generator)."""
    return isinstance(gen, torch.Tensor)


def split_keys(gen, n: int) -> list:
    """``n`` subkeys of a key, as ``jax.random.split``; a Generator (or
    None) stands for all of them, drawing in call order."""
    if is_key(gen):
        return list(prng.split(gen, n).unbind(-2))
    return [gen] * n


def draw_normal(gen, shape, device) -> torch.Tensor:
    """Standard normal fp32 draw from a key or from ``gen`` (on its own
    device), moved to ``device``; an empty tensor on the meta device."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    if is_key(gen):
        return prng.normal(gen, tuple(shape)).to(dev)
    return torch.randn(shape, generator=gen, device=gen.device).to(dev)


def dense_init(gen, shape, in_axis_size=None, dtype=torch.float32, device="cpu"):
    """Scaled normal (LeCun-ish) initializer; with a key, the scale is the
    reference's float32 ``1 / sqrt(fan_in)``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    if is_key(gen):
        scale = float(np.float32(1.0) / np.sqrt(np.float32(max(fan_in, 1))))
    else:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    # the draw is a fresh tensor: scaled in place, one fp32 copy of the
    # largest weight (an expert stack) live instead of two
    return draw_normal(gen, shape, device).mul_(scale).to(dtype)


def embed_init(gen, shape, dtype=torch.float32, device="cpu"):
    return (draw_normal(gen, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, d: int, dtype, device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ArchConfig, p, x, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------

def act_fn(name: str, x):
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name in ("silu", "swiglu"):
        return F.silu(x)
    raise ValueError(name)


def init_mlp(cfg: ArchConfig, gen, d_in: int, d_ff: int, dtype, device="cpu"):
    k1, k2, k3 = split_keys(gen, 3)
    gated = cfg.act in ("swiglu", "geglu")
    p = {
        "w_in": dense_init(k1, (d_in, d_ff), d_in, dtype, device),
        "w_out": dense_init(k2, (d_ff, d_in), d_ff, dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(k3, (d_in, d_ff), d_in, dtype, device)
    return p


def apply_mlp(cfg: ArchConfig, p, x):
    """The MLP.  Under ``sharding.tensor_parallel`` its leaves are split as
    the reference's ``param_specs`` split them: the first rule that
    matches a dense ``ffn/w_in`` / ``w_gate`` is the MoE experts' (expert,
    embed, None), so they split by d_model rows, and ``w_out`` by d_ff
    rows.  A rank's block of x's d_model columns times its rows of
    ``w_in`` is a partial of the hidden layer, summed over the axis into
    its d_ff block (``sum_scatter``); its block times its ``w_out`` rows is
    a partial of the output, summed over the axis.  A leaf left whole (a
    dim the axis does not divide) runs whole on every rank."""
    ax = S.model_axis()
    rows_in = ax is not None and p["w_in"].shape[0] != x.shape[-1]
    rows_out = ax is not None and p["w_out"].shape[0] != p["w_in"].shape[1]
    if rows_in:
        x = S.take_block(x, -1, ax)
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    if rows_in:  # partials of the whole hidden layer
        def total(t):
            return S.sum_scatter(t, -1, ax) if rows_out else S.reduce_from_model(t, ax)
        h = total(h)
        g = None if g is None else total(g)
    elif rows_out:  # the whole hidden layer on every rank: take this rank's block
        h = S.take_block(h, -1, ax)
        g = None if g is None else S.take_block(g, -1, ax)
    h = act_fn(cfg.act, g) * h if g is not None else act_fn(cfg.act, h)
    out = h @ p["w_out"]
    return S.reduce_from_model(out, ax) if rows_out else out


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device="cpu") -> torch.Tensor:
    half = d_head // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq).  Rotates the
    split halves (x1, x2) of the head dimension, not interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ArchConfig, gen, dtype, device="cpu"):
    k1, k2 = split_keys(gen, 2)
    p = {"tok": embed_init(k1, (cfg.vocab, cfg.d_model), dtype, device)}
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(k2, (cfg.frontend.dim, cfg.d_model),
                                        cfg.frontend.dim, dtype, device)
    return p


def embed_tokens(p, tokens: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """The rows of ``tokens``.  Under ``sharding.tensor_parallel`` with the
    table split by vocab (``vocab`` the whole table's rows), each rank looks
    up the ids in its block and zeros the rest, and the sum over the model
    axis puts every row back: one nonzero among zeros, the same bits."""
    ax = S.model_axis()
    tok = p["tok"]
    if ax is None or vocab is None or tok.shape[0] == vocab:
        return tok[tokens]
    v0 = ax.index * tok.shape[0]
    local = tokens - v0
    inside = (local >= 0) & (local < tok.shape[0])
    rows = tok[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return S.reduce_from_model(rows, ax)


def init_head(cfg: ArchConfig, gen, dtype, device="cpu"):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, dtype, device)}


def head_split(cfg: ArchConfig, head_p, embed_p) -> bool:
    """Whether the head's vocab is split over the running model axis."""
    w = embed_p["tok"].shape[0] if cfg.tie_embeddings else head_p["w"].shape[1]
    return S.model_axis() is not None and w != cfg.vocab


def apply_head(cfg: ArchConfig, head_p, embed_p, x) -> torch.Tensor:
    """Logits; with the vocab split over the model axis (``head_split``),
    this rank's block of them (the ``vocab / model`` columns from
    ``index * vocab / model``)."""
    if head_split(cfg, head_p, embed_p):
        x = S.copy_to_model(x, S.model_axis())
    if cfg.tie_embeddings:
        return x @ embed_p["tok"].T
    return x @ head_p["w"]
