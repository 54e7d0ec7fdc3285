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
    return (draw_normal(gen, shape, device) * scale).to(dtype)


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
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act_fn(cfg.act, x @ p["w_gate"]) * h
    else:
        h = act_fn(cfg.act, h)
    return h @ p["w_out"]


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


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def init_head(cfg: ArchConfig, gen, dtype, device="cpu"):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, dtype, device)}


def apply_head(cfg: ArchConfig, head_p, embed_p, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ embed_p["tok"].T
    return x @ head_p["w"]
