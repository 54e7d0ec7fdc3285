"""State-space blocks: the Mamba-style selective SSM of hymba's parallel SSM
heads (arXiv:2411.13676), port of the Mamba half of
``repro/models/ssm.py``.  The sequence form runs the selective-scan kernel
(``kernels/scan``) where the reference runs an associative scan over time;
the decode form is the O(1) recurrent step on the carried (conv, ssm) state.

The xLSTM half of the reference module (mLSTM, sLSTM) is ROADMAP Queue 1
item 15 and not ported yet.

Op order and dtypes follow the reference, so that a bf16 model rounds where
it does: the depthwise conv is a per-tap sum, SiLU is ``x * (1 / (1 +
exp(-x)))`` and softplus ``logaddexp(x, 0)``, op by op; ``dt`` is two
products with a rounding between, and ``dt * x`` is rounded to the model's
dtype before the scan widens it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import dense_init, split_keys


def init_mamba(cfg: ArchConfig, gen, dtype, device="cpu"):
    """The reference's ``init_mamba``: ``split(key, 7)`` for the seven
    products (with a Generator, drawn in that order), ``a_log = log(1..n)``
    on every channel and ``d_skip = 1``.  (XLA's fp32 ``log(7)`` on the CPU
    is one ulp above the correctly rounded value that torch gives; bf16
    rounds both to the same value.)"""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    ks = split_keys(gen, 7)
    dt_rank = max(d // 16, 1)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "w_in": dense_init(ks[0], (d, di), d, dtype, device),
        "w_gate": dense_init(ks[1], (d, di), d, dtype, device),
        "conv": dense_init(ks[2], (cfg.ssm_conv, di), cfg.ssm_conv, dtype, device),
        "w_bc": dense_init(ks[3], (di, 2 * n), di, dtype, device),
        "w_dt1": dense_init(ks[4], (di, dt_rank), di, dtype, device),
        "w_dt2": dense_init(ks[5], (dt_rank, di), dt_rank, dtype, device),
        "a_log": a_log.tile(di, 1).to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "w_out": dense_init(ks[6], (di, d), di, dtype, device),
    }


def _silu(x):
    """``jax.nn.silu``: x * sigmoid(x), with sigmoid as XLA expands it, 1 /
    (1 + exp(-x)); each op in x's dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, op by op in x's dtype."""
    return torch.where(torch.isnan(x), x, torch.clamp_min(x, 0)
                       + torch.log1p(torch.exp(-x.abs())))


def _mamba_inner(p, u, conv_state=None):
    """Shared pieces: conv + dt/B/C projections.  u (B,S,di) -> (x, b, c,
    dt, the new conv window)."""
    kw = p["conv"].shape[0]
    if conv_state is None:
        pad = F.pad(u, (0, 0, kw - 1, 0))
    else:
        pad = torch.cat([conv_state, u], dim=1)
    # depthwise causal conv1d, tap by tap as the reference rounds it
    x = sum(pad[:, i:i + u.shape[1], :] * p["conv"][i] for i in range(kw))
    x = _silu(x)
    bc = x @ p["w_bc"]
    n = bc.shape[-1] // 2
    b_t, c_t = bc[..., :n], bc[..., n:]
    dt = _softplus((x @ p["w_dt1"]) @ p["w_dt2"])  # (B,S,di)
    new_conv_state = pad[:, -(kw - 1):, :] if kw > 1 else pad[:, :0, :]
    return x, b_t, c_t, dt, new_conv_state


def mamba_seq(cfg: ArchConfig, p, x_in: torch.Tensor) -> torch.Tensor:
    """x_in (B,S,D) -> (B,S,D).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t + D x_t
    """
    u = x_in @ p["w_in"]
    z = _silu(x_in @ p["w_gate"])
    x, b_t, c_t, dt, _ = _mamba_inner(p, u)
    y = scan_ops.selective_scan(x, dt, b_t.contiguous(), c_t.contiguous(),
                                p["a_log"].contiguous())
    y = y.to(x.dtype) + p["d_skip"] * x
    return (y * z) @ p["w_out"]


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, kw-1, di)
    ssm: torch.Tensor  # (B, di, n) fp32


def init_mamba_cache(cfg: ArchConfig, batch: int, d_inner: int, dtype,
                     device="cpu") -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_inner, cfg.ssm_state), dtype=torch.float32,
                        device=device),
    )


def mamba_decode(cfg: ArchConfig, p, x_t: torch.Tensor, cache: MambaCache
                 ) -> tuple[torch.Tensor, MambaCache]:
    """Single-token recurrent step, x_t (B,1,D).  Unlike the reference,
    which returns a new cache, this writes the new conv window and SSM
    state into ``cache``'s tensors in place (both computed from the old
    ones first) and returns the same cache."""
    u = x_t @ p["w_in"]
    z = _silu(x_t @ p["w_gate"])
    x, b_t, c_t, dt, conv_new = _mamba_inner(p, u, conv_state=cache.conv)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt[:, 0, :, None].float() * a)  # (B,di,n)
    inp = (dt[:, 0] * x[:, 0])[..., None].float() * b_t[:, 0, None, :].float()
    h = decay * cache.ssm + inp
    y = torch.einsum("bdn,bn->bd", h, c_t[:, 0].float())[:, None]
    y = y.to(x.dtype) + p["d_skip"] * x
    out = (y * z) @ p["w_out"]
    cache.conv.copy_(conv_new)  # conv_new is a slice of a new tensor
    cache.ssm.copy_(h)
    return out, cache
