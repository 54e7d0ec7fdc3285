"""State-space and recurrent blocks (port of ``repro/models/ssm.py``).

* The Mamba-style selective SSM of hymba's parallel SSM heads
  (arXiv:2411.13676).  The sequence form runs the selective-scan kernel
  (``kernels/scan``) where the reference runs an associative scan over time;
  the decode form is the O(1) recurrent step on the carried (conv, ssm)
  state.
* xLSTM (arXiv:2405.04517), xlstm-125m's blocks:
    - mLSTM: a (dh x dh) matrix memory per head with exponential gating.  The
      sequence form is the reference's chunkwise-parallel one (intra-chunk
      "linear attention with decay", inter-chunk recurrence on the chunk
      states), a Python loop over chunks in plain PyTorch; decode is the
      plain recurrence.
    - sLSTM: scalar memory with recurrent per-head weights, sequential by
      nature.  The input projection of every step is one product; the time
      loop runs the sLSTM kernel (``kernels/slstm``), in the sequence form
      and in decode (one step) alike; under autograd the sequence form goes
      through the kernel's Function (its saving forward, then its backward
      kernel), the same arithmetic.

Op order and dtypes follow the reference, so that a bf16 model rounds where
it does: the depthwise conv is a per-tap sum, SiLU is ``x * (1 / (1 +
exp(-x)))``, softplus ``logaddexp(x, 0)`` and the tanh GELU jax's formula,
op by op; ``dt`` is two products with a rounding between, and ``dt * x`` is
rounded to the model's dtype before the scan widens it; ``k`` is divided by
``sqrt(dh)`` rounded to the model's dtype.  Every recurrence keeps fp32
states with log-space stabilizers for the exponential gates.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import dense_init, is_key, split_keys


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


def _gelu(x):
    """``jax.nn.gelu`` (tanh form) as jax writes it, op by op in x's dtype:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``, c = sqrt(2/pi)
    in x's dtype, ``x**3`` as ``x * (x * x)``."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


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


# ===========================================================================
# xLSTM: mLSTM
# ===========================================================================

def init_mlstm(cfg: ArchConfig, gen, dtype, device="cpu"):
    """The reference's ``init_mlstm``: ``split(key, 7)`` for the seven
    products (with a Generator, drawn in that order); ``b_if`` is zeros
    (input gates) then 3.0 (forget gates), ``gn_scale`` ones."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.n_heads
    ks = split_keys(gen, 7)
    return {
        "w_up": dense_init(ks[0], (d, di), d, dtype, device),
        "w_gate": dense_init(ks[1], (d, di), d, dtype, device),
        "wq": dense_init(ks[2], (di, di), di, dtype, device),
        "wk": dense_init(ks[3], (di, di), di, dtype, device),
        "wv": dense_init(ks[4], (di, di), di, dtype, device),
        "w_if": dense_init(ks[5], (di, 2 * h), di, dtype, device),  # input & forget pre-acts
        "b_if": torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 3.0, device=device)]).to(dtype),
        "gn_scale": torch.ones((di,), dtype=dtype, device=device),
        "w_down": dense_init(ks[6], (di, d), di, dtype, device),
    }


def _mlstm_gates(p, x, h):
    """log input/forget gates, fp32.  x (B,S,di) -> (B,S,H) each."""
    pre = x @ p["w_if"] + p["b_if"]
    i_pre, f_pre = pre[..., :h], pre[..., h:]
    log_f = -_softplus(-f_pre.float())  # log sigmoid(f)
    log_i = i_pre.float()  # exponential input gate: log i = i_pre
    return log_i, log_f


def _headify(x, h):
    b, s, di = x.shape
    return x.reshape(b, s, h, di // h)


def _group_norm_heads(x, scale):
    """Per-head RMS norm, then the heads flattened and scaled: (B,S,H,dh)
    -> (B,S,H dh) fp32."""
    b, s, h, dh = x.shape
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return y.reshape(b, s, h * dh) * scale.float()


def _inv_sqrt_divisor(dh: int, dtype, device) -> torch.Tensor:
    """``jnp.sqrt(dh)`` (fp32) rounded to the model's dtype, as jax casts a
    weakly typed scalar to the array's dtype before dividing."""
    return torch.tensor(math.sqrt(dh), dtype=torch.float32, device=device).to(dtype)


def _mlstm_qkv(cfg: ArchConfig, p, x_in):
    """The projections: x (B,S,di), z = silu(gate), q, k / sqrt(dh), v
    (B,S,H,dh) and the log gates (B,S,H)."""
    h = cfg.n_heads
    x = x_in @ p["w_up"]
    z = _silu(x_in @ p["w_gate"])
    dh = x.shape[-1] // h
    q = _headify(x @ p["wq"], h)
    k = _headify(x @ p["wk"], h) / _inv_sqrt_divisor(dh, x.dtype, x.device)
    v = _headify(x @ p["wv"], h)
    log_i, log_f = _mlstm_gates(p, x, h)
    return x, z, q, k, v, log_i, log_f


def mlstm_seq(cfg: ArchConfig, p, x_in: torch.Tensor) -> torch.Tensor:
    """Chunkwise-parallel mLSTM, x_in (B,S,D) -> (B,S,D): the reference's
    ``lax.scan`` over chunks as a Python loop, the same ops in the same
    order."""
    h = cfg.n_heads
    x, z, q, k, v, log_i, log_f = _mlstm_qkv(cfg, p, x_in)
    b, s, di = x.shape
    dh = di // h
    chunk = min(cfg.mlstm_chunk, s)
    if chunk == 0 or s % chunk != 0:
        raise ValueError(f"mlstm_seq: the sequence length {s} must be divisible by "
                         f"mlstm_chunk {cfg.mlstm_chunk}")
    dev = x.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    neg_inf = torch.tensor(-math.inf, device=dev)
    c_state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    n_state = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
    m_state = torch.full((b, h), -1e30, dtype=torch.float32, device=dev)
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        li, lf = log_i[:, sl], log_f[:, sl]  # (B,chunk,H)
        csum_f = torch.cumsum(lf, dim=1)  # inclusive
        total_f = csum_f[:, -1]  # (B,H)
        lt = csum_f.transpose(1, 2)  # (B,H,chunk)
        lis = li.transpose(1, 2)
        # intra-chunk: state_t = sum_{s<=t} exp(csum_f[t]-csum_f[s]+li[s]) v_s k_s^T
        log_d = lt[..., :, None] - lt[..., None, :] + lis[..., None, :]
        log_d = torch.where(tri, log_d, neg_inf)
        # incoming chunk-carry state weight at step t: exp(csum_f[t] + m_state)
        log_in = lt + m_state[:, :, None]  # (B,H,chunk)
        m_new = torch.maximum(log_d.amax(-1), log_in)
        dmat = torch.exp(log_d - m_new[..., None])
        qh = q[:, sl].transpose(1, 2).float()  # (B,H,chunk,dh)
        kh = k[:, sl].transpose(1, 2).float()
        vh = v[:, sl].transpose(1, 2).float()
        scores = torch.einsum("bhtk,bhsk->bhts", qh, kh) * dmat
        inter_scale = torch.exp(log_in - m_new)  # (B,H,chunk)
        num = (torch.einsum("bhts,bhsv->bhtv", scores, vh)
               + torch.einsum("bhtk,bhkv->bhtv", qh, c_state) * inter_scale[..., None])
        n_vec = (torch.einsum("bhts,bhsk->bhtk", dmat, kh)
                 + n_state[:, :, None, :] * inter_scale[..., None])
        den = torch.einsum("bhtk,bhtk->bht", qh, n_vec).abs()
        out = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        # chunk-state update
        log_ws = (total_f[:, None] - csum_f + li).transpose(1, 2)  # (B,H,chunk)
        log_carry = total_f + m_state  # (B,H)
        m_end = torch.maximum(log_ws.amax(-1), log_carry)
        ws = torch.exp(log_ws - m_end[..., None])
        carry_scale = torch.exp(log_carry - m_end)
        c_state = (carry_scale[..., None, None] * c_state
                   + torch.einsum("bhs,bhsk,bhsv->bhkv", ws, kh, vh))
        n_state = carry_scale[..., None] * n_state + torch.einsum("bhs,bhsk->bhk", ws, kh)
        m_state = m_end
        outs.append(out.transpose(1, 2))  # (B,chunk,H,dh)
    y = torch.cat(outs, 1)
    y = _group_norm_heads(y, p["gn_scale"]).to(x.dtype)
    return (y * z) @ p["w_down"]


class MLSTMCache(NamedTuple):
    c: torch.Tensor  # (B,H,dh,dh) fp32
    n: torch.Tensor  # (B,H,dh) fp32
    m: torch.Tensor  # (B,H) fp32 stabilizer


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device="cpu") -> MLSTMCache:
    h = cfg.n_heads
    dh = cfg.ssm_expand * cfg.d_model // h
    return MLSTMCache(
        c=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    )


def mlstm_decode(cfg: ArchConfig, p, x_t: torch.Tensor, cache: MLSTMCache
                 ) -> tuple[torch.Tensor, MLSTMCache]:
    """Single-token recurrent step, x_t (B,1,D); the new (c, n, m) are
    written into ``cache``'s tensors in place (computed from the old ones
    first) and the same cache is returned."""
    h = cfg.n_heads
    x, z, q, k, v, log_i, log_f = _mlstm_qkv(cfg, p, x_t)
    b = x.shape[0]
    dh = x.shape[-1] // h
    q, k, v = (t.reshape(b, h, dh).float() for t in (q, k, v))
    li, lf = log_i[:, 0], log_f[:, 0]  # (B,H)
    m_new = torch.maximum(lf + cache.m, li)
    f_s = torch.exp(lf + cache.m - m_new)[..., None]
    i_s = torch.exp(li - m_new)[..., None]
    c_new = f_s[..., None] * cache.c + i_s[..., None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n_new = f_s * cache.n + i_s * k
    num = torch.einsum("bhk,bhkv->bhv", q, c_new)
    den = torch.einsum("bhk,bhk->bh", q, n_new).abs()
    out = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    y = _group_norm_heads(out[:, None], p["gn_scale"]).to(x.dtype)  # (B,1,di)
    cache.c.copy_(c_new)
    cache.n.copy_(n_new)
    cache.m.copy_(m_new)
    return (y * z) @ p["w_down"], cache


# ===========================================================================
# xLSTM: sLSTM
# ===========================================================================

def init_slstm(cfg: ArchConfig, gen, dtype, device="cpu"):
    """The reference's ``init_slstm``: ``split(key, 4)``, and ``w_down``
    from ``fold_in(ks[3], 7)`` (with a Generator, drawn after the rest).
    Four gates (i, f, z, o): input weights (d, 4, H, dh) and per-head
    recurrent weights (4, H, dh, dh)."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = (4 * d) // 3
    ks = split_keys(gen, 4)
    k_down = prng.fold_in(ks[3], 7) if is_key(ks[3]) else ks[3]
    return {
        "w_gates": dense_init(ks[0], (d, 4, h, dh), d, dtype, device),
        "r_gates": dense_init(ks[1], (4, h, dh, dh), dh, dtype, device),
        "b_gates": torch.zeros((4, h, dh), dtype=dtype, device=device),
        "gn_scale": torch.ones((d,), dtype=dtype, device=device),
        "w_up": dense_init(ks[2], (d, ff), d, dtype, device),
        "w_gate": dense_init(ks[3], (d, ff), d, dtype, device),
        "w_down": dense_init(k_down, (ff, d), ff, dtype, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B,H,dh)
    n: torch.Tensor  # (B,H,dh)
    h: torch.Tensor  # (B,H,dh)
    m: torch.Tensor  # (B,H,dh) stabilizer


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device="cpu") -> SLSTMState:
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    def zeros():
        return torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, h, dh), -1e30, dtype=torch.float32,
                                   device=device))


def _slstm_out(cfg: ArchConfig, p, y, dtype):
    """The per-head norm and the gated FFN after the recurrence (proj factor
    4/3, the xLSTM block structure): y (B,S,D) fp32 -> (B,S,D)."""
    b, s, d = y.shape
    yn = _group_norm_heads(y.reshape(b, s, cfg.n_heads, d // cfg.n_heads),
                           p["gn_scale"]).to(dtype)
    up = yn @ p["w_up"]
    gate = _gelu(yn @ p["w_gate"])
    return (up * gate) @ p["w_down"]


def slstm_seq(cfg: ArchConfig, p, x_in: torch.Tensor) -> torch.Tensor:
    """x_in (B,S,D) -> (B,S,D): the input projections of all steps in one
    product, then the recurrence over time in the sLSTM kernel."""
    b, s, d = x_in.shape
    st0 = init_slstm_cache(cfg, b, x_in.dtype, x_in.device)
    pre_x = torch.einsum("bsd,dghk->bsghk", x_in, p["w_gates"])
    hs, _ = slstm_ops.slstm_scan(pre_x.contiguous(), p["r_gates"].contiguous(),
                                 p["b_gates"].contiguous(), tuple(st0))
    return _slstm_out(cfg, p, hs.reshape(b, s, d), x_in.dtype)


def slstm_decode(cfg: ArchConfig, p, x_t: torch.Tensor, st: SLSTMState
                 ) -> tuple[torch.Tensor, SLSTMState]:
    """Single-token step, x_t (B,1,D): the sLSTM kernel over one step (its
    plain version on the CPU); the new state is written into ``st``'s
    tensors in place and the same state is returned."""
    b, _, d = x_t.shape
    pre_x = torch.einsum("bd,dghk->bghk", x_t[:, 0], p["w_gates"])[:, None]
    hs, new = slstm_ops.slstm_scan(pre_x.contiguous(), p["r_gates"].contiguous(),
                                   p["b_gates"].contiguous(), tuple(st))
    for old, t in zip(st, new):
        old.copy_(t)
    return _slstm_out(cfg, p, hs.reshape(b, 1, d), x_t.dtype), st
