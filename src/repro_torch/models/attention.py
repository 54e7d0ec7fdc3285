"""Attention: GQA/MQA/MHA with RoPE, optional QKV bias, sliding window,
prefix-LM and bidirectional masks, chunked online-softmax for long context,
the SWA kernel path, KV-cache decode (ring buffer for sliding-window
layers), and MLA (multi-head latent attention, deepseek-v3) with
absorbed-matrix decode.  Port of ``repro/models/attention.py``.

Shapes: x (B, S, D); q (B, S, H, dh); k/v (B, S, G, dh) with G = n_kv_heads.

Under ``sharding.tensor_parallel`` a rank holds the heads of its block
of ``wq`` (and ``bq``, ``wo``), H / model of them from ``index * H /
model``, and attention runs over them alone: ``wq``, ``wk``, ``wv`` and
their biases column-parallel, ``wo`` row-parallel and its partial
outputs summed over the model axis.  Where the KV heads stay whole (G not
divisible by the axis, as the reference's specs leave them), every rank
computes all G groups (their gradients summed over the axis) and its
q heads read the groups they belong to by their global index, ``h //
(H / G)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.models import sharding as S
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import apply_rope, dense_init, split_keys


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, gen, dtype, device="cpu"):
    d, h, g, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    ks = split_keys(gen, 4)
    p = {
        "wq": dense_init(ks[0], (d, h, dh), d, dtype, device),
        "wk": dense_init(ks[1], (d, g, dh), d, dtype, device),
        "wv": dense_init(ks[2], (d, g, dh), d, dtype, device),
        "wo": dense_init(ks[3], (h, dh, d), h * dh, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((g, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((g, dh), dtype=dtype, device=device)
    return p


def _heads_axis(cfg: ArchConfig, p):
    """The running model axis when this attention's heads are split over
    it, else None."""
    ax = S.model_axis()
    return ax if ax is not None and p["wq"].shape[1] != cfg.n_heads else None


def _kv_whole(cfg: ArchConfig, p) -> bool:
    return p["wk"].shape[1] == cfg.n_kv_heads


def _qkv(cfg: ArchConfig, p, x, positions):
    ax = _heads_axis(cfg, p)
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    if ax is not None:
        x = S.copy_to_model(x, ax)
        if _kv_whole(cfg, p):  # every rank uses part of the whole KV weights
            wk, wv = S.copy_to_model(wk, ax), S.copy_to_model(wv, ax)
            if bk is not None:
                bk, bv = S.copy_to_model(bk, ax), S.copy_to_model(bv, ax)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, wk)
    v = torch.einsum("bsd,dgk->bsgk", x, wv)
    if "bq" in p:
        q = q + p["bq"]
        k = k + bk
        v = v + bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_groups(cfg: ArchConfig, p, k, v):
    """k, v (B, S, G', dh) cut to the groups this rank's q heads read, in
    the GQA layout (consecutive q heads a group): with the heads split and
    the KV heads whole, local head i (global ``h0 + i``) reads group ``(h0
    + i) // (H / G)``; otherwise k, v as they are."""
    ax = _heads_axis(cfg, p)
    if ax is None or not _kv_whole(cfg, p):
        return k, v
    h_loc = p["wq"].shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    h0 = ax.index * h_loc
    if h0 % rep == 0 and h_loc % rep == 0:  # whole groups
        sel = slice(h0 // rep, (h0 + h_loc) // rep)
        return k[:, :, sel], v[:, :, sel]
    if h0 // rep == (h0 + h_loc - 1) // rep:  # part of one group
        sel = slice(h0 // rep, h0 // rep + 1)
        return k[:, :, sel], v[:, :, sel]
    idx = torch.div(torch.arange(h0, h0 + h_loc, device=k.device), rep,
                    rounding_mode="floor")  # a group a head
    return k[:, :, idx], v[:, :, idx]


def _out_proj(cfg: ArchConfig, p, out):
    """The output projection; with the heads split, the ranks' partial
    outputs summed over the model axis."""
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    ax = _heads_axis(cfg, p)
    return y if ax is None else S.reduce_from_model(y, ax)


def _mask(
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    *,
    causal: bool,
    window: Optional[int],
    prefix_len: Optional[int],
) -> torch.Tensor:
    """(Sq, Sk) boolean 'allowed' mask."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    if causal:
        allowed = kp <= qp
        if prefix_len is not None:
            allowed = allowed | (kp < prefix_len)
    else:
        allowed = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                             device=q_pos.device)
    if window is not None:
        allowed = allowed & (kp > qp - window)
    return allowed


def _softcap(cfg: ArchConfig, scores):
    if cfg.logit_softcap > 0:
        return cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    return scores


def _sdpa(cfg, q, k, v, mask):
    """Dense softmax(QK^T)V with GQA head grouping.  q (B,Sq,H,dh),
    k/v (B,Sk,G,dh), mask (Sq,Sk) or (B,Sq,Sk).  The scores' einsum runs in
    the input dtype and is then upcast; the probabilities go back to v's
    dtype for the second einsum, as in the reference."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    q = q.reshape(b, sq, g, h // g, dh)
    scores = torch.einsum("bsgrk,btgk->bgrst", q, k).float() / math.sqrt(dh)
    scores = _softcap(cfg, scores)
    m = mask if mask.dim() == 3 else mask[None]
    scores = torch.where(m[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgk->bsgrk", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _sdpa_chunked(cfg, q, k, v, q_pos, k_pos, *, causal, window, prefix_len):
    """Online-softmax attention looping over KV chunks: O(Sq * chunk) live
    memory instead of O(Sq * Sk)."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    chunk = min(cfg.attn_chunk, k.shape[1])
    if k.shape[1] % chunk:
        raise ValueError("seq must be divisible by attn_chunk")
    qg = q.reshape(b, sq, g, h // g, dh)
    m_run = torch.full((b, g, h // g, sq), -math.inf, device=q.device)
    l_run = torch.zeros((b, g, h // g, sq), device=q.device)
    acc = torch.zeros((b, g, h // g, sq, dh), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bsgrk,btgk->bgrst", qg, k_i).float() / math.sqrt(dh)
        s = _softcap(cfg, s)
        mask = _mask(q_pos, k_pos[c0:c0 + chunk], causal=causal, window=window,
                     prefix_len=prefix_len)
        s = torch.where(mask[None, None, None], s, -1e30)
        m_new = torch.maximum(m_run, s.amax(-1))
        scale = torch.exp(m_run - m_new)
        p_i = torch.exp(s - m_new[..., None])
        l_run = l_run * scale + p_i.sum(-1)
        acc = acc * scale[..., None] + torch.einsum("bgrst,btgk->bgrsk", p_i,
                                                    v_i.float())
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def _sdpa_banded(cfg, q, k, v, *, window: int):
    """Blocked local attention for causal sliding windows: each W-sized q
    block attends only to [previous block, own block].  Requires
    S % W == 0."""
    b, s, h, dh = q.shape
    g = k.shape[2]
    nb = s // window
    qb = q.reshape(b, nb, window, g, h // g, dh)
    kb = k.reshape(b, nb, window, g, dh)
    vb = v.reshape(b, nb, window, g, dh)
    zero = torch.zeros_like(kb[:, :1])
    k_prev = torch.cat([zero, kb[:, :-1]], dim=1)
    v_prev = torch.cat([zero, vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (B, nb, 2W, G, dh)
    v2 = torch.cat([v_prev, vb], dim=2)
    scores = torch.einsum("bnqgrk,bntgk->bngrqt", qb, k2).float() / math.sqrt(dh)
    qpos = torch.arange(window, device=q.device)[:, None]  # within-block q index
    tpos = torch.arange(2 * window, device=q.device)[None, :] - window  # relative kv
    allowed = (tpos <= qpos) & (tpos > qpos - window)
    first = torch.arange(nb, device=q.device) == 0  # block 0 has no previous block
    allowed = allowed[None] & ~(first[:, None, None] & (tpos < 0)[None])
    scores = torch.where(allowed[None, :, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngrqt,bntgk->bnqgrk", probs.to(v.dtype), v2)
    return out.reshape(b, s, h, dh)


def attention_seq(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,  # (S,)
    *,
    layer_window: Optional[int],
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill).  ``pallas_swa`` and ``banded``
    fall back to ``chunked``/``xla`` where their prerequisites are unmet
    (no window, S <= window, S % window != 0, a prefix or no causal mask),
    as the reference does."""
    q, k, v = _qkv(cfg, p, x, positions[None])
    k, v = _local_groups(cfg, p, k, v)
    s = x.shape[1]
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if s > 4096 else "xla"
    if impl in ("banded", "pallas_swa") and (
            layer_window is None or s % layer_window != 0 or s <= layer_window
            or prefix_len is not None or not cfg.causal):
        impl = "chunked" if s > 4096 else "xla"  # banded prerequisites unmet
    if impl == "pallas_swa":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "attn_impl='pallas_swa' has no backward pass (the reference's SWA "
                "kernel has no VJP): train with 'xla' or 'chunked'; a backward "
                "SWA kernel is ROADMAP Queue 2 item K2")
        out = swa_ops.swa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    window=layer_window, causal=cfg.causal)
    elif impl == "banded":
        out = _sdpa_banded(cfg, q, k, v, window=layer_window)
    elif impl == "chunked":
        out = _sdpa_chunked(
            cfg, q, k, v, positions, positions,
            causal=cfg.causal, window=layer_window, prefix_len=prefix_len)
    else:
        mask = _mask(positions, positions, causal=cfg.causal, window=layer_window,
                     prefix_len=prefix_len)
        out = _sdpa(cfg, q, k, v, mask)
    return _out_proj(cfg, p, out)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, L, G, dh)
    v: torch.Tensor  # (B, L, G, dh)
    pos: torch.Tensor  # (L,) absolute positions stored (-1 = empty)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                  device="cpu") -> KVCache:
    g, dh = cfg.n_kv_heads, cfg.d_head
    return KVCache(
        k=torch.zeros((batch, cache_len, g, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, cache_len, g, dh), dtype=dtype, device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    )


def prefill_kv_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, cache_len: int) -> KVCache:
    """Build a cache from prefill K/V.  If the sequence exceeds cache_len
    (sliding-window layers) keep the last cache_len entries, placed at their
    ring slots."""
    s = k.shape[1]
    if s <= cache_len:
        pad = cache_len - s
        kq = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vq = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(positions, (0, pad), value=-1)
        return KVCache(kq, vq, pos.to(torch.int32))
    k_tail, v_tail, p_tail = k[:, -cache_len:], v[:, -cache_len:], positions[-cache_len:]
    order = torch.argsort(p_tail % cache_len, stable=True)
    return KVCache(k_tail[:, order], v_tail[:, order], p_tail[order].to(torch.int32))


def attention_decode(
    cfg: ArchConfig,
    p,
    x_t: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    t: int,  # absolute position of the new token
    *,
    layer_window: Optional[int],
) -> tuple[torch.Tensor, KVCache]:
    """One-token attention against the cache.  Unlike the reference, which
    returns a new cache, this writes the new K/V and position into
    ``cache``'s tensors in place (no copy of the cache per token) and
    returns the same cache."""
    t = int(t)
    pos_t = torch.full((1, 1), t, dtype=torch.int64, device=x_t.device)
    q, k_new, v_new = _qkv(cfg, p, x_t, pos_t)
    cache_len = cache.k.shape[1]
    if layer_window is not None and cache_len < 2 ** 30:
        slot = t % cache_len  # ring buffer
    else:
        slot = min(t, cache_len - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    cache.pos[slot] = t
    k, v, pos = cache
    k, v = _local_groups(cfg, p, k, v)

    valid = pos >= 0
    if layer_window is not None:
        valid = valid & (pos > t - layer_window)
    valid = valid & (pos <= t)

    b, _, h, dh = q.shape
    g = k.shape[2]
    qg = q.reshape(b, 1, g, h // g, dh)
    scores = torch.einsum("bsgrk,btgk->bgrst", qg, k).float() / math.sqrt(dh)
    scores = _softcap(cfg, scores)
    scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgk->bsgrk", probs.to(v.dtype), v).reshape(b, 1, h, dh)
    return _out_proj(cfg, p, out), cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

def init_mla(cfg: ArchConfig, gen, dtype, device="cpu"):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    ks = split_keys(gen, 6)
    return {
        "wq_a": dense_init(ks[0], (d, m.q_lora_rank), d, dtype, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": dense_init(ks[1], (m.q_lora_rank, h, qk_dim), m.q_lora_rank, dtype, device),
        "wkv_a": dense_init(ks[2], (d, r + m.qk_rope_head_dim), d, dtype, device),
        "kv_norm": torch.ones((r,), dtype=dtype, device=device),
        "wk_b": dense_init(ks[3], (r, h, m.qk_nope_head_dim), r, dtype, device),
        "wv_b": dense_init(ks[4], (r, h, m.v_head_dim), r, dtype, device),
        "wo": dense_init(ks[5], (h, m.v_head_dim, d), h * m.v_head_dim, dtype, device),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _mla_scale(cfg: ArchConfig) -> float:
    """1 / sqrt(qk head dim), computed in fp32 as the reference does."""
    m = cfg.mla
    return float(np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_head_dim
                                                      + m.qk_rope_head_dim)))


def _mla_qkr(cfg: ArchConfig, p, x, positions):
    """Shared q / latent projections.  Returns per-head q (nope, rope) and
    the latent stream (c_kv, k_rope)."""
    m = cfg.mla
    cq = _rms(x @ p["wq_a"], p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)

    kv = x @ p["wkv_a"]
    c_kv = _rms(kv[..., :m.kv_lora_rank], p["kv_norm"])  # (B,S,R)
    k_rope = kv[..., m.kv_lora_rank:]  # (B,S,rope_dim), shared across heads
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scores(q_nope, q_rope, k_nope, k_rope, scale: float):
    """(B, H, Sq, Sk) fp32 scores: the two einsums summed in their own dtype,
    then upcast and scaled, as in the reference."""
    return (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
            + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float() * scale


def mla_seq(cfg: ArchConfig, p, x, positions, *, prefix_len=None) -> torch.Tensor:
    """Prefill/train MLA: decompress K/V per head (naive form); the chunked
    online softmax when S > 4096 and S divides into ``attn_chunk``."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(cfg, p, x, positions[None])
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    val = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
    scale = _mla_scale(cfg)

    s = x.shape[1]
    chunk = min(cfg.attn_chunk, s)
    if s > 4096 and s % chunk == 0:
        out = _mla_chunked(cfg, q_nope, q_rope, k_nope, k_rope, val, positions, scale,
                           prefix_len)
    else:
        mask = _mask(positions, positions, causal=cfg.causal, window=None,
                     prefix_len=prefix_len)
        scores = _mla_scores(q_nope, q_rope, k_nope, k_rope, scale)
        scores = torch.where(mask[None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthk->bshk", probs.to(val.dtype), val)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_chunked(cfg, q_nope, q_rope, k_nope, k_rope, val, positions, scale, prefix_len):
    """Online softmax over KV chunks of ``attn_chunk`` keys."""
    b, s, h, _ = q_nope.shape
    dv = val.shape[-1]
    chunk = min(cfg.attn_chunk, s)
    dev = q_nope.device
    m_run = torch.full((b, h, s), -math.inf, device=dev)
    l_run = torch.zeros((b, h, s), device=dev)
    acc = torch.zeros((b, h, s, dv), device=dev)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        sc = _mla_scores(q_nope, q_rope, k_nope[:, sl], k_rope[:, sl], scale)
        mask = _mask(positions, positions[sl], causal=cfg.causal, window=None,
                     prefix_len=prefix_len)
        sc = torch.where(mask[None, None], sc, -1e30)
        m_new = torch.maximum(m_run, sc.amax(-1))
        alpha = torch.exp(m_run - m_new)
        pr = torch.exp(sc - m_new[..., None])
        del sc
        l_run = l_run * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhst,bthk->bhsk", pr,
                                                    val[:, sl].float())
        m_run = m_new
    out = (acc / torch.clamp(l_run, min=1e-30)[..., None]).transpose(1, 2)
    return out.to(q_nope.dtype)


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, L, R) compressed latent
    k_rope: torch.Tensor  # (B, L, rope_dim)
    pos: torch.Tensor  # (L,)


def init_mla_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                   device="cpu") -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, cache_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    )


def mla_decode(cfg: ArchConfig, p, x_t, cache: MLACache, t: int
               ) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-matrix MLA decode: attention runs in the latent space, FLOPs
    per token O(H * R * S) instead of decompressing the whole cache.  The
    new latent goes to slot ``min(t, L - 1)`` (a clamp, not a ring: past
    the cache's end the last slot is overwritten) and every stored
    position ``<= t`` is attended, as in the reference.  The cache is
    written in place and returned."""
    t = int(t)
    pos_t = torch.full((1, 1), t, dtype=torch.int64, device=x_t.device)
    q_nope, q_rope, c_new, r_new = _mla_qkr(cfg, p, x_t, pos_t)
    slot = min(t, cache.c_kv.shape[1] - 1)
    cache.c_kv[:, slot] = c_new[:, 0]
    cache.k_rope[:, slot] = r_new[:, 0]
    cache.pos[slot] = t
    c_kv, k_rope, pos = cache

    # absorb wk_b into q: q_abs (B,1,H,R)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
    scores = (torch.einsum("bshr,btr->bhst", q_abs, c_kv)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float() * _mla_scale(cfg)
    valid = (pos >= 0) & (pos <= t)
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs.to(c_kv.dtype), c_kv)  # latent ctx
    out = torch.einsum("bshr,rhk->bshk", ctx, p["wv_b"])  # absorb wv_b
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
