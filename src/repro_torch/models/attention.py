"""Attention: GQA/MQA/MHA with RoPE, optional QKV bias, sliding window,
prefix-LM and bidirectional masks, chunked online-softmax for long context,
the SWA kernel path, and KV-cache decode (ring buffer for sliding-window
layers).  Port of ``repro/models/attention.py`` without MLA (ROADMAP
Queue 1 item 12).

Shapes: x (B, S, D); q (B, S, H, dh); k/v (B, S, G, dh) with G = n_kv_heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.swa import ops as swa_ops
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


def _qkv(cfg: ArchConfig, p, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    s = x.shape[1]
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if s > 4096 else "xla"
    if impl in ("banded", "pallas_swa") and (
            layer_window is None or s % layer_window != 0 or s <= layer_window
            or prefix_len is not None or not cfg.causal):
        impl = "chunked" if s > 4096 else "xla"  # banded prerequisites unmet
    if impl == "pallas_swa":
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
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


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
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
