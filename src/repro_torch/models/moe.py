"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Implementations, by ``cfg.moe.impl``:

* ``scatter`` — grouped scatter/gather dispatch: the tokens split into G
  groups, each scattering its tokens into its own (E, Cg, d) expert buffer
  at their queue slots, the experts as one batched product, the outputs
  gathered back and combined;
* ``dispatch`` (any impl not named here) — GShard's one-hot dispatch and
  combine einsums;
* ``dense`` — every expert on every token, then weighted-combined: the
  smoke configurations' and the tests' oracle;
* ``shard_map`` — the reference's expert-parallel form over the mesh's
  ``model`` axis (ROADMAP Queue 1 item 19b).  Without a model axis the
  reference falls through to ``scatter``, and so does the port; over a
  ``model`` axis of more than one rank the port raises.

Router: softmax over the expert logits in fp32 (the router weight is fp32
whatever the model's dtype), top-k, the selected probabilities
renormalised (deepseek / granite style), and the Switch load-balancing
auxiliary loss.

Where an implementation in another framework could part from the
reference, the port keeps the reference's numbers:

* top-k ties: ``jax.lax.top_k`` puts the lower index first;
  ``torch.topk`` promises no order among equal values, so the port takes
  the first k of a stable descending sort (``_top_k``);
* capacity: a (token, k) pair's slot is its place in its expert's queue,
  a cumulative sum over the pairs flattened token-major, within a group;
  pairs at or past the capacity drop, to the overflow slot ``cap``, whose
  row is discarded (``_queue_slots``);
* determinism: the scatter is one ``index_put``; every kept slot is
  written once, by its own pair (the reference adds it into zeros: the
  same value), and only the discarded overflow slot takes several, so
  the buffer is the same from run to run on the card.  The combine puts
  each filled slot's output back at its (token, k) pair the same way and
  adds k = 0..K-1 in order, in fp32.  Neither accumulates into an index:
  the gradients of both puts are gathers.  (An accumulating put, or a
  gather whose gradient accumulates, serializes on the card over the
  overflow slot, where most pairs land when a capacity drops many.)

The reference reads two ``REPRO_VARIANT`` knobs here: ``moe_groups`` (the
tokens a scatter group aims at, default 8192) and ``moe_bf16`` (bf16
combine accumulation, default off).  The port takes their defaults
(``MOE_GROUPS``, fp32 accumulation); the knobs come with ``variants.py``,
ROADMAP Queue 1 item 10.  The reference's sharding constraints only tell
XLA where to place activations and are dropped: the port's MoE runs on a
mesh in replica mode (model = 1) only, and a MoE block under a ``model``
axis of more than one rank raises (``blocks._check_known``, ROADMAP Queue 1
item 19b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as S
from repro_torch.models.common import ArchConfig, MoEConfig
from repro_torch.models.layers import act_fn, dense_init, split_keys

MOE_GROUPS = 8192  # tokens a scatter group aims at (the reference's default)


def init_moe(cfg: ArchConfig, gen, dtype, device="cpu"):
    m = cfg.moe
    d = cfg.d_model
    ks = split_keys(gen, 7)
    gated = cfg.act in ("swiglu", "geglu")
    p = {
        "router": dense_init(ks[0], (d, m.n_experts), d, torch.float32, device),
        "w_in": dense_init(ks[1], (m.n_experts, d, m.d_expert), d, dtype, device),
        "w_out": dense_init(ks[2], (m.n_experts, m.d_expert, d), m.d_expert, dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(ks[3], (m.n_experts, d, m.d_expert), d, dtype, device)
    if m.n_shared > 0:
        ds = m.n_shared * m.d_expert
        p["shared_in"] = dense_init(ks[4], (d, ds), d, dtype, device)
        p["shared_out"] = dense_init(ks[5], (ds, d), ds, dtype, device)
        if gated:
            p["shared_gate"] = dense_init(ks[6], (d, ds), d, dtype, device)
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values lower index first
    (``jax.lax.top_k``'s order)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def router_probs(m: MoEConfig, p, x) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (top-k combine weights (..., K) fp32, top-k indices, aux loss)."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, m.top_k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss: E * sum_e f_e * p_e  (Switch, eq. 4)
    e = m.n_experts
    me = probs.reshape(-1, e).mean(0)  # avg router prob per expert
    ce = F.one_hot(top_idx[..., 0], e).float().reshape(-1, e).mean(0)  # top-1 share
    aux = e * torch.sum(me * ce)
    return top_vals, top_idx, aux


def _expert_ffn(cfg: ArchConfig, p, x_e):
    """x_e: (E, C*, d) per-expert token slabs -> (E, C*, d)."""
    h = torch.bmm(x_e, p["w_in"])
    if "w_gate" in p:
        h = act_fn(cfg.act, torch.bmm(x_e, p["w_gate"])) * h
    else:
        h = act_fn(cfg.act, h)
    return torch.bmm(h, p["w_out"])


def _shared_ffn(cfg: ArchConfig, p, x):
    h = x @ p["shared_in"]
    if "shared_gate" in p:
        h = act_fn(cfg.act, x @ p["shared_gate"]) * h
    else:
        h = act_fn(cfg.act, h)
    return h @ p["shared_out"]


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_vals, top_idx, aux = router_probs(m, p, xt)
    if m.impl == "dense":
        # oracle: all experts on all tokens
        all_out = _expert_ffn(cfg, p, xt[None].expand(m.n_experts, b * s, d))
        combine = torch.zeros((b * s, m.n_experts), dtype=torch.float32,
                              device=x.device).scatter_add(1, top_idx, top_vals)
        out = torch.einsum("te,etd->td", combine.to(x.dtype), all_out)
    elif m.impl in ("scatter", "shard_map"):  # shard_map: no model axis, as scatter
        if S.model_axis() is not None:
            S.refuse("the expert-parallel MoE (impl='shard_map')")
        out = _scatter_moe(cfg, p, xt, top_vals, top_idx)
    else:
        out = _dispatch_moe(cfg, p, xt, top_vals, top_idx)
    if m.n_shared > 0:
        out = out + _shared_ffn(cfg, p, xt)
    return out.reshape(b, s, d), aux


def _dispatch_group_count(t: int, target: int = 8192) -> int:
    """Largest divisor of t not exceeding max(t // target, 1)."""
    want = max(t // target, 1)
    g = 1
    for cand in range(1, want + 1):
        if t % cand == 0:
            g = cand
    return g


def _capacity(t: int, m: MoEConfig) -> int:
    return max(int(t * m.top_k * m.capacity_factor / m.n_experts), 4)


def _queue_slots(idx: torch.Tensor, n_experts: int, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """idx (..., T, K) expert choices -> (slot, keep), each (..., T, K): a
    pair's place in its expert's queue (the pairs counted token-major, k
    within a token), kept below ``cap``; a dropped pair's slot is ``cap``."""
    onehot = F.one_hot(idx, n_experts)  # (..., T, K, E)
    # the experts' queues as rows, so that the running count is a scan
    # along the last axis (a scan across rows of only E columns runs E
    # threads on the card)
    flat = onehot.reshape(*idx.shape[:-2], -1, n_experts).transpose(-1, -2).contiguous()
    pos = (torch.cumsum(flat, dim=-1) - flat).transpose(-1, -2).reshape(onehot.shape)
    pos = (pos * onehot).sum(-1)
    keep = pos < cap
    return torch.where(keep, pos, cap), keep


def _scatter_moe(cfg: ArchConfig, p, xt, top_vals, top_idx):
    """Grouped scatter/gather expert dispatch: G groups of Tg tokens, each
    scattering into its own (E, Cg + 1, d) buffer with capacity Cg =
    Tg K cf / E (and the overflow slot Cg), the experts' FFN over every
    group's slabs at once, then each token's K outputs gathered back and
    combined in fp32."""
    m = cfg.moe
    t, d = xt.shape
    e, k_top = m.n_experts, m.top_k
    g = _dispatch_group_count(t, MOE_GROUPS)
    tg = t // g
    cap = _capacity(tg, m)

    xg = xt.reshape(g, tg, d)
    idxg = top_idx.reshape(g, tg, k_top)
    valg = top_vals.reshape(g, tg, k_top)
    slot, keep = _queue_slots(idxg, e, cap)  # (G, Tg, K)
    grp = torch.arange(g, device=xt.device)[:, None, None].expand(g, tg, k_top)

    # each kept pair writes its slot alone (the reference adds it into a
    # zero buffer: the same value); the dropped pairs all write the
    # overflow slot, which is cut off
    buf = torch.zeros((g, e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((grp, idxg, slot), xg[:, :, None].expand(g, tg, k_top, d))
    # the experts' slabs of every group as one batch: (E, G Cg, d)
    x_e = buf[:, :, :cap].transpose(0, 1).reshape(e, g * cap, d)
    y_e = _expert_ffn(cfg, p, x_e).reshape(e, g, cap, d).transpose(0, 1)

    # the combine: each filled slot's output put back at its (token, k)
    # pair, a dropped pair's row left zero (the reference gathers a zero
    # slot for it); the unfilled slots all go to one spare row.  A put's
    # gradient is a gather, so the backward reads and never accumulates.
    pair = torch.arange(tg * k_top, device=xt.device).reshape(1, tg, k_top).expand(g, -1, -1)
    owner = torch.full((g, e, cap + 1), tg * k_top, dtype=torch.int64, device=xt.device)
    owner = owner.index_put((grp, idxg, slot), pair)[:, :, :cap]
    rows = torch.zeros((g, tg * k_top + 1, d), dtype=xt.dtype, device=xt.device)
    rows = rows.index_put((grp[:, :1, :1].expand(g, e, cap), owner), y_e)
    ys = rows[:, :tg * k_top].reshape(g, tg, k_top, d)
    gk = valg * keep
    out = torch.zeros((g, tg, d), dtype=torch.float32, device=xt.device)
    for k in range(k_top):
        out = out + gk[..., k, None] * ys[..., k, :].float()
    return out.to(xt.dtype).reshape(t, d)


def _dispatch_moe(cfg: ArchConfig, p, xt, top_vals, top_idx):
    """Capacity-based dispatch/combine (GShard einsum formulation)."""
    m = cfg.moe
    t, d = xt.shape
    capacity = _capacity(t, m)
    slot, _ = _queue_slots(top_idx, m.n_experts, capacity)  # (T, K)
    disp = (F.one_hot(top_idx, m.n_experts).to(xt.dtype)[..., None]
            * F.one_hot(slot, capacity + 1).to(xt.dtype)[:, :, None, :-1])  # (T,K,E,C)
    comb = disp * top_vals[..., None, None].to(xt.dtype)
    x_e = torch.einsum("tec,td->ecd", disp.sum(1), xt)
    y_e = _expert_ffn(cfg, p, x_e)
    return torch.einsum("tec,ecd->td", comb.sum(1), y_e)
