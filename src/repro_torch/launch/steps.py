"""Train and serving steps on one card (port of ``repro/launch/steps.py``).

``make_train_step`` is one universal EF-HC iteration (paper Alg. 1) at
framework scale.  The FL devices are m model replicas on the card:
every parameter leaf carries a leading replica axis (m, ...).  The
reference enumerates them along the fl axes of a device mesh; the port has
no mesh for the architecture models (ROADMAP Queue 1 item 19), so all m
replicas live on one card and ``make_setup`` takes m itself.

Each step, in the reference's order:

* Event 2, the personalized trigger (paper Eq. 3 / 7): ``trigger_sq_tree``
  over the stacked leaves in their own dtype (the bf16 entry of
  ``csrc/trigger_sq.cu`` for the architectures), ``v = sqrt(sq / N) >
  r rho gamma^k``, strict;
* Event 3, consensus mixing ``W <- P W`` with the Metropolis P of the
  triggered links (Eq. 8), under one of the reference's schedules:
  ``"dense"`` (``mix_tree``: the ``mix`` kernel on each leaf),
  ``"neighbor"`` (``mix_neighbor_permute``: the static edge coloring's
  matching rounds as the slots of an ELL gather-mix, ``mix_sparse_tree``)
  or ``"none"`` (m == 1);
* Event 4, local SGD through ``models.model.loss_fn``: each replica's
  forward and backward alone, one replica's activations live at a time,
  ``w <- (w.f32 - alpha g.f32).to(w.dtype)``.

The step updates ``params`` and ``w_hat`` in place and returns them: w_hat
takes the triggered replicas' rows, each mixed leaf is written over its
input leaf as soon as it exists, and each replica's update over its mixed
rows.  The reference returns new arrays; in place, a step holds the two
stacked copies and one leaf's mixed rows instead of four copies.

The reference's ``REPRO_VARIANT=mix_bf16`` branch of ``_mix_dense`` (P in
the leaf's dtype) is not ported: it comes with ``variants.py``, ROADMAP
Queue 1 item 10.

The serving steps run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core.consensus import edge_coloring
from repro_torch.core.topology import ring_adjacency
from repro_torch.kernels.mixing.ops import mix_sparse_tree, mix_tree
from repro_torch.kernels.trigger.ops import trigger_sq_tree
from repro_torch.models import model as M
from repro_torch.models.common import ArchConfig
from repro_torch.optim.schedules import paper_diminishing
from repro_torch.prng import sqrt_f32
from repro_torch.tree import first_leaf, tree_leaves, tree_map

MIXES = ("dense", "neighbor", "none")


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    cfg: ArchConfig
    mode: str  # replica | fsdp (informational on one card)
    m: int  # number of FL devices (model replicas)
    adjacency: np.ndarray  # (m, m) static base graph (ring over the replicas)
    bandwidths: np.ndarray  # (m,)
    r: float = 0.05
    alpha0: float = 0.01
    mix: str = "dense"  # dense | neighbor | none


def make_setup(cfg: ArchConfig, m: int, *, mix: str = "dense", pods: int = 1
               ) -> TrainSetup:
    """The reference's setup for m replicas: a ring base graph (one edge at
    m = 2, none at m = 1, where the mix is ``"none"``), bandwidths 5000,
    and on a mesh of ``pods`` > 1 pods the first replica of each pod at
    1000 (``bw[::m // pods]``, its slower cross-pod egress), which
    personalizes rho as on the reference's multi-pod mesh."""
    if m < 1:
        raise ValueError(f"make_setup takes m >= 1 replicas; got {m}")
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}; got {mix!r}")
    if pods < 1 or m % pods:
        raise ValueError(f"pods must divide m; got pods={pods}, m={m}")
    if m >= 3:
        adj = ring_adjacency(m)
    elif m == 2:
        adj = np.array([[False, True], [True, False]])
    else:
        adj = np.zeros((1, 1), bool)
        mix = "none"
    bw = np.full(m, 5000.0)
    if pods > 1 and m > 2:
        bw[::m // pods] = 1000.0  # pod-boundary replicas
    return TrainSetup(cfg=cfg, mode="replica" if m > 1 else "fsdp", m=m,
                      adjacency=adj, bandwidths=bw, mix=mix)


# ---------------------------------------------------------------------------
# EF-HC pieces at framework scale
# ---------------------------------------------------------------------------

def neighbor_slots(rounds, m: int) -> np.ndarray:
    """The matching rounds as an ELL table (m, len(rounds)): column r is
    round r's permutation of the replicas (matched endpoints swapped, an
    unmatched replica its own index), in the reference's loop order."""
    table = np.empty((m, len(rounds)), np.int64)
    for r, matching in enumerate(rounds):
        perm = np.arange(m)
        for (a, b) in matching:
            perm[a], perm[b] = perm[b], perm[a]
        table[:, r] = perm
    return table


def mix_neighbor_permute(p_mat: torch.Tensor, params, rounds, *, out=None):
    """Beyond-paper mix schedule: P's sparse pattern decomposed over a
    static edge coloring of the base graph,

        W' = diag(P) W + sum_r  w_r * W[perm_r],

    with w_r[i] = P[i, perm_r[i]] (zero where i is unmatched in round r).
    The reference lowers each round to a collective permute over the fl
    mesh axes; on one card it is one ELL gather-mix per leaf
    (``mix_sparse_tree``: ``nbr_idx[:, r] = perm_r``, ``p_off[:, r] =
    w_r``, ``p_diag = diag P``), slots summed in round order in fp32 as
    the reference sums its rounds."""
    m = p_mat.shape[0]
    nbr_idx = torch.as_tensor(neighbor_slots(rounds, m), device=p_mat.device)
    rows = torch.arange(m, device=p_mat.device)[:, None]
    p_off = torch.where(nbr_idx != rows, p_mat[rows, nbr_idx], 0.0)
    p_diag = torch.diagonal(p_mat).contiguous()
    return mix_sparse_tree(nbr_idx, p_diag, p_off.contiguous(), params, out=out)


def _local_sgd(cfg: ArchConfig, params, batch, alpha: torch.Tensor
               ) -> dict[str, torch.Tensor]:
    """Event 4 in place: each replica's loss and gradient alone (the
    reference's vmap over the replica axis), its update written over its
    rows; returns the sums over the replicas of ``loss_fn``'s ``loss``,
    ``ce`` and ``aux`` (fp32)."""
    m = first_leaf(params).shape[0]
    total = {name: torch.zeros((), dtype=torch.float32, device=first_leaf(params).device)
             for name in ("loss", "ce", "aux")}
    for i in range(m):
        mine = tree_map(lambda t: t[i].detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, parts = M.loss_fn(cfg, mine, {k: v[i] for k, v in batch.items()})
        leaves = tree_leaves(mine)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for w, g in zip(leaves, grads):
            if g is not None:  # an unused leaf keeps its value, as w - alpha 0
                w.copy_(w.float().sub_(g.float().mul_(alpha)).to(w.dtype))
        del grads, leaves, mine  # one replica's gradients live at a time
        for name in total:
            total[name] = total[name] + parts[name].detach()
    return total


def make_train_step(setup: TrainSetup, *, n_model_params: int, mix_override=None):
    """The EF-HC train step ``(params, w_hat, batch, k) -> (params, w_hat,
    metrics)``: params and w_hat stacked trees (m, ...) on one device
    (updated in place), batch a dict of (m, B, S) tensors there, k the
    step.  metrics: ``loss`` (the replicas' mean; the reference's), ``ce``
    and ``aux`` (the means of ``loss_fn``'s terms: the cross-entropy and
    the MoE router's aux loss, 0 without one), ``trigger_rate``,
    ``alpha`` and ``v`` (m,), all tensors on the device.  ``mix_override``
    replaces the dense schedule, ``mix_tree`` (the reference's
    ``_mix_dense``): ``mix(p_mat, params, out=params)``."""
    cfg, m = setup.cfg, setup.m
    sched = paper_diminishing(setup.alpha0, gamma=1.0, theta=0.5)
    mix = mix_override if mix_override is not None else mix_tree
    consts: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def on(device) -> tuple[torch.Tensor, torch.Tensor]:
        hit = consts.get(str(device))
        if hit is None:
            bw = torch.as_tensor(np.asarray(setup.bandwidths, np.float32), device=device)
            rho = 1.0 / bw * bw.mean()  # normalized inverse bandwidth (EF-HC)
            hit = (torch.as_tensor(setup.adjacency, device=device), rho)
            consts[str(device)] = hit
        return hit

    @torch.no_grad()
    def train_step(params, w_hat, batch, k):
        device = first_leaf(params).device
        adj, rho = on(device)
        alpha = sched(torch.as_tensor(k, device=device))
        gamma = alpha  # paper Sec. IV-A: gamma^(k) = alpha^(k)

        if setup.mix != "none":
            # ---- Event 2: personalized triggers (paper Eq. 3) -------------
            sq = trigger_sq_tree(params, w_hat)
            v = sqrt_f32(sq / float(n_model_params)) > setup.r * rho * gamma
            comm = torch.logical_and(torch.logical_or(v[:, None], v[None, :]), adj)
            p_mat = mixing.build_p(adj, comm)
            # ---- w_hat takes the triggered rows, then Event 3 (Eq. 8) -----
            tree_map(lambda h, w: torch.where(v.reshape((m,) + (1,) * (w.dim() - 1)),
                                              w.to(h.dtype), h, out=h), w_hat, params)
            mix(p_mat, params, out=params)
        else:
            v = torch.zeros(m, dtype=torch.bool, device=device)

        # ---- Event 4: local SGD ------------------------------------------
        sums = _local_sgd(cfg, params, batch, alpha)
        metrics = {**{name: x / m for name, x in sums.items()},
                   "trigger_rate": v.float().mean(), "alpha": alpha, "v": v}
        return params, w_hat, metrics

    return train_step


def make_neighbor_train_step(setup: TrainSetup, *, n_model_params: int):
    """``make_train_step`` with the neighbor-permute mix schedule."""
    rounds = edge_coloring(setup.adjacency)
    return make_train_step(
        setup, n_model_params=n_model_params,
        mix_override=functools.partial(mix_neighbor_permute, rounds=rounds))


# ---------------------------------------------------------------------------
# serve steps (the reference's ``repro/launch/steps.py:213-228``)
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ArchConfig):
    """(params, caches, tokens (B,), t) -> (logits (B, V), caches); the
    caches are updated in place."""
    @torch.no_grad()
    def serve_step(params, caches, tokens, t):
        return M.decode_step(cfg, params, caches, tokens, t)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> logits (B, S, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch)
        return logits

    return prefill_step
