"""Train and serving steps (port of ``repro/launch/steps.py``).

``make_train_step`` is one universal EF-HC iteration (paper Alg. 1) at
framework scale.  The FL devices are m model replicas: every parameter
leaf carries a leading replica axis.  Two forms:

* one card (``make_setup(cfg, m)``): all m replicas on one device, leaves
  (m, ...);
* a device mesh (``make_setup(cfg, mesh)``, ``launch.mesh.make_host_mesh``),
  the reference's form: the replicas are enumerated by the mesh's fl axes
  (``data``, or ``pod`` x ``data``), m = ``fl_count(mesh, mode)`` (or a
  multiple of it, ``replicas=``, each fl rank then holding m / fl_count of
  them), and each replica's leaves are split over ``model`` by the
  reference's ``param_specs`` (``models/sharding.py``): a rank holds leaves
  (m / fl_count, ...its model block).  Over ``model`` > 1 only the dense
  attention family runs tensor-parallel; other block types raise (ROADMAP
  Queue 1 item 19b), as does ``fsdp`` mode over ``data`` > 1 (its
  zero-style split of ``embed``).

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

On a mesh, each rank runs the kernels on its own blocks: Event 2's
``trigger_sq_tree`` over its local leaves (a leaf whole over ``model``
counted on model rank 0 only), the partial sums added over ``model`` in
shard order and gathered over the fl axes, so v and P are the same on
every rank; Event 3 gathers each leaf's local block of every replica over
the fl axes, (m, ...block), mixes them with the same kernels and keeps
the rank's own replica rows; Event 4 runs tensor-parallel
(``sharding.tensor_parallel``) on the rank's replicas, in place.  A
point-to-point ``neighbor`` mix, whose bytes would scale with the degree,
is a later perf item; here both schedules mix the gathered rows.

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
from typing import Any

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core.consensus import edge_coloring
from repro_torch.core.topology import ring_adjacency
from repro_torch.kernels.mixing.ops import mix_sparse_tree, mix_tree
from repro_torch.kernels.trigger.ops import trigger_sq_tree
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.common import ArchConfig
from repro_torch.optim.schedules import paper_diminishing
from repro_torch.prng import sqrt_f32
from repro_torch.tree import first_leaf, tree_leaves, tree_map

MIXES = ("dense", "neighbor", "none")
# elements of a leaf the SGD update takes at a time (elementwise: the same
# values as the whole leaf's update)
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    cfg: ArchConfig
    mode: str  # replica | fsdp
    m: int  # number of FL devices (model replicas)
    adjacency: np.ndarray  # (m, m) static base graph (ring over the replicas)
    bandwidths: np.ndarray  # (m,)
    r: float = 0.05
    alpha0: float = 0.01
    mix: str = "dense"  # dense | neighbor | none
    mesh: Any = None  # launch.mesh.Mesh; None on one card

    @property
    def fl(self) -> S.AxisGroup:
        """The fl axes as this rank's group (one rank without a mesh)."""
        if self.mesh is None:
            return S.AxisGroup(1, 0)
        return self.mesh.axis(S.fl_axes(self.mesh, self.mode))

    @property
    def model(self) -> S.AxisGroup:
        return S.AxisGroup(1, 0) if self.mesh is None else self.mesh.axis("model")

    @property
    def own(self) -> slice:
        """This rank's replicas, rows of the (m, ...) stacks."""
        per = self.m // self.fl.size
        return slice(self.fl.index * per, (self.fl.index + 1) * per)

    @functools.cached_property
    def counted(self) -> list[bool] | None:
        """On a mesh, the leaves (``tree_leaves`` order) this rank counts in
        a sum over a replica's leaves: those split over ``model``, and on
        model rank 0 those whole over it; None on one card."""
        if self.mesh is None:
            return None
        specs = S.param_specs(self.cfg, M.init_params(self.cfg, device="meta"), self.mesh,
                              self.mode)
        return [self.model.index == 0 or not S.whole_over_model(spec)
                for spec in S.spec_leaves(specs)]


def check_tensor_parallel(cfg: ArchConfig, mesh) -> None:
    """Raise unless every block of ``cfg`` runs over ``mesh``'s model axis:
    over ``model`` > 1 only the dense attention family is laid out."""
    if mesh is None or mesh.shape["model"] == 1:
        return
    kinds = sorted({bt for cycle, _ in cfg.layer_plan for bt in cycle} - {"attn", "attn_g"})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}'s block types {kinds} over a mesh 'model' axis of "
            f"{mesh.shape['model']}: their tensor-parallel forms are {S.ITEM_19B}; run "
            f"{cfg.name} with model = 1 (replica mode)")


def make_setup(cfg: ArchConfig, m, *, mix: str = "dense", pods: int = 1,
               replicas: int | None = None) -> TrainSetup:
    """The reference's setup for m replicas: a ring base graph (one edge at
    m = 2, none at m = 1, where the mix is ``"none"``), bandwidths 5000,
    and on a mesh of ``pods`` > 1 pods the first replica of each pod at
    1000 (``bw[::m // pods]``, its slower cross-pod egress), which
    personalizes rho as on the reference's multi-pod mesh.

    ``m`` is the replica count on one card, or a ``launch.mesh.Mesh``: the
    reference's ``make_setup(cfg, mesh)``, mode ``replica`` when
    ``cfg.fl_m`` > 1 else ``fsdp``, m = ``fl_count(mesh, mode)`` (or
    ``replicas``, a multiple of it) and ``pods`` the mesh's own."""
    mesh = None
    mode = None
    if not isinstance(m, (int, np.integer)):
        mesh = m
        mode = "replica" if cfg.fl_m > 1 else "fsdp"
        if mode == "fsdp" and mesh.shape["data"] > 1:
            raise NotImplementedError(
                f"fsdp mode (cfg.fl_m = 1) over a mesh 'data' axis of {mesh.shape['data']}: "
                f"the zero-style split of 'embed' over 'data' is {S.ITEM_19B}; set fl_m > 1 "
                f"(replica mode) or data = 1")
        check_tensor_parallel(cfg, mesh)
        n_fl = S.fl_count(mesh, mode)
        m = n_fl if replicas is None else replicas
        if m % n_fl:
            raise ValueError(f"replicas ({m}) must be a multiple of the mesh's {n_fl} "
                             f"fl ranks")
        pods = mesh.shape.get("pod", 1)
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
    if mode is None:
        mode = "replica" if m > 1 else "fsdp"
    return TrainSetup(cfg=cfg, mode=mode, m=m, adjacency=adj, bandwidths=bw, mix=mix,
                      mesh=mesh)


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
                # in chunks: the fp32 copies of a chunk, not of a whole leaf
                wf, gf = w.view(-1), g.reshape(-1)
                for a in range(0, wf.numel(), UPDATE_CHUNK):
                    wc, gc = wf[a:a + UPDATE_CHUNK], gf[a:a + UPDATE_CHUNK]
                    wc.copy_(wc.float().sub_(gc.float().mul_(alpha)).to(wc.dtype))
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

    fl, model, own, counted = setup.fl, setup.model, setup.own, setup.counted

    def trigger_sq(params, w_hat):
        """(m,) Event-2 sums over every replica, on every rank."""
        if counted is None:
            return trigger_sq_tree(params, w_hat)
        pairs = [(w, h) for w, h, c in zip(tree_leaves(params), tree_leaves(w_hat), counted,
                                          strict=True) if c]
        if pairs:
            sq = trigger_sq_tree([w for w, _ in pairs], [h for _, h in pairs])
        else:
            sq = torch.zeros(own.stop - own.start, dtype=torch.float32,
                             device=first_leaf(params).device)
        return fl.cat(model.sum(sq), 0)

    def mix_rows(p_mat, params):
        """Event 3 in place: each leaf's rows of every replica (gathered
        over the fl axes) mixed, this rank's kept."""
        if fl.size == 1:
            mix(p_mat, params, out=params)
            return
        for leaf in tree_leaves(params):
            rows = fl.cat(leaf.contiguous(), 0)
            leaf.copy_(mix(p_mat, [rows])[0][own])

    @torch.no_grad()
    def train_step(params, w_hat, batch, k):
        device = first_leaf(params).device
        adj, rho = on(device)
        alpha = sched(torch.as_tensor(k, device=device))
        gamma = alpha  # paper Sec. IV-A: gamma^(k) = alpha^(k)

        if setup.mix != "none":
            # ---- Event 2: personalized triggers (paper Eq. 3) -------------
            sq = trigger_sq(params, w_hat)
            v = sqrt_f32(sq / float(n_model_params)) > setup.r * rho * gamma
            comm = torch.logical_and(torch.logical_or(v[:, None], v[None, :]), adj)
            p_mat = mixing.build_p(adj, comm)
            # ---- w_hat takes the triggered rows, then Event 3 (Eq. 8) -----
            mine = v[own]
            tree_map(lambda h, w: torch.where(mine.reshape((-1,) + (1,) * (w.dim() - 1)),
                                              w.to(h.dtype), h, out=h), w_hat, params)
            mix_rows(p_mat, params)
        else:
            v = torch.zeros(m, dtype=torch.bool, device=device)

        # ---- Event 4: local SGD ------------------------------------------
        with S.tensor_parallel(model):
            sums = _local_sgd(cfg, params, batch, alpha)
        metrics = {**{name: fl.sum(x[None])[0] / m for name, x in sums.items()},
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

def _serve_axis(cfg: ArchConfig, mesh):
    check_tensor_parallel(cfg, mesh)
    return None if mesh is None else mesh.axis("model")


def make_serve_step(cfg: ArchConfig, mesh=None):
    """(params, caches, tokens (B,), t) -> (logits (B, V), caches); the
    caches are updated in place.  With ``mesh``: params, caches and tokens
    this rank's blocks (``param_specs`` in ``serve`` mode,
    ``model.init_cache(..., mesh=)``, the batch over the data axes); the
    logits of its rows come back whole over ``model``."""
    axis = _serve_axis(cfg, mesh)

    @torch.no_grad()
    def serve_step(params, caches, tokens, t):
        with S.tensor_parallel(axis):
            return M.decode_step(cfg, params, caches, tokens, t)

    return serve_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """(params, batch) -> logits (B, S, V); with ``mesh`` as
    ``make_serve_step``."""
    axis = _serve_axis(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with S.tensor_parallel(axis):
            logits, _ = M.forward(cfg, params, batch)
        return logits

    return prefill_step
