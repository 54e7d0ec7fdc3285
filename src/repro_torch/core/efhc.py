"""EF-HC: the four-event algorithm (paper Alg. 1) as one step on tensors.

Port of ``repro.core.efhc.step``, with its resource dynamics
(``core.resources``), fault injection (``core.faults``) and B-connectivity
watchdog (``core.flow``).  Per device i the state keeps the main model w_i
and the auxiliary (last broadcast) model w_hat_i, plus the iteration k,
the previous adjacency (Event-1 detection), bandwidths b_i and the PRNG
key.

The step runs C independent cells at once (the reference's
``vmap(engine)`` over cells, written out): every per-cell tensor leads
with a cell axis (``w``/``w_hat``/``opt_state`` leaves (C, m, ...),
``bandwidths`` (C, m), ``key`` (C, 2)), and each cell may run its own
trigger policy (``triggers.CellPolicies``).  The iteration k and the graph
realization G^(k) are shared: the graph process depends only on k, so it
is realized once per iteration for all cells.  Without dynamics
``prev_adj`` is shared too; with resources or faults on, churn and
crashes draw from each cell's own stream, so the effective G^(k) (and
``prev_adj``, ``comm``, P) carries the cell axis: (C, m, m) dense,
(C, m, d_max) ELL over the one shared neighbor table.  A solo run is the
one-cell case.

``step`` is a pure function of its state: it reads tensors, allocates new
ones and never syncs with the host, so the simulator's Python loop over it
stays on the device.  Events 1-3 run on the canonical (C, m, D) flat rows
(``flatten_stack``), one kernel launch for all cells; Event-4 local SGD
runs on the parameter dict with the cells folded into the device axis
(C m devices).

Mix impls, as in the reference:
  dense / delta         - plain P @ W (``core.consensus``)
  pallas                - Event 2 through the trigger kernel and Event 3
                          through the dense mixing kernel (``kernels/``)
  sparse / sparse_delta - the padded neighbor-list (ELL) slot loop
  sparse_pallas         - Event 3 through the ELL gather-mix kernel

``step_sharded`` is the sparse step for the rows of a partitioned fleet
(``SimConfig(mix_impl="sharded")``, ``fl/sharded.py``): the shards one
process holds, with a halo exchange of boundary rows between shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import accounting, consensus, mixing, topology, triggers
from repro_torch.core import faults as faults_mod
from repro_torch.core import flow as flow_mod
from repro_torch.core import resources as resources_mod
from repro_torch.kernels.mixing import ops as mixing_ops
from repro_torch.kernels.trigger import ops as trigger_ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MIX_IMPLS: tuple[str, ...] = ("dense", "delta", "pallas",
                              "sparse", "sparse_delta", "sparse_pallas")
SPARSE_MIX_IMPLS: tuple[str, ...] = ("sparse", "sparse_delta", "sparse_pallas")

# a parameter tree: nested dicts and lists of tensors (flat dicts for svm
# and mlp), every leaf with the same leading axes
Params = dict[str, Any]


class EFHCState(NamedTuple):
    w: Params  # leaves (C, m, ...): per-cell, per-device main models
    w_hat: Params  # leaves (C, m, ...): last-broadcast models
    k: torch.Tensor  # () int64 universal iteration, shared by the cells
    # G^(k-1) for Event-1 detection: (m, m) bool, or the (m, d_max) ELL
    # slot mask under a sparse mix_impl; shared, or with a leading cell
    # axis when resources or faults are on
    prev_adj: torch.Tensor
    bandwidths: torch.Tensor  # (C, m) float32
    key: torch.Tensor  # (C, 2) int64 threefry key words, one per cell
    opt_state: Any = None  # leaves (C, m, ...)
    resources: Any = None  # resources.ResourceState when enabled
    faults: Any = None  # faults.FaultState when enabled
    watchdog: Any = None  # flow.WatchdogState when enabled


@dataclasses.dataclass(frozen=True)
class EFHCConfig:
    trigger: triggers.TriggerConfig = dataclasses.field(
        default_factory=triggers.TriggerConfig)
    mix_impl: str = "dense"  # see MIX_IMPLS
    # scenario dynamics; None (or a disabled config) keeps the step the
    # plain one: the gates are Python-level branches, as in the reference
    resources: resources_mod.ResourceConfig | None = None
    faults: faults_mod.FaultConfig | None = None
    watchdog: flow_mod.WatchdogConfig | None = None

    def resources_enabled(self) -> bool:
        return self.resources is not None and self.resources.enabled

    def faults_enabled(self) -> bool:
        return self.faults is not None and self.faults.enabled

    def watchdog_enabled(self) -> bool:
        return self.watchdog is not None and self.watchdog.enabled

    def cell_adjacency(self) -> bool:
        """True when the effective G^(k) differs per cell (resources or
        faults on): ``prev_adj`` and the ``adj`` channel then lead with
        the cell axis."""
        return self.resources_enabled() or self.faults_enabled()


def init_state(w_stack: Params, bandwidths: torch.Tensor,
               adjacency0: torch.Tensor, key: torch.Tensor,
               opt_state=None, resources=None, faults=None,
               watchdog=None) -> EFHCState:
    return EFHCState(
        w=w_stack, w_hat=tree_map(torch.clone, w_stack),
        k=torch.zeros((), dtype=torch.int64, device=bandwidths.device),
        prev_adj=adjacency0, bandwidths=bandwidths, key=key,
        opt_state=opt_state, resources=resources, faults=faults,
        watchdog=watchdog)


def flatten_stack(w_stack: Params, lead: int = 1) -> torch.Tensor:
    """Canonical float32 rows: leaves concatenated in ``jax.tree.leaves``
    order of the reference (``tree.tree_leaves``: dict keys sorted at each
    level, list items by index) over the last axis, the ``lead`` leading
    axes kept ((m, D) rows of (m, ...) leaves; (C, m, D) of (C, m, ...)
    leaves with ``lead=2``)."""
    leaves = tree_leaves(w_stack)
    shape = tuple(leaves[0].shape[:lead])
    return torch.cat([t.reshape(shape + (-1,)).float() for t in leaves], dim=-1)


def unflatten_stack(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of ``flatten_stack``: slice the rows back into ``like``'s
    leaves, shapes and dtypes (views of ``flat`` for float32 leaves)."""
    lead = flat.dim() - 1
    out, col = [], 0
    for leaf in tree_leaves(like):
        width = leaf.shape[lead:].numel()
        out.append(flat[..., col:col + width].reshape(leaf.shape).to(leaf.dtype))
        col += width
    return tree_unflatten(like, out)


def fold_cells(t: torch.Tensor) -> torch.Tensor:
    """(C, m, ...) -> (C m, ...): the cells as more devices (a view of a
    contiguous tensor)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


class StepAux(NamedTuple):
    """Per-iteration outputs (the paper's plot channels), each per cell."""

    v: torch.Tensor  # (C, m) bool broadcast events fired
    comm: torch.Tensor | None  # (C, m, m) bool links used (dense impls, or
    # scattered from ELL when ``dense_aux``)
    p: torch.Tensor | None  # (C, m, m) transition matrix (same rule)
    loss: torch.Tensor  # (C, m) per-device minibatch loss
    tx_time: torch.Tensor  # (C,) avg transmission time this iteration
    util: torch.Tensor  # (C,) resource utilization
    # (m, m) bool effective adjacency G^(k), shared; (C, m, m) when it
    # differs per cell (``EFHCConfig.cell_adjacency``)
    adj: torch.Tensor | None
    consensus_err: torch.Tensor  # (C,) ||W - 1 w_bar||_F^2 after the update
    comm_count: torch.Tensor  # (C, m) int32 links used per device
    deg: torch.Tensor  # (C, m) int32 physical degree per device
    # scenario-dynamics channels, (C,) each; None while their process is
    # off (the trajectories then hold zeros, and True for
    # window_connected): devices down by churn / out of budget, silenced
    # by a crash or cluster outage, the worst staleness of a crashed
    # device, and the watchdog's verdict and smallest connecting window
    down_count: torch.Tensor | None = None
    exhausted_count: torch.Tensor | None = None
    fault_down_count: torch.Tensor | None = None
    stale_max: torch.Tensor | None = None
    window_connected: torch.Tensor | None = None
    window_needed: torch.Tensor | None = None


def _mask_update_rows(upd: torch.Tensor, new_tree, old_tree):
    """Event-4 straggler/churn/crash mask: rows of ``new_tree`` where
    ``upd`` (C, m), or a shard's (n,), is False are replaced by
    ``old_tree``'s.  Leaves without those device axes (Adam's step count,
    ()) pass through: they are fleet-global."""
    lead = tuple(upd.shape)
    k = len(lead)

    def keep(new_leaf, old_leaf):
        if new_leaf.dim() >= k and tuple(new_leaf.shape[:k]) == lead:
            mask = upd.reshape(lead + (1,) * (new_leaf.dim() - k))
            return torch.where(mask, new_leaf, old_leaf)
        return new_leaf

    return tree_map(keep, new_tree, old_tree)


def _warm_start_sum(nbr_idx: torch.Tensor, adj_ell: torch.Tensor,
                    w_flat: torch.Tensor) -> torch.Tensor:
    """sum_s [adj_ell[..., s]] w[nbr_idx[:, s]] over the ELL slots, in
    slot order: the slot loop of ``consensus`` with the reference's
    ``where`` (a non-finite row of a masked slot never enters the sum;
    a zero weight would let 0 x NaN through).  ``w_flat`` may be a shard's
    ``[own; halo]`` buffer, with more rows than the table."""
    acc = w_flat.new_zeros(w_flat.shape[:-2] + (nbr_idx.shape[0], w_flat.shape[-1]))
    zero = torch.zeros((), dtype=w_flat.dtype, device=w_flat.device)
    for s in range(nbr_idx.shape[1]):
        acc = acc + torch.where(adj_ell[..., s:s + 1], w_flat[..., nbr_idx[:, s], :],
                                zero)
    return acc


class _Draws(NamedTuple):
    """One iteration's resource and fault draws (``_evolve``), over a
    cell's devices (C, m) or a shard's rows (n,); a process's fields are
    None while it is off."""

    bw_live: torch.Tensor  # the bandwidth the metrics and budgets see
    bw_thresh: torch.Tensor  # the bandwidth the trigger threshold sees
    up: torch.Tensor | None = None
    straggle: torch.Tensor | None = None
    exhausted: torch.Tensor | None = None
    r_key: torch.Tensor | None = None
    crashed: torch.Tensor | None = None
    rejoined: torch.Tensor | None = None
    staleness: torch.Tensor | None = None
    cluster_down: torch.Tensor | None = None
    f_up: torch.Tensor | None = None
    f_key: torch.Tensor | None = None

    def live(self, v: torch.Tensor) -> torch.Tensor:
        """Down, budget-exhausted and crashed devices fire nothing,
        whatever the policy."""
        if self.up is not None:
            v = v & (self.up & ~self.exhausted)
        if self.f_up is not None:
            v = v & self.f_up
        return v

    def update_mask(self) -> torch.Tensor | None:
        """Event 4's rows: stragglers carry the mixed model, down and
        crashed devices keep their pre-update rows (None: every row)."""
        upd = (self.up & ~self.straggle) if self.up is not None else None
        if self.f_up is not None:
            upd = self.f_up if upd is None else upd & self.f_up
        return upd


def _evolve(cfg: EFHCConfig, state: EFHCState, m: int,
            ftabs: faults_mod.FaultTabs | None,
            rows: torch.Tensor | None = None) -> _Draws:
    """Evolve resources and take the threshold bandwidth (the exhausted
    clamp), then evolve the crash/rejoin and cluster-outage bits: every
    draw is (m,) per key, sliced by ``rows`` (a shard's owned ids).  The
    disabled processes draw nothing."""
    d: dict = {}
    bw_live = bw_thresh = state.bandwidths
    if cfg.resources_enabled():
        res = state.resources
        r_keys = prng.split(res.key)
        up, straggle, bw_live = resources_mod.evolve(
            cfg.resources, r_keys[..., 1, :], res.up, res.bw, state.bandwidths, m,
            rows=rows)
        exhausted = resources_mod.exhausted_mask(cfg.resources, res.budget)
        # an exhausted device's threshold sees a collapsed bandwidth
        bw_thresh = torch.where(
            exhausted, resources_mod.EXHAUSTED_BW_FRAC * state.bandwidths, bw_live)
        d.update(up=up, straggle=straggle, exhausted=exhausted,
                 r_key=r_keys[..., 0, :])
    if cfg.faults_enabled():
        if ftabs is None:
            raise ValueError("faults are on: the step needs the fault tables (ftabs)")
        fst = state.faults
        f_keys = prng.split(fst.key)
        crashed, rejoined, staleness, cluster_down = faults_mod.evolve(
            cfg.faults, f_keys[..., 1, :], fst.crashed, fst.staleness,
            fst.cluster_down, m, rows=rows)
        d.update(crashed=crashed, rejoined=rejoined, staleness=staleness,
                 cluster_down=cluster_down,
                 f_up=faults_mod.device_up(crashed, cluster_down, ftabs.labels),
                 f_key=f_keys[..., 0, :])
    return _Draws(bw_live=bw_live, bw_thresh=bw_thresh, **d)


def _live_links(cfg: EFHCConfig, k, adj_ell: torch.Tensor, dr: _Draws,
                nbrs: Callable[[torch.Tensor], torch.Tensor],
                ftabs: faults_mod.FaultTabs | None) -> torch.Tensor:
    """The effective G^(k) in ELL slots: a down or crashed endpoint removes
    the edge, and edge faults drop theirs.  ``nbrs(x)`` takes a per-device
    ``x`` to the slots' neighbors' values (pad slots may read junk: the
    link is False there already)."""
    if dr.up is not None:
        adj_ell = adj_ell & (dr.up[..., None] & nbrs(dr.up))
    if dr.f_up is not None:
        adj_ell = adj_ell & (dr.f_up[..., None] & nbrs(dr.f_up))
        if cfg.faults.edge_faults:
            adj_ell = adj_ell & faults_mod.edge_keep(cfg.faults, k, ftabs)
    return adj_ell


def _warm_start(rejoined: torch.Tensor, nb_sum: torch.Tensor, nb_cnt: torch.Tensor,
                w_mixed_flat: torch.Tensor) -> torch.Tensor:
    """A device rejoining this iteration restarts from the plain average of
    its live neighbors' pre-mix models (``nb_sum`` / ``nb_cnt``)."""
    nb_avg = nb_sum / torch.clamp(nb_cnt, min=1.0)[..., None]
    patch = rejoined & (nb_cnt > 0)
    return torch.where(patch[..., None], nb_avg, w_mixed_flat)


def _local_update(state: EFHCState, w_mixed: Params, grads: Params,
                  alpha_k: torch.Tensor, opt_update: Callable | None, dr: _Draws):
    """Event 4: the optimizer step (plain SGD without ``opt_update``) on the
    rows ``dr.update_mask()`` lets through.  Returns (w, opt_state)."""
    if opt_update is None:
        w_new = tree_map(lambda wm, g: (wm.float() - alpha_k * g.float()).to(wm.dtype),
                         w_mixed, grads)
        opt_state_new = state.opt_state
    else:
        w_new, opt_state_new = opt_update(grads, state.opt_state, w_mixed, alpha_k)
    upd = dr.update_mask()
    if upd is not None:
        w_new = _mask_update_rows(upd, w_new, w_mixed)
        opt_state_new = _mask_update_rows(upd, opt_state_new, state.opt_state)
    return w_new, opt_state_new


def _link_metrics(deg_i: torch.Tensor, used_i: torch.Tensor, bw_live: torch.Tensor,
                  model_dim: int, order: Callable[[torch.Tensor], torch.Tensor]):
    """The paper metrics (Sec. IV-A) on the live bandwidth: tx_time and
    util per cell, each per-device term taken to (C, m) rows in device
    order by ``order`` before it is reduced over its last axis."""
    deg = deg_i.float()
    used = used_i.float()
    frac = torch.where(deg > 0, used / torch.clamp(deg, min=1.0),
                       torch.zeros((), device=deg.device))
    tx_time = torch.mean(order(frac * model_dim / bw_live), dim=-1)
    capacity = torch.sum(order(deg * bw_live), dim=-1)
    util = torch.sum(order(used * model_dim), dim=-1) / torch.clamp(capacity, min=1e-12)
    return tx_time, util


def _carry_processes(state: EFHCState, dr: _Draws, v: torch.Tensor, model_dim: int,
                     count: Callable[[torch.Tensor], torch.Tensor],
                     top: Callable[[torch.Tensor], torch.Tensor]):
    """The resource and fault states after the step (each realized
    broadcast debits one model payload) and their counters: ``count``
    takes a per-device bool to its count, ``top`` a per-device int to its
    max.  Returns (resources, faults, counters)."""
    aux = {}
    res_new, f_new = state.resources, state.faults
    if dr.up is not None:
        n_bytes = float(accounting.model_bytes(model_dim))
        res_new = resources_mod.ResourceState(
            bw=dr.bw_live, budget=state.resources.budget - n_bytes * v.float(),
            up=dr.up, key=dr.r_key)
        aux["down_count"] = count(~dr.up)
        aux["exhausted_count"] = count(dr.exhausted)
    if dr.f_up is not None:
        f_new = faults_mod.FaultState(crashed=dr.crashed, staleness=dr.staleness,
                                      cluster_down=dr.cluster_down, key=dr.f_key)
        aux["fault_down_count"] = count(~dr.f_up)
        aux["stale_max"] = top(dr.staleness)
    return res_new, f_new, aux


def step(
    cfg: EFHCConfig,
    graph: topology.GraphProcess,
    state: EFHCState,
    *,
    loss_and_grad: Callable[[Params, Any], tuple[torch.Tensor, Params]],
    batch,
    alpha_k: torch.Tensor,
    model_dim: int,
    cells: triggers.CellPolicies | None = None,
    nl: topology.StagedNeighbors | None = None,
    opt_update: Callable | None = None,
    dense_aux: bool = True,
    ftabs: faults_mod.FaultTabs | None = None,
) -> tuple[EFHCState, StepAux]:
    """One universal iteration of Alg. 1 across all m devices of all C
    cells.

    ``batch`` is (x (C, m, B, ...), y (C, m, B)); ``loss_and_grad(w,
    batch) -> (loss (n,), grads)`` is the batched per-device gradient
    (``ModelSpec.loss_and_grad``), called once with the cells folded into
    n = C m devices.  ``cells`` gives each cell's trigger policy; None runs
    ``cfg.trigger.policy`` in every cell.  ``nl`` is the base graph's
    neighbor list on the run's device, required under a sparse mix_impl
    and whenever the watchdog is on.  ``opt_update`` is a
    ``repro_torch.optim`` update; None is plain SGD.  ``dense_aux=False``
    skips scattering the ELL slots into (m, m) ``comm``/``adj``/``p``
    under a sparse impl (summary traces do not read them; the reference
    leaves them to dead-code elimination).  ``ftabs`` are the fault
    fabric's tables in the impl's layout, required when faults are on.

    With resources, faults or the watchdog on, the step follows the
    reference's order: evolve resources and take the threshold bandwidth
    (the exhausted clamp), evolve faults, mask G^(k) by liveness and
    ``edge_keep``, hard-mask v, mix, warm-start rejoined devices, run the
    watchdog, mask Event 4 for stragglers and down devices, take the
    metrics on the live bandwidth and debit the budgets."""
    if cfg.mix_impl not in MIX_IMPLS:
        raise ValueError(f"unknown mix_impl {cfg.mix_impl!r}; known: {MIX_IMPLS}")
    sparse = cfg.mix_impl in SPARSE_MIX_IMPLS
    dev_ = state.bandwidths.device
    C, m = state.bandwidths.shape
    keys = prng.split(state.key, 3)  # (C, 3, 2)
    # the third key feeds the reference's per-device gradient keys, which
    # the paper models ignore; nothing else draws from it
    key, k_trig = keys[:, 0], keys[:, 1]

    # resource and correlated-fault dynamics (the disabled processes draw
    # and mask nothing); edge-level faults mask below
    dr = _evolve(cfg, state, m, ftabs)

    wdog = cfg.watchdog_enabled()
    if (sparse or wdog) and nl is None:
        raise ValueError(f"mix_impl={cfg.mix_impl!r} (or the watchdog) needs "
                         f"the staged neighbor list (nl)")

    if sparse:
        nbr_idx = nl.idx
        adj_ell = _live_links(cfg, state.k, graph.adjacency_ell(state.k, nl), dr,
                              lambda x: x[:, nbr_idx], ftabs)
        adj = topology.scatter_ell(nbr_idx, adj_ell) if dense_aux else None
    else:
        adj = graph.adjacency(state.k, dev_)
        if dr.up is not None:
            adj = adj & (dr.up[:, :, None] & dr.up[:, None, :])
        if dr.f_up is not None:
            adj = adj & (dr.f_up[:, :, None] & dr.f_up[:, None, :])
            if cfg.faults.edge_faults:
                adj = adj & faults_mod.edge_keep(cfg.faults, state.k, ftabs)

    # ---- Event 2: broadcast triggers -------------------------------------
    w_flat = flatten_stack(state.w, lead=2)  # (C, m, D)
    w_hat_flat = flatten_stack(state.w_hat, lead=2)
    if cfg.mix_impl == "pallas":
        # the kernel's rows are the cells' devices, (C m, D)
        sq = trigger_ops.trigger_sq(w_flat.reshape(C * m, -1),
                                    w_hat_flat.reshape(C * m, -1))
        dev = torch.sqrt(sq.reshape(C, m) / w_flat.shape[-1])
    else:
        dev = triggers.rms_deviation(w_flat, w_hat_flat)
    v = dr.live(triggers.broadcast_events(cfg.trigger, dev=dev, bandwidths=dr.bw_thresh,
                                          gamma_k=alpha_k, key=k_trig, cells=cells))

    # ---- Events 1 + 3: new links, information-flow edges, mixing ---------
    if sparse:
        new_links_ell = torch.logical_and(adj_ell, ~state.prev_adj)
        vv_ell = torch.logical_or(v[:, :, None], v[:, nbr_idx])
        comm_ell = torch.logical_or(torch.logical_and(vv_ell, adj_ell),
                                    new_links_ell)  # (C, m, d_max)
        p_diag, p_off = mixing.build_p_ell(nbr_idx, adj_ell, comm_ell)
        if cfg.mix_impl == "sparse_pallas":
            w_mixed_flat = mixing_ops.mix_sparse(nbr_idx, p_diag, p_off, w_flat)
        elif cfg.mix_impl == "sparse_delta":
            w_mixed_flat = consensus.mix_delta_sparse(nbr_idx, p_off, w_flat)
        else:
            w_mixed_flat = consensus.mix_sparse(nbr_idx, p_diag, p_off, w_flat)
        if dense_aux:
            comm = topology.scatter_ell(nbr_idx, comm_ell)
            p = topology.scatter_ell(nbr_idx, p_off) + torch.diag_embed(p_diag)
        else:
            comm = p = None
        used_i = comm_ell.sum(dim=-1, dtype=torch.int32)
        deg_i = adj_ell.sum(dim=-1, dtype=torch.int32)
        prev_adj_next = adj_ell
    else:
        new_links = torch.logical_and(adj, ~state.prev_adj)
        comm = torch.logical_or(triggers.communication_matrix(v, adj), new_links)
        p = mixing.build_p(adj, comm)  # (C, m, m)
        if cfg.mix_impl == "pallas":
            w_mixed_flat = mixing_ops.mix(p, w_flat)
        elif cfg.mix_impl == "delta":
            w_mixed_flat = consensus.mix_delta_dense(p, w_flat)
        else:
            w_mixed_flat = consensus.mix_dense(p, w_flat)
        used_i = comm.sum(dim=-1, dtype=torch.int32)
        deg_i = adj.sum(dim=-1, dtype=torch.int32)
        prev_adj_next = adj

    if dr.f_up is not None and cfg.faults.warm_start:
        # the neighbors' sum: the slot loop, or the fp32 product (TF32 off)
        if sparse:
            nb_sum = _warm_start_sum(nbr_idx, adj_ell, w_flat)
            nb_cnt = adj_ell.sum(dim=-1, dtype=torch.float32)
        else:
            a_f = adj.float()
            nb_sum = a_f @ w_flat
            nb_cnt = a_f.sum(dim=-1)
        w_mixed_flat = _warm_start(dr.rejoined, nb_sum, nb_cnt, w_mixed_flat)

    # the watchdog over the realized information-flow edges E'^(k); a dense
    # comm matrix is gathered into the neighbor list's slots first
    if wdog:
        if sparse:
            w_comm = comm_ell
        else:
            w_comm = flow_mod.comm_ell_from_dense(comm, nl.idx, nl.mask)
        wd_age, window_connected, window_needed = flow_mod.watchdog_step(
            cfg.watchdog, nl.idx, w_comm, state.watchdog.age)
        wd_new = flow_mod.WatchdogState(age=wd_age)
    else:
        wd_new, window_connected, window_needed = state.watchdog, None, None

    # w_hat update: broadcasting devices snapshot their pre-mix model
    # (Alg. 1 line 12: w_hat^(k+1) = w^(k))
    def snapshot(h, w):
        return torch.where(v.reshape((C, m) + (1,) * (h.dim() - 2)), w, h)

    w_hat_new = tree_map(snapshot, state.w_hat, state.w)

    # ---- Event 4: local SGD on the parameter dict ------------------------
    # the cells fold into the device axis: one batched pass over C m devices
    w_mixed = unflatten_stack(w_mixed_flat, state.w)
    loss, grads = loss_and_grad(tree_map(fold_cells, w_mixed),
                                tuple(fold_cells(t) for t in batch))
    loss = loss.reshape(C, m)
    grads = tree_map(lambda g, wm: g.reshape(wm.shape), grads, w_mixed)
    w_new, opt_state_new = _local_update(state, w_mixed, grads, alpha_k, opt_update, dr)

    # ---- paper metrics (Sec. IV-A), per cell, on the live bandwidth ------
    tx_time, util = _link_metrics(deg_i, used_i, dr.bw_live, model_dim, lambda x: x)
    w_new_flat = flatten_stack(w_new, lead=2)
    consensus_err = torch.sum(
        (w_new_flat - w_new_flat.mean(dim=1, keepdim=True)) ** 2, dim=(1, 2))
    res_new, f_new, dyn_aux = _carry_processes(
        state, dr, v, model_dim, lambda x: x.sum(dim=-1, dtype=torch.int32),
        lambda x: x.amax(dim=-1))

    new_state = EFHCState(w=w_new, w_hat=w_hat_new, k=state.k + 1,
                          prev_adj=prev_adj_next, bandwidths=state.bandwidths,
                          key=key, opt_state=opt_state_new, resources=res_new,
                          faults=f_new, watchdog=wd_new)
    return new_state, StepAux(v=v, comm=comm, p=p, loss=loss, tx_time=tx_time,
                              util=util, adj=adj, consensus_err=consensus_err,
                              comm_count=used_i, deg=deg_i.expand(C, m),
                              window_connected=window_connected,
                              window_needed=window_needed, **dyn_aux)


# ---------------------------------------------------------------------------
# The sharded fleet step: the step's sparse branch for the rows of the L
# shards one process holds, with one halo exchange of boundary rows for
# what crosses shards (the reference's ``step_sharded`` under shard_map).
# ---------------------------------------------------------------------------

class ShardCtx(NamedTuple):
    """A rank's L shards of a ``topology.ShardPlan`` on the run's device,
    their rows stacked shard-major: n = L ms local rows."""

    owned: torch.Tensor  # (n,) int64 global device ids
    nbr_gid: torch.Tensor  # (n, d_max) int64 global neighbor ids
    # (n, d_max) int64 index into the stacked buffer [own rows of the L
    # shards ; halo rows of the L shards], n + L H_max rows
    nbr_loc: torch.Tensor
    mask: torch.Tensor  # (n, d_max) bool real-slot mask
    send_idx: torch.Tensor  # (L, B_max) int64 local rows sent each exchange
    recv_src: torch.Tensor  # (L H_max,) int64 flat (S B_max) positions
    inv_perm: torch.Tensor  # (m,) int64 global id -> shard-major row

    @classmethod
    def of(cls, plan: topology.ShardPlan, shards: range, device) -> "ShardCtx":
        """The shards ``shards`` (consecutive global ids) of ``plan``."""
        sl = slice(shards.start, shards.stop)
        L, ms, h = len(shards), plan.ms, plan.h_max
        n = L * ms
        lead = np.arange(L, dtype=np.int64)[:, None, None]
        loc = plan.nbr_loc[sl].astype(np.int64)
        # own rows of shard l sit at l ms + r, its halo rows at n + l h + r
        buf_loc = np.where(loc < ms, lead * ms + loc, n + lead * h + (loc - ms))

        def put(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

        return cls(owned=put(plan.owned[sl].reshape(n)),
                   nbr_gid=put(plan.nbr_gid[sl].reshape(n, -1)),
                   nbr_loc=put(buf_loc.reshape(n, -1)),
                   mask=put(plan.mask[sl].reshape(n, -1), torch.bool),
                   send_idx=put(plan.send_idx[sl].astype(np.int64)
                                + lead[:, :, 0] * ms),
                   recv_src=put(plan.recv_src[sl].reshape(-1)),
                   inv_perm=put(plan.inv_perm))

    def per_shard(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) local rows -> (L, ms, ...), one row block a shard."""
        return x.reshape((self.send_idx.shape[0], -1) + tuple(x.shape[1:]))

    def global_order(self, group, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) local rows -> (m, ...) of the whole fleet in global
        device order: every shard's rows gathered through ``group``, then
        ``inv_perm``."""
        return group.all_gather(self.per_shard(x)).flatten(0, 1)[self.inv_perm]


class ShardAux(NamedTuple):
    """One sharded iteration's summary-trace channels: per-device (n,)
    over the local rows (the engine gathers them into global order once,
    after the run), the rest fleet-global scalars, the same on every rank;
    None while their process is off."""

    v: torch.Tensor  # (n,) bool
    loss: torch.Tensor  # (n,)
    tx_time: torch.Tensor  # ()
    util: torch.Tensor  # ()
    consensus_err: torch.Tensor  # () hierarchical fp32 sum
    comm_count: torch.Tensor  # (n,) int32
    deg: torch.Tensor  # (n,) int32
    down_count: torch.Tensor | None = None
    exhausted_count: torch.Tensor | None = None
    fault_down_count: torch.Tensor | None = None
    stale_max: torch.Tensor | None = None
    window_connected: torch.Tensor | None = None
    window_needed: torch.Tensor | None = None


def halo_exchange(ctx: ShardCtx, group, x: torch.Tensor) -> torch.Tensor:
    """(n, ...) per-row payload -> (L H_max, ...) halo rows: all-gather only
    the boundary rows (``send_idx``) of every shard and take each local
    shard's halo out of the flat (S B_max, ...) result at ``recv_src``.
    Pad rows carry row 0's junk, which no real slot reads."""
    gath = group.all_gather(x[ctx.send_idx])
    return gath.reshape((-1,) + tuple(gath.shape[2:]))[ctx.recv_src]


def step_sharded(
    cfg: EFHCConfig,
    graph: topology.GraphProcess,
    ctx: ShardCtx,
    state: EFHCState,
    *,
    group,
    loss_and_grad: Callable[[Params, Any], tuple[torch.Tensor, Params]],
    batch,
    alpha_k: torch.Tensor,
    model_dim: int,
    m: int,
    policy: int,
    opt_update: Callable | None = None,
    ftabs: faults_mod.FaultTabs | None = None,
) -> tuple[EFHCState, ShardAux]:
    """One universal iteration of Alg. 1 for the n local rows of a sharded
    fleet (``launch.mesh.ShardGroup``: the L shards of this rank).

    ``state`` holds the local rows (leaves (n, ...), ``bandwidths`` (n,),
    ``prev_adj`` the (n, d_max) ELL mask) but ``key``, the fleet's (2,) key,
    the same on every rank, so the split stream is the single-device
    engine's; ``batch`` is the local rows' (x (n, B, ...), y (n, B));
    ``policy`` indexes ``triggers.POLICIES``.  Bit for bit the sparse step's
    rows at every shard count, as in the reference:

    * G^(k): ``adjacency_ell_rows`` draws per canonical global edge id;
    * triggers are elementwise, and gossip draws the whole (m,) uniform
      and takes the owned rows (``policy_branches_rows``); the resource
      and fault draws likewise, their cluster bits from the global key;
    * liveness, v, degrees and the pre-mix rows of the neighbors on other
      shards arrive through the halo exchange; the mix and the warm start
      run the slot loop in order over the ``[own; halo]`` buffer (the
      gather-mix kernel takes the mix on the card, one launch for all
      local shards);
    * tx_time and util reduce the per-device terms gathered into global
      device order (``inv_perm``).

    ``consensus_err`` alone is a hierarchical sum (a column sum over
    shards, then the shards' squared deviations): equal to the single
    device's up to fp32 summation order, held by tolerance.  The third key
    of the split feeds the reference's per-device gradient keys
    (``split(k_grad, m)[owned]``), which no model reads, as in ``step``."""
    n = ctx.owned.shape[0]
    keys = prng.split(state.key, 3)
    key, k_trig = keys[0], keys[1]

    def buf(x):  # the [own; halo] buffer of a per-row payload
        return torch.cat([x, halo_exchange(ctx, group, x)])

    dr = _evolve(cfg, state, m, ftabs, rows=ctx.owned)
    adj_ell = _live_links(cfg, state.k, graph.adjacency_ell_rows(
        state.k, ctx.nbr_gid, ctx.mask, ctx.owned), dr,
        lambda x: buf(x)[ctx.nbr_loc], ftabs)
    deg_i = adj_ell.sum(dim=-1, dtype=torch.int32)

    # ---- Event 2: broadcast triggers (local rows) ------------------------
    w_flat = flatten_stack(state.w)  # (n, D)
    w_hat_flat = flatten_stack(state.w_hat)
    dev = triggers.rms_deviation(w_flat, w_hat_flat)
    branches = triggers.policy_branches_rows(cfg.trigger, m, ctx.owned)
    v = dr.live(branches[policy](dev, dr.bw_thresh, alpha_k, k_trig))

    # ---- the halo: boundary rows of (w, v, deg) --------------------------
    w_halo = halo_exchange(ctx, group, w_flat)
    v_buf, deg_buf = buf(v), buf(deg_i)

    # ---- Events 1 + 3: new links, information-flow edges, mixing ---------
    new_links_ell = torch.logical_and(adj_ell, ~state.prev_adj)
    vv_ell = torch.logical_or(v[:, None], v_buf[ctx.nbr_loc])
    comm_ell = torch.logical_or(torch.logical_and(vv_ell, adj_ell), new_links_ell)
    p_diag, p_off = mixing.build_p_ell_halo(ctx.nbr_loc, adj_ell, comm_ell, deg_buf)
    w_mixed_flat = consensus.mix_sparse_halo(ctx.nbr_loc, p_diag, p_off, w_flat, w_halo)
    used_i = comm_ell.sum(dim=-1, dtype=torch.int32)

    if dr.f_up is not None and cfg.faults.warm_start:
        # neighbor rows from the [own; halo] buffer of pre-patch rows: the
        # sparse step's slot-order sum, so the rows stay bit-exact
        w_mixed_flat = _warm_start(
            dr.rejoined, _warm_start_sum(ctx.nbr_loc, adj_ell, torch.cat([w_flat, w_halo])),
            adj_ell.sum(dim=-1, dtype=torch.float32), w_mixed_flat)

    def top(x):  # a per-row value -> its fleet-wide max
        return group.max(ctx.per_shard(x).amax(dim=1))

    if cfg.watchdog_enabled():
        wd_age, window_connected, window_needed = flow_mod.watchdog_step_halo(
            cfg.watchdog, m, ctx.nbr_loc, ctx.owned, comm_ell, state.watchdog.age,
            buf, top)
        wd_new = flow_mod.WatchdogState(age=wd_age)
    else:
        wd_new, window_connected, window_needed = state.watchdog, None, None

    def snapshot(h, w):
        return torch.where(v.reshape((n,) + (1,) * (h.dim() - 1)), w, h)

    w_hat_new = tree_map(snapshot, state.w_hat, state.w)

    # ---- Event 4: local SGD on the local rows ----------------------------
    w_mixed = unflatten_stack(w_mixed_flat, state.w)
    loss, grads = loss_and_grad(w_mixed, batch)
    w_new, opt_state_new = _local_update(state, w_mixed, grads, alpha_k, opt_update, dr)

    # ---- paper metrics, reduced in global device order -------------------
    # (1, m) rows reduced over their last axis, as ``step`` reduces a cell
    tx_time, util = _link_metrics(deg_i, used_i, dr.bw_live, model_dim,
                                  lambda x: ctx.global_order(group, x)[None])
    w_new_flat = ctx.per_shard(flatten_stack(w_new))  # (L, ms, D)
    col_mean = group.sum(w_new_flat.sum(dim=1)) / m
    consensus_err = group.sum(((w_new_flat - col_mean) ** 2).sum(dim=(1, 2)))
    res_new, f_new, dyn_aux = _carry_processes(
        state, dr, v, model_dim,
        lambda x: group.sum(ctx.per_shard(x).sum(dim=1, dtype=torch.int32)), top)

    new_state = EFHCState(w=w_new, w_hat=w_hat_new, k=state.k + 1, prev_adj=adj_ell,
                          bandwidths=state.bandwidths, key=key,
                          opt_state=opt_state_new, resources=res_new, faults=f_new,
                          watchdog=wd_new)
    return new_state, ShardAux(v=v, loss=loss, tx_time=tx_time[0], util=util[0],
                               consensus_err=consensus_err, comm_count=used_i,
                               deg=deg_i, window_connected=window_connected,
                               window_needed=window_needed, **dyn_aux)
