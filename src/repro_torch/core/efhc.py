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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

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
    ``upd`` (C, m) is False are replaced by ``old_tree``'s.  Leaves
    without the (C, m) device axes (Adam's step count, ()) pass through:
    they are fleet-global."""
    lead = tuple(upd.shape)

    def keep(new_leaf, old_leaf):
        if new_leaf.dim() >= 2 and tuple(new_leaf.shape[:2]) == lead:
            mask = upd.reshape(lead + (1,) * (new_leaf.dim() - 2))
            return torch.where(mask, new_leaf, old_leaf)
        return new_leaf

    return tree_map(keep, new_tree, old_tree)


def _warm_start_sum(nbr_idx: torch.Tensor, adj_ell: torch.Tensor,
                    w_flat: torch.Tensor) -> torch.Tensor:
    """sum_s [adj_ell[..., s]] w[nbr_idx[:, s]] over the ELL slots, in
    slot order: the slot loop of ``consensus`` with the reference's
    ``where`` (a non-finite row of a masked slot never enters the sum;
    a zero weight would let 0 x NaN through)."""
    acc = torch.zeros_like(w_flat)
    zero = torch.zeros((), dtype=w_flat.dtype, device=w_flat.device)
    for s in range(nbr_idx.shape[1]):
        acc = acc + torch.where(adj_ell[..., s:s + 1], w_flat[..., nbr_idx[:, s], :],
                                zero)
    return acc


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

    # resource dynamics: the disabled path draws and masks nothing
    rcfg = cfg.resources
    dyn = cfg.resources_enabled()
    if dyn:
        res = state.resources
        r_keys = prng.split(res.key)
        r_key = r_keys[:, 0]
        up, straggle, bw_live = resources_mod.evolve(
            rcfg, r_keys[:, 1], res.up, res.bw, state.bandwidths, m)
        exhausted = resources_mod.exhausted_mask(rcfg, res.budget)
        # an exhausted device's threshold sees a collapsed bandwidth
        bw_thresh = torch.where(
            exhausted, resources_mod.EXHAUSTED_BW_FRAC * state.bandwidths,
            bw_live)
    else:
        bw_thresh = bw_live = state.bandwidths

    # correlated faults: crash/rejoin and cluster-outage bits evolve here,
    # edge-level faults mask below
    fcfg = cfg.faults
    fdyn = cfg.faults_enabled()
    if fdyn:
        if ftabs is None:
            raise ValueError("faults are on: the step needs the fault tables (ftabs)")
        fst = state.faults
        f_keys = prng.split(fst.key)
        f_key = f_keys[:, 0]
        crashed, rejoined, staleness, cluster_down = faults_mod.evolve(
            fcfg, f_keys[:, 1], fst.crashed, fst.staleness, fst.cluster_down, m)
        f_up = faults_mod.device_up(crashed, cluster_down, ftabs.labels)

    wdog = cfg.watchdog_enabled()
    if (sparse or wdog) and nl is None:
        raise ValueError(f"mix_impl={cfg.mix_impl!r} (or the watchdog) needs "
                         f"the staged neighbor list (nl)")

    if sparse:
        nbr_idx = nl.idx
        adj_ell = graph.adjacency_ell(state.k, nl)
        if dyn:
            # a down endpoint removes the edge from the effective G^(k)
            adj_ell = adj_ell & (up[:, :, None] & up[:, nbr_idx])
        if fdyn:
            adj_ell = adj_ell & (f_up[:, :, None] & f_up[:, nbr_idx])
            if fcfg.edge_faults:
                adj_ell = adj_ell & faults_mod.edge_keep(fcfg, state.k, ftabs)
        adj = topology.scatter_ell(nbr_idx, adj_ell) if dense_aux else None
    else:
        adj = graph.adjacency(state.k, dev_)
        if dyn:
            adj = adj & (up[:, :, None] & up[:, None, :])
        if fdyn:
            adj = adj & (f_up[:, :, None] & f_up[:, None, :])
            if fcfg.edge_faults:
                adj = adj & faults_mod.edge_keep(fcfg, state.k, ftabs)

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
    v = triggers.broadcast_events(cfg.trigger, dev=dev, bandwidths=bw_thresh,
                                  gamma_k=alpha_k, key=k_trig, cells=cells)
    if dyn:
        # down and budget-exhausted devices fire nothing, whatever the policy
        v = v & (up & ~exhausted)
    if fdyn:
        v = v & f_up

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

    if fdyn and fcfg.warm_start:
        # a device rejoining this iteration restarts from the plain average
        # of its live neighbors' pre-mix models (fp32 product, TF32 off)
        if sparse:
            nb_sum = _warm_start_sum(nbr_idx, adj_ell, w_flat)
            nb_cnt = adj_ell.sum(dim=-1, dtype=torch.float32)
        else:
            a_f = adj.float()
            nb_sum = a_f @ w_flat
            nb_cnt = a_f.sum(dim=-1)
        nb_avg = nb_sum / torch.clamp(nb_cnt, min=1.0)[..., None]
        patch = rejoined & (nb_cnt > 0)
        w_mixed_flat = torch.where(patch[..., None], nb_avg, w_mixed_flat)

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
    if opt_update is None:
        w_new = tree_map(lambda wm, g: (wm.float() - alpha_k * g.float()).to(wm.dtype),
                         w_mixed, grads)
        opt_state_new = state.opt_state
    else:
        w_new, opt_state_new = opt_update(grads, state.opt_state, w_mixed, alpha_k)
    if dyn or fdyn:
        # stragglers carry the mixed model; down and crashed devices keep
        # their pre-update rows and optimizer state
        upd = (up & ~straggle) if dyn else None
        if fdyn:
            upd = f_up if upd is None else upd & f_up
        w_new = _mask_update_rows(upd, w_new, w_mixed)
        opt_state_new = _mask_update_rows(upd, opt_state_new, state.opt_state)

    # ---- paper metrics (Sec. IV-A), per cell, on the live bandwidth ------
    deg = deg_i.float()
    used = used_i.float()
    frac = torch.where(deg > 0, used / torch.clamp(deg, min=1.0),
                       torch.zeros((), device=dev_))
    tx_time = torch.mean(frac * model_dim / bw_live, dim=-1)
    capacity = torch.sum(deg * bw_live, dim=-1)
    util = torch.sum(used * model_dim, dim=-1) / torch.clamp(capacity, min=1e-12)
    w_new_flat = flatten_stack(w_new, lead=2)
    consensus_err = torch.sum(
        (w_new_flat - w_new_flat.mean(dim=1, keepdim=True)) ** 2, dim=(1, 2))

    dyn_aux = {}
    if dyn:
        # each realized broadcast ships one model payload
        n_bytes = float(accounting.model_bytes(model_dim))
        res_new = resources_mod.ResourceState(
            bw=bw_live, budget=res.budget - n_bytes * v.float(), up=up, key=r_key)
        dyn_aux["down_count"] = (~up).sum(dim=-1, dtype=torch.int32)
        dyn_aux["exhausted_count"] = exhausted.sum(dim=-1, dtype=torch.int32)
    else:
        res_new = state.resources
    if fdyn:
        f_new = faults_mod.FaultState(crashed=crashed, staleness=staleness,
                                      cluster_down=cluster_down, key=f_key)
        dyn_aux["fault_down_count"] = (~f_up).sum(dim=-1, dtype=torch.int32)
        dyn_aux["stale_max"] = staleness.amax(dim=-1)
    else:
        f_new = state.faults

    new_state = EFHCState(w=w_new, w_hat=w_hat_new, k=state.k + 1,
                          prev_adj=prev_adj_next, bandwidths=state.bandwidths,
                          key=key, opt_state=opt_state_new, resources=res_new,
                          faults=f_new, watchdog=wd_new)
    return new_state, StepAux(v=v, comm=comm, p=p, loss=loss, tx_time=tx_time,
                              util=util, adj=adj, consensus_err=consensus_err,
                              comm_count=used_i, deg=deg_i.expand(C, m),
                              window_connected=window_connected,
                              window_needed=window_needed, **dyn_aux)
