"""EF-HC: the four-event algorithm (paper Alg. 1) as one step on tensors.

Port of ``repro.core.efhc.step`` with resource dynamics, fault injection
and the watchdog off.  Per device i the state keeps the main model w_i and
the auxiliary (last broadcast) model w_hat_i, plus the iteration k, the
previous adjacency (Event-1 detection), bandwidths b_i and the PRNG key.

The step runs C independent cells at once (the reference's
``vmap(engine)`` over cells, written out): every per-cell tensor leads
with a cell axis (``w``/``w_hat``/``opt_state`` leaves (C, m, ...),
``bandwidths`` (C, m), ``key`` (C, 2)), and each cell may run its own
trigger policy (``triggers.CellPolicies``).  The iteration k, the graph
realization G^(k) and ``prev_adj`` are shared: the graph process depends
only on k, so it is realized once per iteration for all cells.  A solo run
is the one-cell case.

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
from repro_torch.core import consensus, mixing, topology, triggers
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
    # G^(k-1) for Event-1 detection, shared: (m, m) bool, or the (m, d_max)
    # ELL slot mask under a sparse mix_impl
    prev_adj: torch.Tensor
    bandwidths: torch.Tensor  # (C, m) float32
    key: torch.Tensor  # (C, 2) int64 threefry key words, one per cell
    opt_state: Any = None  # leaves (C, m, ...)


@dataclasses.dataclass(frozen=True)
class EFHCConfig:
    trigger: triggers.TriggerConfig = dataclasses.field(
        default_factory=triggers.TriggerConfig)
    mix_impl: str = "dense"  # see MIX_IMPLS


def init_state(w_stack: Params, bandwidths: torch.Tensor,
               adjacency0: torch.Tensor, key: torch.Tensor,
               opt_state=None) -> EFHCState:
    return EFHCState(
        w=w_stack, w_hat=tree_map(torch.clone, w_stack),
        k=torch.zeros((), dtype=torch.int64, device=bandwidths.device),
        prev_adj=adjacency0, bandwidths=bandwidths, key=key,
        opt_state=opt_state)


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
    adj: torch.Tensor | None  # (m, m) bool physical adjacency G^(k), shared
    consensus_err: torch.Tensor  # (C,) ||W - 1 w_bar||_F^2 after the update
    comm_count: torch.Tensor  # (C, m) int32 links used per device
    deg: torch.Tensor  # (C, m) int32 physical degree per device


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
) -> tuple[EFHCState, StepAux]:
    """One universal iteration of Alg. 1 across all m devices of all C
    cells.

    ``batch`` is (x (C, m, B, ...), y (C, m, B)); ``loss_and_grad(w,
    batch) -> (loss (n,), grads)`` is the batched per-device gradient
    (``ModelSpec.loss_and_grad``), called once with the cells folded into
    n = C m devices.  ``cells`` gives each cell's trigger policy; None runs
    ``cfg.trigger.policy`` in every cell.  ``nl`` is the base graph's
    neighbor list on the run's device, required under a sparse mix_impl.
    ``opt_update`` is a ``repro_torch.optim`` update; None is plain SGD.
    ``dense_aux=False`` skips scattering the ELL slots into (m, m)
    ``comm``/``adj``/``p`` under a sparse impl (summary traces do not read
    them; the reference leaves them to dead-code elimination)."""
    if cfg.mix_impl not in MIX_IMPLS:
        raise ValueError(f"unknown mix_impl {cfg.mix_impl!r}; known: {MIX_IMPLS}")
    sparse = cfg.mix_impl in SPARSE_MIX_IMPLS
    dev_ = state.bandwidths.device
    C, m = state.bandwidths.shape
    keys = prng.split(state.key, 3)  # (C, 3, 2)
    # the third key feeds the reference's per-device gradient keys, which
    # the paper models ignore; nothing else draws from it
    key, k_trig = keys[:, 0], keys[:, 1]
    bw = state.bandwidths

    if sparse:
        if nl is None:
            raise ValueError(f"mix_impl={cfg.mix_impl!r} needs the staged "
                             f"neighbor list (nl)")
        nbr_idx = nl.idx
        adj_ell = graph.adjacency_ell(state.k, nl)
        adj = topology.scatter_ell(nbr_idx, adj_ell) if dense_aux else None
    else:
        adj = graph.adjacency(state.k, dev_)

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
    v = triggers.broadcast_events(cfg.trigger, dev=dev, bandwidths=bw,
                                  gamma_k=alpha_k, key=k_trig, cells=cells)

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

    # ---- paper metrics (Sec. IV-A), per cell ------------------------------
    deg = deg_i.float()
    used = used_i.float()
    frac = torch.where(deg > 0, used / torch.clamp(deg, min=1.0),
                       torch.zeros((), device=dev_))
    tx_time = torch.mean(frac * model_dim / bw, dim=-1)
    capacity = torch.sum(deg * bw, dim=-1)
    util = torch.sum(used * model_dim, dim=-1) / torch.clamp(capacity, min=1e-12)
    w_new_flat = flatten_stack(w_new, lead=2)
    consensus_err = torch.sum(
        (w_new_flat - w_new_flat.mean(dim=1, keepdim=True)) ** 2, dim=(1, 2))

    new_state = EFHCState(w=w_new, w_hat=w_hat_new, k=state.k + 1,
                          prev_adj=prev_adj_next, bandwidths=bw, key=key,
                          opt_state=opt_state_new)
    return new_state, StepAux(v=v, comm=comm, p=p, loss=loss, tx_time=tx_time,
                              util=util, adj=adj, consensus_err=consensus_err,
                              comm_count=used_i, deg=deg_i.expand(C, m))
