"""EF-HC: the four-event algorithm (paper Alg. 1) as one step on tensors.

Port of ``repro.core.efhc.step`` with resource dynamics, fault injection
and the watchdog off.  Per device i the state keeps the main model w_i and
the auxiliary (last broadcast) model w_hat_i, plus the iteration k, the
previous adjacency (Event-1 detection), bandwidths b_i and the PRNG key.

``step`` is a pure function of its state: it reads tensors, allocates new
ones and never syncs with the host, so the simulator's Python loop over it
stays on the device.  Events 1-3 run on the canonical (m, D) flat rows
(``flatten_stack``); Event-4 local SGD runs on the parameter dict.

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

MIX_IMPLS: tuple[str, ...] = ("dense", "delta", "pallas",
                              "sparse", "sparse_delta", "sparse_pallas")
SPARSE_MIX_IMPLS: tuple[str, ...] = ("sparse", "sparse_delta", "sparse_pallas")

Params = dict[str, torch.Tensor]


class EFHCState(NamedTuple):
    w: Params  # leaves (m, ...): per-device main models
    w_hat: Params  # leaves (m, ...): last-broadcast models
    k: torch.Tensor  # () int64 universal iteration
    # G^(k-1) for Event-1 detection: (m, m) bool, or the (m, d_max) ELL
    # slot mask under a sparse mix_impl
    prev_adj: torch.Tensor
    bandwidths: torch.Tensor  # (m,) float32
    key: torch.Tensor  # (2,) int64 threefry key words
    opt_state: Any = None


@dataclasses.dataclass(frozen=True)
class EFHCConfig:
    trigger: triggers.TriggerConfig = dataclasses.field(
        default_factory=triggers.TriggerConfig)
    mix_impl: str = "dense"  # see MIX_IMPLS


def init_state(w_stack: Params, bandwidths: torch.Tensor,
               adjacency0: torch.Tensor, key: torch.Tensor,
               opt_state=None) -> EFHCState:
    return EFHCState(
        w=w_stack, w_hat={n: t.clone() for n, t in w_stack.items()},
        k=torch.zeros((), dtype=torch.int64, device=bandwidths.device),
        prev_adj=adjacency0, bandwidths=bandwidths, key=key,
        opt_state=opt_state)


def flatten_stack(w_stack: Params) -> torch.Tensor:
    """Canonical (m, D) float32 rows: leaves concatenated in sorted-key
    order (``jax.tree.leaves`` order of the reference)."""
    leaves = [w_stack[n] for n in sorted(w_stack)]
    m = leaves[0].shape[0]
    return torch.cat([t.reshape(m, -1).float() for t in leaves], dim=1)


def unflatten_stack(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of ``flatten_stack``: slice the rows back into ``like``'s
    leaves, shapes and dtypes (views of ``flat`` for float32 leaves)."""
    out, col = {}, 0
    for n in sorted(like):
        leaf = like[n]
        width = leaf[0].numel()
        out[n] = flat[:, col:col + width].reshape(leaf.shape).to(leaf.dtype)
        col += width
    return out


class StepAux(NamedTuple):
    """Per-iteration outputs (the paper's plot channels)."""

    v: torch.Tensor  # (m,) bool broadcast events fired
    comm: torch.Tensor | None  # (m, m) bool links used (dense impls, or
    # scattered from ELL when ``dense_aux``)
    p: torch.Tensor | None  # (m, m) transition matrix (same rule)
    loss: torch.Tensor  # (m,) per-device minibatch loss
    tx_time: torch.Tensor  # () avg transmission time this iteration
    util: torch.Tensor  # () resource utilization
    adj: torch.Tensor | None  # (m, m) bool physical adjacency G^(k)
    consensus_err: torch.Tensor  # () ||W - 1 w_bar||_F^2 after the update
    comm_count: torch.Tensor  # (m,) int32 links used per device
    deg: torch.Tensor  # (m,) int32 physical degree per device


def step(
    cfg: EFHCConfig,
    graph: topology.GraphProcess,
    state: EFHCState,
    *,
    loss_and_grad: Callable[[Params, Any], tuple[torch.Tensor, Params]],
    batch,
    alpha_k: torch.Tensor,
    model_dim: int,
    nl: topology.StagedNeighbors | None = None,
    opt_update: Callable | None = None,
    dense_aux: bool = True,
) -> tuple[EFHCState, StepAux]:
    """One universal iteration of Alg. 1 across all m devices.

    ``loss_and_grad(w, batch) -> (loss (m,), grads)`` is the batched
    per-device gradient (``ModelSpec.loss_and_grad``).  ``nl`` is the base
    graph's neighbor list on the run's device, required under a sparse
    mix_impl.  ``opt_update`` is a ``repro_torch.optim`` update; None is
    plain SGD.  ``dense_aux=False`` skips scattering the ELL slots into
    (m, m) ``comm``/``adj``/``p`` under a sparse impl (summary traces do
    not read them; the reference leaves them to dead-code elimination)."""
    if cfg.mix_impl not in MIX_IMPLS:
        raise ValueError(f"unknown mix_impl {cfg.mix_impl!r}; known: {MIX_IMPLS}")
    sparse = cfg.mix_impl in SPARSE_MIX_IMPLS
    dev_ = state.bandwidths.device
    m = state.bandwidths.shape[0]
    keys = prng.split(state.key, 3)
    # the third key feeds the reference's per-device gradient keys, which
    # the paper models ignore; nothing else draws from it
    key, k_trig = keys[0], keys[1]
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
    w_flat = flatten_stack(state.w)
    w_hat_flat = flatten_stack(state.w_hat)
    if cfg.mix_impl == "pallas":
        sq = trigger_ops.trigger_sq(w_flat, w_hat_flat)
        dev = torch.sqrt(sq / w_flat.shape[1])
    else:
        dev = triggers.rms_deviation(w_flat, w_hat_flat)
    v = triggers.broadcast_events(cfg.trigger, dev=dev, bandwidths=bw,
                                  gamma_k=alpha_k, key=k_trig)

    # ---- Events 1 + 3: new links, information-flow edges, mixing ---------
    if sparse:
        new_links_ell = torch.logical_and(adj_ell, ~state.prev_adj)
        vv_ell = torch.logical_or(v[:, None], v[nbr_idx])
        comm_ell = torch.logical_or(torch.logical_and(vv_ell, adj_ell),
                                    new_links_ell)
        p_diag, p_off = mixing.build_p_ell(nbr_idx, adj_ell, comm_ell)
        if cfg.mix_impl == "sparse_pallas":
            w_mixed_flat = mixing_ops.mix_sparse(nbr_idx, p_diag, p_off, w_flat)
        elif cfg.mix_impl == "sparse_delta":
            w_mixed_flat = consensus.mix_delta_sparse(nbr_idx, p_off, w_flat)
        else:
            w_mixed_flat = consensus.mix_sparse(nbr_idx, p_diag, p_off, w_flat)
        if dense_aux:
            comm = topology.scatter_ell(nbr_idx, comm_ell)
            p = topology.scatter_ell(nbr_idx, p_off) + torch.diag(p_diag)
        else:
            comm = p = None
        used_i = comm_ell.sum(dim=1, dtype=torch.int32)
        deg_i = adj_ell.sum(dim=1, dtype=torch.int32)
        prev_adj_next = adj_ell
    else:
        new_links = torch.logical_and(adj, ~state.prev_adj)
        comm = torch.logical_or(triggers.communication_matrix(v, adj), new_links)
        p = mixing.build_p(adj, comm)
        if cfg.mix_impl == "pallas":
            w_mixed_flat = mixing_ops.mix(p, w_flat)
        elif cfg.mix_impl == "delta":
            w_mixed_flat = consensus.mix_delta_dense(p, w_flat)
        else:
            w_mixed_flat = consensus.mix_dense(p, w_flat)
        used_i = comm.sum(dim=1, dtype=torch.int32)
        deg_i = adj.sum(dim=1, dtype=torch.int32)
        prev_adj_next = adj

    # w_hat update: broadcasting devices snapshot their pre-mix model
    # (Alg. 1 line 12: w_hat^(k+1) = w^(k))
    w_hat_new = {}
    for n, h in state.w_hat.items():
        mask = v.reshape((m,) + (1,) * (h.dim() - 1))
        w_hat_new[n] = torch.where(mask, state.w[n], h)

    # ---- Event 4: local SGD on the parameter dict ------------------------
    w_mixed = unflatten_stack(w_mixed_flat, state.w)
    loss, grads = loss_and_grad(w_mixed, batch)
    if opt_update is None:
        w_new = {n: (wm.float() - alpha_k * grads[n].float()).to(wm.dtype)
                 for n, wm in w_mixed.items()}
        opt_state_new = state.opt_state
    else:
        w_new, opt_state_new = opt_update(grads, state.opt_state, w_mixed, alpha_k)

    # ---- paper metrics (Sec. IV-A) ----------------------------------------
    deg = deg_i.float()
    used = used_i.float()
    frac = torch.where(deg > 0, used / torch.clamp(deg, min=1.0),
                       torch.zeros((), device=dev_))
    tx_time = torch.mean(frac * model_dim / bw)
    capacity = torch.sum(deg * bw)
    util = torch.sum(used * model_dim) / torch.clamp(capacity, min=1e-12)
    w_new_flat = flatten_stack(w_new)
    consensus_err = torch.sum((w_new_flat - w_new_flat.mean(0)) ** 2)

    new_state = EFHCState(w=w_new, w_hat=w_hat_new, k=state.k + 1,
                          prev_adj=prev_adj_next, bandwidths=bw, key=key,
                          opt_state=opt_state_new)
    return new_state, StepAux(v=v, comm=comm, p=p, loss=loss, tx_time=tx_time,
                              util=util, adj=adj, consensus_err=consensus_err,
                              comm_count=used_i, deg=deg_i)
