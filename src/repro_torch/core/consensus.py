"""Consensus application w_i <- sum_j p_ij w_j (paper Eq. 8/10), in torch.

Port of ``repro.core.consensus`` on the canonical (m, D) float32 flat
rows.  The ELL forms loop over neighbor-list slots s = 0..d_max-1 in
order and accumulate in fp32, the reference's ``_sparse_mix_flat`` order;
the (m, d_max, D) gather never exists.  ``mix_dense`` is one float32
matrix product (TF32 off on the card, as the caller sets it).

A batched run gives ``flat`` and the weights a leading cell axis,
(C, m, D) rows under P (C, m, m) or ``p_diag`` (C, m) / ``p_off``
(C, m, d_max); the neighbor table (m, d_max) is shared.  Each cell's
rows are those its solo call gives.  A shard of the sharded engine mixes
its rows from the ``[own; halo]`` buffer (``mix_sparse_halo``), a source
with more rows than the table.  ``edge_coloring`` (host numpy) cuts a
static base graph into the matchings of the train step's neighbor
schedule.
"""
from __future__ import annotations

import numpy as np
import torch


def mix_dense(p: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return p.to(flat.dtype) @ flat


def mix_delta_dense(p: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """w + (P w - w): equal to ``mix_dense`` for a stochastic P."""
    flat = flat.float()
    return flat + (p.float() @ flat - flat)


def _sparse_mix_flat(nbr_idx: torch.Tensor, p_off: torch.Tensor,
                     flat: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc + sum_s p_off[..., s] * flat[..., nbr_idx[:, s], :], slot by
    slot."""
    for s in range(nbr_idx.shape[1]):
        acc = acc + p_off[..., s:s + 1].float() * flat[..., nbr_idx[:, s], :]
    return acc


def mix_sparse(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
               p_off: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """p_ii w_i + sum_{j in N(i)} p_ij w_j over the neighbor list; p_diag
    (..., m) or (..., m, 1).  ``flat`` may hold more rows than the table
    (a shard's ``[own; halo]`` buffer): row i's self term is source row i,
    and the slots index all of them."""
    flat = flat.float()
    p_diag = p_diag.float().reshape(p_off.shape[:-1] + (1,))
    return _sparse_mix_flat(nbr_idx, p_off, flat,
                            p_diag * flat[..., :nbr_idx.shape[0], :])


def mix_sparse_halo(nbr_loc: torch.Tensor, p_diag: torch.Tensor,
                    p_off: torch.Tensor, w_local: torch.Tensor,
                    w_halo: torch.Tensor) -> torch.Tensor:
    """``mix_sparse`` for a shard of a partitioned fleet: the source is the
    ``[own rows ; halo rows]`` buffer and ``nbr_loc`` indexes it.  The
    gather-mix kernel (``kernels.mixing.ops.mix_sparse``) takes it on the
    card, the plain slot loop on the CPU: both sum the slots in order over
    bit-identical row values, so the mixed rows are the single-device
    engine's bit for bit."""
    from repro_torch.kernels.mixing import ops  # its plain version imports this module

    return ops.mix_sparse(nbr_loc, p_diag, p_off,
                          torch.cat([w_local.float(), w_halo.float()], dim=-2))


def mix_delta_sparse(nbr_idx: torch.Tensor, p_off: torch.Tensor,
                     flat: torch.Tensor) -> torch.Tensor:
    """w_i + sum_j p_ij (w_j - w_i); needs only the off-diagonal slots."""
    flat = flat.float()
    delta = torch.zeros_like(flat)
    for s in range(nbr_idx.shape[1]):
        delta = delta + p_off[..., s:s + 1].float() * (flat[..., nbr_idx[:, s], :] - flat)
    return flat + delta


def edge_coloring(adjacency) -> list[list[tuple[int, int]]]:
    """Misra-Gries proper edge coloring of the static base graph: returns
    rounds of vertex-disjoint edges (matchings) that partition the edge set,
    using at most maxdeg + 1 colors (Vizing's bound, which this algorithm
    *guarantees* -- a greedy first-fit can need up to 2*maxdeg - 1).  Each
    round is one pairwise swap of the replicas in
    ``launch.steps.neighbor_slots``.

    Accepts the canonical ``topology.EdgeList`` (the staging-native form --
    edges and maxdeg read off directly, no O(m^2) dense scan) or a dense
    symmetric adjacency (legacy input)."""
    from repro_torch.core.topology import EdgeList

    if isinstance(adjacency, EdgeList):
        m = adjacency.m
        edges = list(zip(adjacency.u.tolist(), adjacency.v.tolist()))
        maxdeg = (int(np.bincount(np.concatenate([adjacency.u, adjacency.v]), minlength=m).max())
                  if edges else 0)
    else:
        adjacency = np.asarray(adjacency, bool)
        m = adjacency.shape[0]
        edges = [(i, j) for i in range(m) for j in range(i + 1, m) if adjacency[i, j]]
        maxdeg = int(adjacency.sum(1).max()) if edges else 0
    if not edges:
        return []
    ncolors = maxdeg + 1
    # incident[x][c] = the neighbor reached from x over the c-colored edge
    incident: list[dict[int, int]] = [{} for _ in range(m)]
    color: dict[frozenset, int] = {}

    def free(x: int) -> int:
        return next(c for c in range(ncolors) if c not in incident[x])

    def assign(a: int, b: int, c: int) -> None:
        e = frozenset((a, b))
        old = color.get(e)
        if old is not None:
            del incident[a][old], incident[b][old]
        color[e] = c
        incident[a][c] = b
        incident[b][c] = a

    def unassign(a: int, b: int) -> None:
        old = color.pop(frozenset((a, b)))
        del incident[a][old], incident[b][old]

    for (u, v) in edges:
        # maximal fan of u starting at v: each next edge (u, f) is colored
        # with a color free on the previous fan vertex
        fan = [v]
        in_fan = {v}
        grew = True
        while grew:
            grew = False
            for c, w in incident[u].items():
                if w not in in_fan and c not in incident[fan[-1]]:
                    fan.append(w)
                    in_fan.add(w)
                    grew = True
                    break
        c = free(u)
        d = free(fan[-1])
        if c != d:
            # invert the maximal cd-path starting at u (first edge colored d)
            path, x, want = [], u, d
            while want in incident[x]:
                y = incident[x][want]
                path.append((x, y))
                x, want = y, (c if want == d else d)
            for a, b in path:
                unassign(a, b)
            for i, (a, b) in enumerate(path):
                assign(a, b, c if i % 2 == 0 else d)
        # shortest fan prefix [v .. w] that is still a fan with d free on w
        w_end = next(i for i, f in enumerate(fan) if d not in incident[f]
                     and all(color[frozenset((u, fan[j + 1]))] not in incident[fan[j]]
                             for j in range(i)))
        # rotate: shift each fan edge's color back one vertex, color (u,w)=d
        # (snapshot + unassign first: in-place shifting would momentarily
        # give two edges at u the same color and corrupt ``incident``)
        shifted = [color[frozenset((u, fan[i + 1]))] for i in range(w_end)]
        for i in range(w_end):
            unassign(u, fan[i + 1])
        for i in range(w_end):
            assign(u, fan[i], shifted[i])
        assign(u, fan[w_end], d)

    rounds: list[list[tuple[int, int]]] = [[] for _ in range(ncolors)]
    for e, c in color.items():
        a, b = sorted(e)
        rounds[c].append((a, b))
    return [r for r in rounds if r]
