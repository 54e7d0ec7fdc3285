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
with more rows than the table.
"""
from __future__ import annotations

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
