"""Consensus application w_i <- sum_j p_ij w_j (paper Eq. 8/10), in torch.

Port of ``repro.core.consensus`` on the canonical (m, D) float32 flat
rows.  The ELL forms loop over neighbor-list slots s = 0..d_max-1 in
order and accumulate in fp32, the reference's ``_sparse_mix_flat`` order;
the (m, d_max, D) gather never exists.  ``mix_dense`` is one float32
matrix product (TF32 off on the card, as the caller sets it).
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
    """acc + sum_s p_off[:, s] * flat[nbr_idx[:, s]], slot by slot."""
    for s in range(nbr_idx.shape[1]):
        acc = acc + p_off[:, s:s + 1].float() * flat[nbr_idx[:, s]]
    return acc


def mix_sparse(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
               p_off: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """p_ii w_i + sum_{j in N(i)} p_ij w_j over the neighbor list."""
    flat = flat.float()
    return _sparse_mix_flat(nbr_idx, p_off, flat,
                            p_diag.float().reshape(-1, 1) * flat)


def mix_delta_sparse(nbr_idx: torch.Tensor, p_off: torch.Tensor,
                     flat: torch.Tensor) -> torch.Tensor:
    """w_i + sum_j p_ij (w_j - w_i); needs only the off-diagonal slots."""
    flat = flat.float()
    delta = torch.zeros_like(flat)
    for s in range(nbr_idx.shape[1]):
        delta = delta + p_off[:, s:s + 1].float() * (flat[nbr_idx[:, s]] - flat)
    return flat + delta
