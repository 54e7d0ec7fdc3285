"""Metropolis mixing weights (paper Sec. II-C, Eq. 9/19), in torch.

Port of ``repro.core.mixing``:

    beta_ij = min{ 1/(1 + d_i), 1/(1 + d_j) }     on edges of G^(k)   (19)
    p_ij    = beta_ij * v_ij  (i != j),   p_ii = 1 - sum_j p_ij          (9)

in the dense (m, m) layout and in the padded neighbor-list (ELL) layout
the m >= 4096 path uses.  P is symmetric and doubly stochastic
(Assumption 2); the ``assert_*`` checks are host numpy.

A batched run gives ``comm`` (and may give the adjacency) a leading cell
axis: (C, m, m) dense, (C, m, d_max) ELL.  The graph realization is shared
by the cells, so the Metropolis weights are computed once for all of
them, and each cell's P is the one its solo run builds.
"""
from __future__ import annotations

import numpy as np
import torch


def metropolis_weights(adjacency: torch.Tensor) -> torch.Tensor:
    a = adjacency.float()
    inv = 1.0 / (1.0 + a.sum(dim=-1))
    return torch.minimum(inv[..., :, None], inv[..., None, :]) * a


def transition_matrix(beta: torch.Tensor, comm: torch.Tensor) -> torch.Tensor:
    off = beta * comm.to(beta.dtype)
    return off + torch.diag_embed(1.0 - off.sum(dim=-1))


def build_p(adjacency: torch.Tensor, comm: torch.Tensor) -> torch.Tensor:
    return transition_matrix(metropolis_weights(adjacency), comm)


def metropolis_weights_ell(nbr_idx: torch.Tensor, adj_ell: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / (1.0 + adj_ell.sum(dim=-1).float())
    return torch.minimum(inv[..., :, None], inv[..., nbr_idx]) * adj_ell.float()


def transition_ell(beta_ell: torch.Tensor, comm_ell: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(p_diag (..., m), p_off (..., m, d_max))``."""
    off = beta_ell * comm_ell.to(beta_ell.dtype)
    return 1.0 - off.sum(dim=-1), off


def build_p_ell(nbr_idx: torch.Tensor, adj_ell: torch.Tensor,
                comm_ell: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return transition_ell(metropolis_weights_ell(nbr_idx, adj_ell), comm_ell)


def metropolis_weights_ell_halo(nbr_loc: torch.Tensor, adj_ell: torch.Tensor,
                                deg_buf: torch.Tensor) -> torch.Tensor:
    """``metropolis_weights_ell`` for a shard's rows: ``nbr_loc`` (ms,
    d_max) indexes the ``[own rows ; halo rows]`` buffer and ``deg_buf``
    holds that buffer's int degrees (the halo's computed on their owners,
    as here).  ``1/(1+deg)`` and the slot-wise min are elementwise, so
    beta is bit-equal to the single-device rows."""
    inv = 1.0 / (1.0 + deg_buf.float())
    ms = adj_ell.shape[0]
    return torch.minimum(inv[:ms, None], inv[nbr_loc]) * adj_ell.float()


def build_p_ell_halo(nbr_loc: torch.Tensor, adj_ell: torch.Tensor,
                     comm_ell: torch.Tensor, deg_buf: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return transition_ell(metropolis_weights_ell_halo(nbr_loc, adj_ell, deg_buf),
                          comm_ell)


def assert_doubly_stochastic(p, atol: float = 1e-6) -> None:
    p = np.asarray(torch.as_tensor(p).cpu())
    assert np.all(p >= -atol), f"negative entries: min {p.min()}"
    assert np.allclose(p.sum(axis=0), 1.0, atol=atol), "columns not stochastic"
    assert np.allclose(p.sum(axis=1), 1.0, atol=atol), "rows not stochastic"
    assert np.allclose(p, p.T, atol=atol), "not symmetric"


def assert_doubly_stochastic_ell(nbr_idx, p_diag, p_off, atol: float = 1e-6) -> None:
    """The Assumption-2 invariants checked in ELL layout, O(m d): rows sum
    to one, entries are nonnegative, and the weight on slot (i, s) equals
    the weight j = idx[i, s] holds for i on its reciprocal slot."""
    idx = np.asarray(torch.as_tensor(nbr_idx).cpu())
    pd = np.asarray(torch.as_tensor(p_diag).cpu(), np.float64)
    po = np.asarray(torch.as_tensor(p_off).cpu(), np.float64)
    m, d_max = idx.shape
    assert np.all(po >= -atol), f"negative off-diagonal entries: min {po.min()}"
    assert np.all(pd >= -atol), f"negative diagonal entries: min {pd.min()}"
    assert np.allclose(pd + po.sum(axis=-1), 1.0, atol=atol), "rows not stochastic"
    rows = np.arange(m)
    active = idx != rows[:, None]  # pad slots self-index, carry zero weight
    w_back = np.zeros_like(po)
    has_back = np.zeros(po.shape, dtype=bool)
    for s in range(d_max):
        back = idx[idx[:, s]] == rows[:, None]  # slots of j pointing at i
        has_back[:, s] = back.any(axis=-1)
        w_back[:, s] = np.where(back, po[idx[:, s]], 0.0).sum(axis=-1)
    assert np.all(has_back[active] | (po[active] <= atol)), \
        "active slot with no reciprocal slot"
    np.testing.assert_allclose(np.where(active, po, 0.0),
                               np.where(active, w_back, 0.0), atol=atol,
                               err_msg="ELL P not symmetric")
