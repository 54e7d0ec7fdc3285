"""Event-trigger policies (paper Sec. II-B, Event 2; Sec. IV-B baselines).

Port of ``repro.core.triggers``.  Device i broadcasts when

    (1/n)^(1/2) * || w_i - w_hat_i ||_2  >  r * rho_i * gamma^(k)      (3)

(strict, Eq. 7) with rho_i = 1 / b_i for EF-HC, 1 / b_M for the global
threshold (GT), zero for ZT; randomized gossip (RG) fires with
probability 1/m from the step's trigger key.

A batched run carries a leading cell axis (``dev``, ``bandwidths`` (C, m),
one trigger key per cell (C, 2)), and each cell has its own policy
(``CellPolicies``): every policy some cell runs is evaluated over all
cells and selected per cell, as the reference's ``lax.switch`` over
``policy_branches`` becomes a select under ``vmap``.  So a cell draws its
gossip uniforms from its own key, exactly as its solo run does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import prng

# canonical policy order, shared with the reference's dispatch table
POLICIES: tuple[str, ...] = ("efhc", "zero", "global", "gossip")
POLICY_INDEX: dict[str, int] = {name: i for i, name in enumerate(POLICIES)}


def policy_index(policy: str) -> int:
    if policy not in POLICY_INDEX:
        raise ValueError(f"unknown trigger policy {policy!r}; known: {POLICIES}")
    return POLICY_INDEX[policy]


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    policy: str = "efhc"  # efhc | zero | global | gossip
    r: float = 50.0  # paper: r = b_M * 1e-2 for FMNIST
    b_mean: float = 5000.0  # b_M
    gossip_p: Optional[float] = None  # defaults to 1/m


def rms_deviation(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """(1/n)^(1/2) ||w - w_hat||_2 per row of the flat (m, n) view."""
    n = w.shape[-1]
    diff = (w - w_hat).float()
    return torch.sqrt(torch.sum(diff * diff, dim=-1) / n)


def thresholds(cfg: TriggerConfig, bandwidths: torch.Tensor,
               gamma_k: torch.Tensor) -> torch.Tensor:
    """Per-device threshold ``(r * rho_i) * gamma_k``, in that order (the
    reference's operation order; another order can move a device across
    its threshold)."""
    if cfg.policy == "efhc":
        rho = 1.0 / bandwidths
    elif cfg.policy == "global":
        rho = torch.full_like(bandwidths, 1.0 / cfg.b_mean)
    elif cfg.policy in ("zero", "gossip"):
        rho = torch.zeros_like(bandwidths)
    else:
        raise ValueError(f"unknown trigger policy {cfg.policy}")
    return cfg.r * rho * gamma_k


def policy_branches(cfg: TriggerConfig):
    """The four policies as ``f(dev, bandwidths, gamma_k, key) -> v`` in
    ``POLICIES`` order."""

    def _threshold_policy(policy: str):
        pcfg = dataclasses.replace(cfg, policy=policy)

        def fire(dev, bandwidths, gamma_k, key):
            return dev > thresholds(pcfg, bandwidths, gamma_k)  # strict: Eq. 7

        return fire

    def zero(dev, bandwidths, gamma_k, key):
        return torch.ones(bandwidths.shape, dtype=torch.bool,
                          device=bandwidths.device)

    def gossip(dev, bandwidths, gamma_k, key):
        # key (..., 2): one (m,) draw per key, as each solo run draws it
        m = bandwidths.shape[-1]
        p = cfg.gossip_p if cfg.gossip_p is not None else 1.0 / m
        return prng.uniform(key, (m,)) < p

    return (_threshold_policy("efhc"), zero, _threshold_policy("global"), gossip)


def policy_branches_rows(cfg: TriggerConfig, m: int, rows: torch.Tensor):
    """``policy_branches`` for the rows ``rows`` of an m-device fleet (a
    shard's owned devices): the threshold policies are elementwise, and
    gossip draws the whole fleet's (m,) uniform and takes the owned
    positions, so v is the single-device engine's at every shard count."""
    efhc, zero, glob, _ = policy_branches(cfg)

    def gossip(dev, bandwidths, gamma_k, key):
        p = cfg.gossip_p if cfg.gossip_p is not None else 1.0 / m
        return prng.uniform(key, (m,))[rows] < p

    return (efhc, zero, glob, gossip)


class CellPolicies(NamedTuple):
    """The trigger policy of each cell of a batched run: the names on the
    host and their ``POLICIES`` indices as a (C,) tensor on the run's
    device, made once per run so that a step copies nothing to the card."""

    names: tuple[str, ...]
    idx: torch.Tensor

    @classmethod
    def of(cls, names: Sequence[str], device) -> "CellPolicies":
        names = tuple(names)
        return cls(names, torch.tensor([policy_index(n) for n in names],
                                       dtype=torch.int64, device=device))


def broadcast_events(cfg: TriggerConfig, *, dev: torch.Tensor,
                     bandwidths: torch.Tensor, gamma_k: torch.Tensor,
                     key: torch.Tensor,
                     cells: CellPolicies | None = None) -> torch.Tensor:
    """v_i^(k) in {0, 1}: under ``cfg.policy`` (static dispatch), or with
    ``cells`` under each cell's own policy (``dev``, ``bandwidths`` (C, m),
    ``key`` (C, 2)); a policy no cell runs is not evaluated."""
    branches = policy_branches(cfg)
    if cells is None:
        return branches[policy_index(cfg.policy)](dev, bandwidths, gamma_k, key)
    present = sorted({policy_index(n) for n in cells.names})
    v = branches[present[0]](dev, bandwidths, gamma_k, key)
    for p in present[1:]:
        v = torch.where((cells.idx == p)[:, None],
                        branches[p](dev, bandwidths, gamma_k, key), v)
    return v


def communication_matrix(v: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    """v_ij = max{v_i, v_j} on the edges of G^(k) (Eq. 7): v (..., m) over
    a shared (m, m) adjacency -> (..., m, m) bool."""
    return torch.logical_and(
        torch.logical_or(v[..., :, None], v[..., None, :]), adjacency)


# smallest bandwidth any sampler may emit, as a fraction of b_mean
BW_FLOOR_FRAC = 1e-3


def check_sigma_n(sigma_n: float) -> float:
    if not 0.0 <= sigma_n < 1.0:
        raise ValueError(
            f"sigma_n must be in [0, 1) -- sigma_n=1 collapses the lower "
            f"bandwidth bound to 0, exploding 1/b_i thresholds; got "
            f"sigma_n={sigma_n}")
    return sigma_n


def sample_bandwidths(key: torch.Tensor, m: int, b_mean: float = 5000.0,
                      sigma_n: float = 0.9) -> torch.Tensor:
    """b_i ~ U((1-sigma_N) b_M, (1+sigma_N) b_M), the lower bound clamped
    to ``BW_FLOOR_FRAC * b_mean`` (paper Sec. IV-A)."""
    check_sigma_n(sigma_n)
    lo = max((1.0 - sigma_n) * b_mean, BW_FLOOR_FRAC * b_mean)
    hi = (1.0 + sigma_n) * b_mean
    return prng.uniform(key, (m,), lo, hi)
