"""Resource dynamics: churn, stragglers, budgets, time-varying bandwidth.

Port of ``repro.core.resources``.  The trigger is personalized by
resources -- threshold r * rho_i * gamma^(k) with rho_i = 1 / b_i -- and
this process evolves each device's resources inside the run:

* time-varying bandwidth b_i^(k): a mean-reverting log-space random walk
  around the sampled b_i, feeding Event-2 thresholds live;
* depleting byte budgets: each realized broadcast debits
  ``accounting.model_bytes(model_dim)``; an exhausted device sees its
  threshold bandwidth clamped to ``EXHAUSTED_BW_FRAC`` of b_i (rho
  explodes, EF-HC goes quiet) and is hard-masked from firing;
* device churn: a down device neither fires nor mixes (its incident edges
  leave G^(k) for Events 1-3);
* stragglers: a straggling device skips its Event-4 local update.

The stream derives from each cell's root key ``PRNGKey(seed)`` by
``fold_in`` (``resource_key``) and never touches the engine's own splits.
Draws are positional (m,) arrays, sliced by ``rows`` where given.  State
tensors lead with the cell axis: (C, m) per cell, key (C, 2).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.triggers import BW_FLOOR_FRAC

# bandwidth fraction an exhausted device's *threshold* sees; tx/util
# metrics keep the live bandwidth (receiving is not metered)
EXHAUSTED_BW_FRAC = 1e-6

# fold_in salt separating the resource stream from every engine stream
_STREAM_SALT = 0x7E50


@dataclasses.dataclass(frozen=True)
class ResourceConfig:
    """Static knobs of the per-device resource process; all defaults mean
    disabled (``enabled`` False) and the step takes the plain path."""

    churn_rate: float = 0.0  # P(up device goes down) per iteration
    recover_rate: float = 0.5  # P(down device comes back up) per iteration
    straggle_rate: float = 0.0  # P(device delays its Event-4 update)
    bw_walk: float = 0.0  # log-space random-walk std per iteration
    bw_revert: float = 0.1  # mean-reversion rate toward the sampled b_i
    budget_bytes: float = 0.0  # per-device broadcast budget; 0 = unlimited
    seed: int = 0  # resource-stream offset (folded into the key)

    def __post_init__(self):
        for name in ("churn_rate", "recover_rate", "straggle_rate"):
            val = getattr(self, name)
            if not 0.0 <= val <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]; got {name}={val}")
        if not 0.0 <= self.bw_revert <= 1.0:
            raise ValueError(
                f"bw_revert must be in [0, 1]; got bw_revert={self.bw_revert}")
        if self.bw_walk < 0.0:
            raise ValueError(f"bw_walk must be >= 0; got bw_walk={self.bw_walk}")
        if self.budget_bytes < 0.0:
            raise ValueError(
                f"budget_bytes must be >= 0 (0 disables the budget); got "
                f"budget_bytes={self.budget_bytes}")

    @property
    def enabled(self) -> bool:
        return (self.churn_rate > 0.0 or self.straggle_rate > 0.0
                or self.bw_walk > 0.0 or self.budget_bytes > 0.0)


class ResourceState(NamedTuple):
    """Per-device resource state, each leaf with a leading cell axis."""

    bw: torch.Tensor  # (C, m) float32 live bandwidth b_i^(k)
    budget: torch.Tensor  # (C, m) float32 remaining bytes (inf = none)
    up: torch.Tensor  # (C, m) bool device liveness
    key: torch.Tensor  # (C, 2) resource PRNG stream


def resource_key(key: torch.Tensor, cfg: ResourceConfig) -> torch.Tensor:
    """The resource stream of root key(s) ``key`` (..., 2)."""
    return prng.fold_in(prng.fold_in(key, _STREAM_SALT),
                        int(cfg.seed) & 0x7FFFFFFF)


def init_state(cfg: ResourceConfig, bw0: torch.Tensor,
               key: torch.Tensor) -> ResourceState:
    budget0 = float(cfg.budget_bytes) if cfg.budget_bytes > 0 else float("inf")
    return ResourceState(
        bw=bw0.float().clone(),
        budget=torch.full(bw0.shape, budget0, dtype=torch.float32,
                          device=bw0.device),
        up=torch.ones(bw0.shape, dtype=torch.bool, device=bw0.device),
        key=key)


def evolve(cfg: ResourceConfig, key: torch.Tensor, up: torch.Tensor,
           bw: torch.Tensor, bw0: torch.Tensor, m: int,
           rows: torch.Tensor | None = None):
    """One step of churn + straggle + bandwidth walk for key(s) ``key``
    (..., 2): each draw is an (m,) array per key, sliced by ``rows`` along
    its last axis.  ``bw0`` is the sampled bandwidth the walk reverts to.
    Returns ``(up_new, straggle, bw_new)`` with the shapes of ``up``."""
    ks = prng.split(key, 3)
    k_churn, k_straggle, k_walk = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]

    def take(a):
        return a if rows is None else a[..., rows]

    if cfg.churn_rate > 0.0:
        u = take(prng.uniform(k_churn, (m,)))
        up_new = torch.where(up, u >= cfg.churn_rate, u < cfg.recover_rate)
    else:
        up_new = up
    if cfg.straggle_rate > 0.0:
        straggle = take(prng.uniform(k_straggle, (m,))) < cfg.straggle_rate
    else:
        straggle = torch.zeros_like(up)
    if cfg.bw_walk > 0.0:
        eps = take(prng.normal(k_walk, (m,)))
        log_ratio = torch.log(torch.clamp(bw, min=1e-20) / bw0)
        log_ratio = (1.0 - cfg.bw_revert) * log_ratio + cfg.bw_walk * eps
        bw_new = torch.maximum(bw0 * torch.exp(log_ratio), BW_FLOOR_FRAC * bw0)
    else:
        bw_new = bw
    return up_new, straggle, bw_new


def exhausted_mask(cfg: ResourceConfig, budget: torch.Tensor) -> torch.Tensor:
    """True where the broadcast budget ran out (never while the budget is
    disabled: the state carries +inf there)."""
    if cfg.budget_bytes > 0.0:
        return budget <= 0.0
    return torch.zeros(budget.shape, dtype=torch.bool, device=budget.device)
