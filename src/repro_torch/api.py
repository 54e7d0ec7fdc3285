"""Public API of the port, the counterpart of ``repro.api``:

    from repro_torch import api

    res = api.simulate(api.ScenarioSpec(m=10, iters=200, r=50.0))
    grid = api.sweep(api.ScenarioSpec(m=10, iters=150, r=50.0),
                     seeds=range(4))
    reports = api.serve([spec_a, spec_b, ...])  # continuous-batched

``simulate`` runs one scenario, ``sweep`` its seeds x policies grid (one
batched run: every kernel launches once per iteration for all cells) and
``serve`` a mixed request set through a ``ScenarioService`` (one batched
launch per compatible group), on the card (``device="cuda"``, the
default) or, when asked, on the CPU.  The entry points share staging
caches, so repeated calls with compatible specs reuse engines
(``engine_cache_stats``).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.accounting import TxSummary, tx_summary_from_result
from repro_torch.fl.service import (Dataset, ScenarioReport, ScenarioService,
                                    ScenarioSpec, ServiceStats, SyntheticProvider,
                                    solo_run, sweep_run)
from repro_torch.fl.simulator import (EngineCacheStats, SimConfig, SimResult,
                                      engine_cache_stats)
from repro_torch.fl.sweep import SweepResult, acc_per_tx_auc, policy_auc_table

__all__ = [
    "ScenarioSpec", "ScenarioService", "ScenarioReport", "ServiceStats",
    "SyntheticProvider", "Dataset", "SimConfig", "SimResult", "SweepResult",
    "TxSummary", "EngineCacheStats", "simulate", "sweep", "serve",
    "engine_cache_stats", "tx_summary_from_result", "acc_per_tx_auc",
    "policy_auc_table",
]


def simulate(spec: ScenarioSpec, *, seed: int | None = None, provider=None,
             device="cuda") -> SimResult:
    """Runs one scenario solo (single seed) on ``device``."""
    return solo_run(spec, seed=seed, provider=provider, device=device)


def sweep(spec: ScenarioSpec, *, seeds: Sequence[int] | None = None,
          policies: Sequence[str] | None = None, provider=None,
          device="cuda") -> SweepResult:
    """Runs the scenario's seeds x policies grid as one batched run on
    ``device``."""
    kw = {} if policies is None else {"policies": tuple(policies)}
    return sweep_run(spec, seeds=seeds, provider=provider, device=device, **kw)


def serve(specs: Sequence[ScenarioSpec], *, provider=None, max_cells: int = 16,
          service: ScenarioService | None = None,
          device="cuda") -> list[ScenarioReport]:
    """Serves a mixed request set through a ``ScenarioService`` on
    ``device`` (one batched launch per compatible group); returns the
    reports in request order.  ``service`` reuses a resident service (its
    own provider, cell budget and device)."""
    svc = service if service is not None else ScenarioService(
        provider, max_cells=max_cells, device=device)
    return svc.serve(specs)
