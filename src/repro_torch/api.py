"""Public API of the port, the counterpart of ``repro.api``:

    from repro_torch import api

    res = api.simulate(api.ScenarioSpec(m=10, iters=200, r=50.0))
    grid = api.sweep(api.ScenarioSpec(m=10, iters=150, r=50.0),
                     seeds=range(4))

``simulate`` runs one scenario and ``sweep`` its seeds x policies grid (one
batched run: every kernel launches once per iteration for all cells), on
the card (``device="cuda"``, the default) or, when asked, on the CPU.
``serve`` is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.accounting import TxSummary, tx_summary_from_result
from repro_torch.fl.service import (Dataset, ScenarioSpec, SyntheticProvider,
                                    solo_run, sweep_run)
from repro_torch.fl.simulator import SimConfig, SimResult
from repro_torch.fl.sweep import SweepResult, acc_per_tx_auc, policy_auc_table

__all__ = ["ScenarioSpec", "SyntheticProvider", "Dataset", "SimConfig",
           "SimResult", "SweepResult", "TxSummary", "simulate", "sweep",
           "serve", "tx_summary_from_result", "acc_per_tx_auc",
           "policy_auc_table"]


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


def serve(specs, **kwargs):
    raise NotImplementedError(
        "api.serve is not ported yet (ROADMAP.md Queue 1 item 8, scenario "
        "service)")
