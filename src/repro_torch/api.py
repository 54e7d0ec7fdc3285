"""Public API of the port, the counterpart of ``repro.api``:

    from repro_torch import api

    res = api.simulate(api.ScenarioSpec(m=10, iters=200, r=50.0))

``simulate`` runs one scenario on the card (``device="cuda"``, the
default) or, when asked, on the CPU.  ``sweep`` and ``serve`` are not
ported yet.
"""
from __future__ import annotations

from repro_torch.fl.service import (Dataset, ScenarioSpec, SyntheticProvider,
                                    solo_run)
from repro_torch.fl.simulator import SimConfig, SimResult

__all__ = ["ScenarioSpec", "SyntheticProvider", "Dataset", "SimConfig",
           "SimResult", "simulate", "sweep", "serve"]


def simulate(spec: ScenarioSpec, *, seed: int | None = None, provider=None,
             device="cuda") -> SimResult:
    """Runs one scenario solo (single seed) on ``device``."""
    return solo_run(spec, seed=seed, provider=provider, device=device)


def sweep(spec: ScenarioSpec, **kwargs):
    raise NotImplementedError(
        "api.sweep is not ported yet (ROADMAP.md Queue 1 item 5, sweep "
        "layer); loop api.simulate over seeds meanwhile")


def serve(specs, **kwargs):
    raise NotImplementedError(
        "api.serve is not ported yet (ROADMAP.md Queue 1 item 8, scenario "
        "service)")
