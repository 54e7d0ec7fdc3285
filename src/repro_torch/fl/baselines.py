"""Baseline runners (paper Sec. IV-B): ZT, GT, RG vs EF-HC.

Port of ``repro.fl.baselines``.  ``compare`` runs all four policies on
identical data/graph/seed and returns {policy: SimResult} for the
benchmark figures: one batched engine call with the policies as its cells
(``repro_torch.fl.sweep``).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.topology import GraphProcess
from repro_torch.data.loader import FederatedBatches
from repro_torch.fl.simulator import SimConfig, SimResult
from repro_torch.fl.sweep import run_sweep

POLICIES = {
    "EF-HC": "efhc",
    "GT": "global",
    "ZT": "zero",
    "RG": "gossip",
}


def compare(
    sim: SimConfig,
    graph: GraphProcess,
    batches_factory: Callable[[], FederatedBatches],
    eval_fn,
    *,
    policies: dict[str, str] | None = None,
    eval_every: int = 10,
    engine: str = "scan",
    device="cuda",
) -> dict[str, SimResult]:
    if engine != "scan":
        raise NotImplementedError(
            f"engine={engine!r} is not ported (ROADMAP.md Queue 1 item 10 "
            f"brings the python engine); use engine='scan'")
    table = policies or POLICIES
    res = run_sweep(
        sim, graph, lambda _seed: batches_factory(), eval_fn,
        seeds=(sim.seed,), policies=tuple(table.values()),
        eval_every=eval_every, device=device)
    return {name: res.result(sim.seed, pol) for name, pol in table.items()}
