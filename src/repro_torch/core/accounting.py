"""Communication-savings accounting for event-triggered consensus (host
numpy on ``SimResult``s; the port's copy of ``repro.core.accounting``).

Under one SPMD program the consensus collective executes every step with
P = I when no event fires (DESIGN.md "Event semantics under SPMD"), so the
*compiled* program cannot show the savings.  This module quantifies them
from the trigger trace, closing the loop between the paper's event
semantics and the framework's static schedules:

  * dense schedule  - every device moves its full model through the fl-axis
    collective each mixing round: bytes_dense = n_bytes * m (all-gather
    class) regardless of v.
  * event schedule  - only links with v_ij = 1 carry parameters:
    bytes_event(k) = n_bytes * sum_ij v_ij(k) / m per device on average.
  * every-K static schedule - the compiled-savings alternative: collective
    appears in 1 of K steps; bytes = n_bytes * m / K.

``savings_report`` returns per-step and cumulative bytes for all three,
plus the paper's transmission-time metric under heterogeneous bandwidths.

``n_bytes`` is the *realized* per-broadcast payload: the ModelSpec
``flat_dim`` (exact parameter count of the stacked pytree -- the width of
the (m, D) flat view Event 2 actually ships) times the element size.  Use
``report_from_result`` to derive it from a ``SimResult`` instead of
hand-computing a config-level scalar: ``SimResult.model_dim`` carries the
engine's realized flat_dim, so a 2-layer model is charged 2-layer bytes,
never an input-dim-derived guess.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SavingsReport:
    steps: int
    m: int
    n_bytes: int
    dense_bytes: float  # cumulative, per device average
    event_bytes: float
    every_k_bytes: float
    every_k: int
    trigger_rate: float
    link_utilization: float  # used links / physical links
    tx_time_event: float  # paper Sec. IV metric, cumulative
    tx_time_dense: float

    @property
    def event_vs_dense(self) -> float:
        return self.event_bytes / max(self.dense_bytes, 1e-30)

    def summary(self) -> str:
        return (
            f"m={self.m} steps={self.steps} model={self.n_bytes/1e6:.1f}MB | "
            f"dense {self.dense_bytes/1e9:.2f}GB vs event {self.event_bytes/1e9:.2f}GB "
            f"({100*self.event_vs_dense:.1f}%) vs every-{self.every_k} "
            f"{self.every_k_bytes/1e9:.2f}GB | trigger_rate {self.trigger_rate:.2f}")


def savings_report(
    v_trace: np.ndarray,  # (T, m) broadcast events
    adj_trace: np.ndarray,  # (T, m, m) physical graphs
    n_bytes: int,
    bandwidths: np.ndarray | None = None,
    every_k: int = 4,
) -> SavingsReport:
    t, m = v_trace.shape
    vv = np.logical_or(v_trace[:, :, None], v_trace[:, None, :])
    comm = np.logical_and(vv, adj_trace)  # (T, m, m) used links
    used_links = comm.sum(axis=(1, 2)) / 2.0  # undirected
    phys_links = adj_trace.sum(axis=(1, 2)) / 2.0

    # per-device average bytes per step: each used link moves the model in
    # both directions; each endpoint sends once per used incident link
    event_per_step = n_bytes * comm.sum(axis=(1, 2)) / m
    dense_per_step = np.where(phys_links > 0, n_bytes * adj_trace.sum(axis=(1, 2)) / m, 0.0)

    if bandwidths is None:
        bandwidths = np.full(m, 1.0)
    deg = np.maximum(adj_trace.sum(axis=2), 1)
    frac_used = comm.sum(axis=2) / deg  # (T, m)
    tx_event = float((frac_used * (n_bytes / bandwidths[None, :])).mean(axis=1).sum())
    tx_dense = float(((adj_trace.sum(axis=2) > 0) * (n_bytes / bandwidths[None, :])).mean(axis=1).sum())

    # every-K baseline: the collective fires at steps 0, K, 2K, ... and each
    # firing moves the *actual* graph at that step.  Summing the realized
    # dense bytes over the fired steps is exact for time-varying G^(k);
    # the old ``total / K`` shortcut only matches when the per-step dense
    # volume is constant (static fabrics with T divisible by K).
    every_k = max(1, int(every_k))
    every_k_bytes = float(dense_per_step[::every_k].sum())

    return SavingsReport(
        steps=t, m=m, n_bytes=n_bytes,
        dense_bytes=float(dense_per_step.sum()),
        event_bytes=float(event_per_step.sum()),
        every_k_bytes=every_k_bytes,
        every_k=every_k,
        trigger_rate=float(v_trace.mean()),
        link_utilization=float(used_links.sum() / max(phys_links.sum(), 1.0)),
        tx_time_event=tx_event,
        tx_time_dense=tx_dense,
    )


def model_bytes(flat_dim: int, elem_bytes: int = 4) -> int:
    """Per-broadcast payload of one model: the ModelSpec ``flat_dim``
    (exact stacked-pytree parameter count) times the element size.  Every
    leaf rides the f32 (m, D) flat view through Event 2/3, so
    ``elem_bytes`` defaults to 4."""
    return int(flat_dim) * int(elem_bytes)


@dataclasses.dataclass
class TxSummary:
    """Per-request transmission accounting from row-sum traces only.

    ``savings_report`` needs the full (T, m, m) link matrices; a scenario
    service running at fleet scale keeps ``trace="summary"`` and never has
    them.  This report is computed from the per-device row sums
    ``comm_count``/``deg`` that every trace mode records (identical numbers
    where both paths apply: ``comm.sum((1, 2)) == comm_count.sum(1)``), so
    the service can attach tx accounting to EVERY request.
    """

    steps: int
    m: int
    n_bytes: int
    event_bytes: float  # cumulative, per-device average
    dense_bytes: float
    trigger_rate: float
    link_utilization: float  # used links / physical links
    tx_time: float  # paper Sec. IV metric, cumulative (engine-computed)
    # resource-dynamics exposure (0 when the run had none): total
    # device-steps spent down via churn / out of broadcast budget
    down_device_steps: int = 0
    exhausted_device_steps: int = 0

    @property
    def event_vs_dense(self) -> float:
        return self.event_bytes / max(self.dense_bytes, 1e-30)

    def as_dict(self) -> dict:
        return {"steps": self.steps, "m": self.m, "n_bytes": self.n_bytes,
                "event_bytes": self.event_bytes,
                "dense_bytes": self.dense_bytes,
                "event_vs_dense": self.event_vs_dense,
                "trigger_rate": self.trigger_rate,
                "link_utilization": self.link_utilization,
                "tx_time": self.tx_time,
                "down_device_steps": self.down_device_steps,
                "exhausted_device_steps": self.exhausted_device_steps}


def tx_summary_from_result(res, *, elem_bytes: int = 4) -> TxSummary:
    """``TxSummary`` for a ``fl.simulator.SimResult`` in ANY trace mode.

    Charges the realized model payload (``res.model_dim`` is the engine's
    ModelSpec flat_dim) against the recorded per-device link counts."""
    n_bytes = model_bytes(res.model_dim, elem_bytes)
    t, m = res.v.shape
    comm_total = float(res.comm_count.sum())
    deg_total = float(res.deg.sum())
    down = getattr(res, "down_count", None)
    exhausted = getattr(res, "exhausted_count", None)
    return TxSummary(
        steps=t, m=m, n_bytes=n_bytes,
        event_bytes=n_bytes * comm_total / m,
        dense_bytes=n_bytes * deg_total / m,
        trigger_rate=float(res.v.mean()),
        link_utilization=comm_total / max(deg_total, 1.0),
        tx_time=float(res.tx_time.sum()),
        down_device_steps=int(down.sum()) if down is not None else 0,
        exhausted_device_steps=(int(exhausted.sum())
                                if exhausted is not None else 0),
    )


def report_from_result(res, *, bandwidths=None, every_k: int = 4,
                       elem_bytes: int = 4) -> SavingsReport:
    """``savings_report`` driven by a ``fl.simulator.SimResult``: charges
    the realized model payload (``res.model_dim`` is the engine's
    ModelSpec flat_dim) under the run's sampled bandwidths.  Requires a
    trace mode that recorded adjacency (``full``/``packed``)."""
    if res.trace == "summary":
        raise ValueError(
            "report_from_result needs the adjacency trace; rerun with "
            "trace='full' or 'packed' (summary drops the link matrices)")
    bw = res.bandwidths if bandwidths is None else bandwidths
    return savings_report(res.v, res.adj, model_bytes(res.model_dim, elem_bytes),
                          bandwidths=bw, every_k=every_k)
