"""Policy x seed sweeps: the seeds x policies grid as one batched run.

Port of ``repro.fl.sweep``.  The paper's workload is this grid: every
Fig. 2 panel compares the four trigger policies over seeds on shared
data.  The reference runs it as ``jit(vmap(vmap(engine)))``; here the
cells (seed, policy) are the leading cell axis of one engine call
(``simulator.make_engine``): all cells advance together, each kernel
launches once per iteration for all of them, the graph is realized once
per iteration, and each cell keeps its own key, bandwidths, init and
batches, so it gives what its solo run gives.

``run_sweep`` returns a ``SweepResult`` holding the (S, P, T, ...) metric
stack; ``SweepResult.result(seed, policy)`` slices out a standard
``SimResult``.  Under ``mix_impl="sharded"`` the cells run one after
another through ``simulator.run`` (``_run_sweep_sharded``), as in the
reference, every cell on the one cached sharded engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import triggers
from repro_torch.core.topology import GraphProcess
from repro_torch.data.loader import FederatedBatches
from repro_torch.fl import simulator
from repro_torch.fl import trace as trace_mod
from repro_torch.fl.simulator import EvalFn, SimConfig, SimResult


@dataclasses.dataclass
class SweepResult:
    """Stacked trajectories for a seeds x policies grid.

    Metric arrays lead with (S, P) = (len(seeds), len(policies)); the
    remaining axes match ``SimResult`` (T per-iteration, m per-device).
    Like ``SimResult``, the ``comm``/``adj`` link matrices are accessors
    over ``trace``-dependent storage (dense / bit-packed / absent); slicing
    via ``result()`` keeps the storage mode.  The adjacency is shared by
    the cells (one graph realization per iteration) unless resources or
    faults are on, so ``_adj`` is then one (T, ...) trajectory broadcast
    to (S, P, T, ...).  ``timing`` is the
    engine call's (``simulator.make_engine``): ms of the first iteration
    and mean ms per later iteration, for all cells together.
    """

    seeds: tuple[int, ...]
    policies: tuple[str, ...]
    loss: np.ndarray  # (S, P, T, m)
    acc: np.ndarray  # (S, P, T)
    tx_time: np.ndarray  # (S, P, T)
    util: np.ndarray  # (S, P, T)
    v: np.ndarray  # (S, P, T, m)
    comm_count: np.ndarray  # (S, P, T, m) int32
    deg: np.ndarray  # (S, P, T, m) int32
    consensus_err: np.ndarray  # (S, P, T)
    bandwidths: np.ndarray  # (S, P, m) (policy axis is redundant but cheap)
    model_dim: int
    trace: str = "full"
    _comm: np.ndarray | None = None  # (S,P,T,m,m) bool | (S,P,T,m,W) uint32
    _adj: np.ndarray | None = None
    # resource, fault and watchdog channels (S, P, T): all-zero (all-True
    # for window_connected) without that process
    down_count: np.ndarray | None = None
    exhausted_count: np.ndarray | None = None
    fault_down_count: np.ndarray | None = None
    stale_max: np.ndarray | None = None
    window_connected: np.ndarray | None = None
    window_needed: np.ndarray | None = None
    timing: dict | None = None

    @property
    def m(self) -> int:
        return int(self.bandwidths.shape[-1])

    @property
    def comm(self) -> np.ndarray:  # (S, P, T, m, m) bool
        return trace_mod.stored_links(self._comm, self.trace, self.m, "comm")

    @property
    def adj(self) -> np.ndarray:  # (S, P, T, m, m) bool
        return trace_mod.stored_links(self._adj, self.trace, self.m, "adj")

    def result(self, seed: int, policy: str) -> SimResult:
        """Slice one grid cell back out as a standard ``SimResult``."""
        s = self.seeds.index(seed)
        p = self.policies.index(policy)

        def cell(a):
            return None if a is None else a[s, p]

        return SimResult(
            loss=self.loss[s, p], acc=self.acc[s, p], tx_time=self.tx_time[s, p],
            util=self.util[s, p], v=self.v[s, p],
            comm_count=self.comm_count[s, p], deg=self.deg[s, p],
            consensus_err=self.consensus_err[s, p],
            model_dim=self.model_dim, bandwidths=self.bandwidths[s, p],
            trace=self.trace, _comm=cell(self._comm), _adj=cell(self._adj),
            down_count=cell(self.down_count),
            exhausted_count=cell(self.exhausted_count),
            fault_down_count=cell(self.fault_down_count),
            stale_max=cell(self.stale_max),
            window_connected=cell(self.window_connected),
            window_needed=cell(self.window_needed))

    @property
    def cum_tx_time(self) -> np.ndarray:
        return np.cumsum(self.tx_time, axis=-1)


def run_sweep(
    sim: SimConfig,
    graph: GraphProcess,
    batches_factory: Callable[[int], FederatedBatches],
    eval_fn: EvalFn | None = None,
    *,
    seeds: Sequence[int] = (0,),
    policies: Sequence[str] = triggers.POLICIES,
    eval_every: int = 10,
    device="cuda",
) -> SweepResult:
    """Runs the full seeds x policies grid as one batched engine call on
    ``device``.

    ``batches_factory(seed)`` supplies the per-seed federated sampler (all
    policies within a seed share its staged batches, matching the legacy
    compare() protocol of identical data across policies).  ``sim.seed`` and
    ``sim.policy`` are ignored in favor of the grid axes.
    """
    if eval_fn is not None and not isinstance(eval_fn, EvalFn):
        raise TypeError(
            "run_sweep folds evaluation into the batched engine and needs an "
            "EvalFn (e.g. from simulator.make_eval_fn) or None; host eval "
            "callables need the python engine, which is not ported.")
    seeds = tuple(int(s) for s in seeds)
    policies = tuple(policies)
    if sim.mix_impl == "sharded":
        return _run_sweep_sharded(sim, graph, batches_factory, eval_fn, seeds=seeds,
                                  policies=policies, eval_every=eval_every,
                                  device=device)
    policy_idx = [triggers.policy_index(p) for p in policies]
    T = sim.iters

    staged, ref = [], None
    for s in seeds:
        b = batches_factory(s)
        ref = ref if ref is not None else b
        if ((b.x is not ref.x and not np.array_equal(b.x, ref.x))
                or (b.y is not ref.y and not np.array_equal(b.y, ref.y))):
            raise ValueError(
                "all batches_factory(seed) samplers must share one dataset: "
                "staged indices are gathered against the first seed's (x, y) "
                "arrays; vary the *sampling* seed per seed, not the data.")
        staged.append(b.stage(T))

    engine, model_dim = simulator._cached_engine(
        sim, graph, T=T, eval_every=eval_every, x=ref.x, y=ref.y,
        eval_fn=eval_fn, device=device)
    # cells in (seed, policy) order: cell s P + p
    S, P = len(seeds), len(policies)
    host, timing = engine([i for _ in seeds for i in policy_idx],
                          [s for s in seeds for _ in policies],
                          np.stack([x for x in staged for _ in policies]))

    def grid(a):
        return a.reshape((S, P) + a.shape[1:])

    trace = sim.trace
    link = trace_mod.link_dtype(trace)
    adj = None
    if "adj" in host:  # (1, T, ...) when the cells share the adjacency
        adj = host["adj"].astype(link)
        adj = (grid(adj) if adj.shape[0] == S * P
               else np.broadcast_to(adj[0], (S, P) + adj.shape[1:]))
    return SweepResult(
        seeds=seeds, policies=policies,
        loss=grid(host["loss"]), acc=grid(host["acc"]),
        tx_time=grid(host["tx_time"]), util=grid(host["util"]),
        v=grid(host["v"]), comm_count=grid(host["comm_count"]),
        deg=grid(host["deg"]), consensus_err=grid(host["consensus_err"]),
        bandwidths=grid(host["bandwidths"]), model_dim=model_dim, trace=trace,
        _comm=grid(host["comm"]).astype(link) if "comm" in host else None,
        _adj=adj,
        **{f: grid(host[f]) for f in (trace_mod.RESOURCE_CHANNELS
                                      + trace_mod.FAULT_CHANNELS
                                      + trace_mod.WATCHDOG_CHANNELS)},
        timing=timing)


def _run_sweep_sharded(sim, graph, batches_factory, eval_fn, *, seeds, policies,
                       eval_every, device) -> SweepResult:
    """The grid over the sharded fleet engine: the cells run one after
    another through ``simulator.run``, which takes the one sharded engine
    from the cache for all of them (at the fleet sizes that want
    sharding a batched grid would not fit anyway)."""
    cells = [[simulator.run(dataclasses.replace(sim, seed=s, policy=p), graph,
                            batches_factory(s), eval_fn, eval_every=eval_every,
                            device=device)
              for p in policies] for s in seeds]

    def stack(f, dt):
        return np.stack([[np.asarray(getattr(c, f), dt) for c in row] for row in cells])

    return SweepResult(
        seeds=seeds, policies=policies,
        loss=stack("loss", np.float32), acc=stack("acc", np.float32),
        tx_time=stack("tx_time", np.float32), util=stack("util", np.float32),
        v=stack("v", bool), comm_count=stack("comm_count", np.int32),
        deg=stack("deg", np.int32),
        consensus_err=stack("consensus_err", np.float32),
        bandwidths=stack("bandwidths", np.float32),
        model_dim=cells[0][0].model_dim, trace=trace_mod.check_trace_mode(sim.trace),
        down_count=stack("down_count", np.int32),
        exhausted_count=stack("exhausted_count", np.int32),
        fault_down_count=stack("fault_down_count", np.int32),
        stale_max=stack("stale_max", np.int32),
        window_connected=stack("window_connected", bool),
        window_needed=stack("window_needed", np.int32))


# ---------------------------------------------------------------------------
# robust sweep metrics (paper Fig. 2-(iii) as an area, not a point)
# ---------------------------------------------------------------------------

def acc_per_tx_auc(acc: np.ndarray, cum_tx: np.ndarray, budget: float) -> float:
    """Area under the accuracy-vs-cumulative-transmission-time curve up to
    ``budget``, normalized by ``budget`` (so the value is a mean accuracy
    over the budget interval, in [0, 1]).

    This is the paper's Fig. 2-(iii) claim made robust: instead of comparing
    accuracies at one budget point (noisy - a single eval step can flip it),
    integrate the whole trade-off curve.  The curve is the step function
    acc(t) = acc[k] for t in [cum_tx[k-1], cum_tx[k])."""
    edges = np.concatenate([[0.0], np.minimum(cum_tx, budget)])
    widths = np.clip(np.diff(edges), 0.0, None)
    area = float((widths * acc[: len(widths)]).sum())
    tail = budget - float(edges[-1])
    if tail > 0:  # curve exhausted before the budget: hold the last accuracy
        area += tail * float(acc[-1])
    return area / budget if budget > 0 else 0.0


def policy_auc_table(res: SweepResult, *, budget_frac: float = 0.9) -> dict[str, np.ndarray]:
    """Per-policy accuracy-per-tx AUC, seed by seed: {policy: (S,) array}.

    The budget is shared across policies within each seed (the smallest
    total transmission time, scaled by ``budget_frac``), mirroring the
    Fig. 2-(iii) protocol."""
    cum = res.cum_tx_time  # (S, P, T)
    out = {p: np.zeros(len(res.seeds)) for p in res.policies}
    for s in range(len(res.seeds)):
        budget = float(cum[s, :, -1].min()) * budget_frac
        for p, name in enumerate(res.policies):
            out[name][s] = acc_per_tx_auc(res.acc[s, p], cum[s, p], budget)
    return out
