"""Scenario service: continuous-batched what-if requests behind one API.

Port of ``repro.fl.service``.  Each request is a ``ScenarioSpec`` (fleet
fabric, model, trigger policy, threshold, horizon, seeds); the service
answers them as a model server answers inference traffic:

* **Validated request schema**: ``ScenarioSpec`` is frozen and fails fast
  at construction, with the reference's messages.
* **Continuous batching**: queued requests are grouped by their
  compatibility signature (every spec field but ``CELL_FIELDS``), and each
  group launches as ONE engine call over its (request, seed) cells: the
  engine (``simulator.make_engine``) takes a cell axis, policies and seeds
  per cell, so every kernel launches once per iteration for the whole
  group.  A cell gives what its solo run gives (integer channels equal,
  floats to an ulp: a reduction over more cells may split its work
  otherwise).
* **Engine reuse**: engines come from the simulator's value-keyed LRU
  (``simulator.engine_cache_stats``): a hit skips the host-to-device
  copies of the dataset, eval set and neighbor table.  Cell batches are
  padded to power-of-two buckets with copies of cell 0, as the reference
  pads to keep its compiled program's shape; ``program_cache_hit`` marks
  a repeated (signature, bucket) shape.
* **Hardening**: a failed round is retried with backoff, a request queued
  past its ``deadline_s`` is expired unlaunched, and a diverged (non-finite)
  cell is quarantined without touching its co-batched neighbors.

``solo_run`` (``api.simulate``) and ``sweep_run`` (``api.sweep``) share the
module-level staging caches with the service, so any of them reuses the
engines the others built.  ``launch/serve.py`` is the command-line entry point.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import accounting, triggers
from repro_torch.core.topology import GraphProcess, make_process
from repro_torch.data.loader import FederatedBatches
from repro_torch.data.partition import by_labels, dirichlet
from repro_torch.data.synthetic import image_dataset
from repro_torch.fl import simulator
from repro_torch.fl import sweep as sweep_mod
from repro_torch.fl.simulator import EvalFn, SimConfig, SimResult, make_eval_fn

TOPOLOGIES: tuple[str, ...] = ("rgg", "er", "ring", "complete",
                               "scale_free", "clustered")
TIME_VARYING: tuple[str, ...] = ("static", "edge_dropout", "partition_cycle")
PARTITIONS: tuple[str, ...] = ("by_labels", "dirichlet")

# spec fields a batch group may vary per cell: the policy and the seed are
# per-cell engine arguments, the sampler seed only shapes the staged index
# array, and ``deadline_s`` is queue policy.  Every other field defines the
# compatibility signature.
CELL_FIELDS: tuple[str, ...] = ("policy", "seeds", "sample_seed",
                                "deadline_s")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One validated what-if request: the reference's fields, defaults and
    validation messages.  ``seeds`` fans a request out to one cell per
    seed; ``simulate`` runs the first.  Specs with equal ``signature()``
    may be served in one launch."""

    # --- fleet fabric ----------------------------------------------------
    m: int = 10
    topology: str = "rgg"  # see TOPOLOGIES
    time_varying: str = "edge_dropout"  # see TIME_VARYING
    drop: float = 0.3
    cycle_len: int = 2
    graph_seed: int = 0
    # --- model + data ----------------------------------------------------
    model: str = "svm"
    dim: int = 784
    n_classes: int = 10
    n_train: int = 4000
    n_test: int = 800
    data_seed: int = 0
    partition: str = "by_labels"  # see PARTITIONS
    labels_per_device: int = 1
    dirichlet_alpha: float = 0.3
    smooth: int = 0
    # --- algorithm -------------------------------------------------------
    policy: str = "efhc"
    r: float = 50.0
    b_mean: float = 5000.0
    sigma_n: float = 0.9
    alpha0: float = 0.1
    optimizer: str = "sgd"
    batch: int = 16
    # --- resource dynamics (shape the engine; defaults: disabled) ---------
    churn_rate: float = 0.0
    recover_rate: float = 0.5
    straggle_rate: float = 0.0
    bw_walk: float = 0.0
    budget_bytes: float = 0.0
    # --- fault injection (shape the engine; defaults: disabled) -----------
    cluster_fail_rate: float = 0.0
    cluster_recover_rate: float = 0.25
    partition_start: int = -1
    partition_len: int = 0
    flap_rate: float = 0.0
    flap_len: int = 8
    crash_rate: float = 0.0
    rejoin_rate: float = 0.25
    warm_start: bool = False
    # --- B-connectivity watchdog (shapes the engine; 0: disabled) ---------
    watchdog_window: int = 0
    watchdog_nprop: int = 0
    # --- engine ----------------------------------------------------------
    iters: int = 300
    mix_impl: str = "dense"
    shards: int = 1
    trace: str = "summary"
    eval_every: int = 10
    # --- request fan-out -------------------------------------------------
    seeds: tuple[int, ...] = (0,)
    # cell seed s samples batches with FederatedBatches(seed=sample_seed + s)
    sample_seed: int = 2
    deadline_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        if not self.seeds:
            raise ValueError("seeds must name at least one seed")
        if self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"allowed: {TOPOLOGIES}")
        if self.time_varying not in TIME_VARYING:
            raise ValueError(f"unknown time_varying {self.time_varying!r}; "
                             f"allowed: {TIME_VARYING}")
        if self.partition not in PARTITIONS:
            raise ValueError(f"unknown partition {self.partition!r}; "
                             f"allowed: {PARTITIONS}")
        if self.n_train < 1 or self.n_test < 1:
            raise ValueError(f"n_train/n_test must be >= 1, got "
                             f"{self.n_train}/{self.n_test}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")
        self.to_sim()  # SimConfig validates the rest

    def to_sim(self, *, seed: int | None = None,
               policy: str | None = None) -> SimConfig:
        """The ``SimConfig`` for one cell of this request."""
        sim_fields = {f.name for f in dataclasses.fields(SimConfig)}
        kw = {name: getattr(self, name) for name in sim_fields
              if name not in ("seed", "policy") and hasattr(self, name)}
        return SimConfig(**kw,
                         policy=self.policy if policy is None else policy,
                         seed=self.seeds[0] if seed is None else int(seed))

    def signature(self) -> tuple:
        """Batch-compatibility key: every field but ``CELL_FIELDS``.  Specs
        with equal signatures run on the same dataset, fabric and engine."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.name not in CELL_FIELDS)

    def batches(self, seed: int, ds: "Dataset") -> FederatedBatches:
        """The cell's deterministic sampler."""
        return FederatedBatches(ds.x, ds.y, ds.parts, self.batch,
                                seed=self.sample_seed + int(seed))


@dataclasses.dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray
    parts: list
    x_test: np.ndarray
    y_test: np.ndarray


class SyntheticProvider:
    """The paper's synthetic image task, staged once per value key so
    repeated requests share the same arrays (the engine cache keys data by
    identity).  A custom provider is any callable ``provider(spec) ->
    Dataset`` keeping the same stability."""

    def __init__(self):
        self._cache: dict[tuple, Dataset] = {}

    @staticmethod
    def key(spec: ScenarioSpec) -> tuple:
        return (spec.m, spec.dim, spec.n_classes, spec.n_train, spec.n_test,
                spec.data_seed, spec.smooth, spec.partition,
                spec.labels_per_device, spec.dirichlet_alpha)

    def __call__(self, spec: ScenarioSpec) -> Dataset:
        if spec.model == "tiny_transformer":
            raise ValueError(
                "SyntheticProvider stages image data; model="
                "'tiny_transformer' needs token windows -- pass a custom "
                "provider (see examples/decentralized_transformer.py)")
        k = self.key(spec)
        ds = self._cache.get(k)
        if ds is None:
            x, y = image_dataset(spec.n_train, n_classes=spec.n_classes,
                                 dim=spec.dim, seed=spec.data_seed,
                                 smooth=spec.smooth)
            x_test, y_test = image_dataset(
                spec.n_test, n_classes=spec.n_classes, dim=spec.dim,
                seed=spec.data_seed + 1, smooth=spec.smooth)
            if spec.partition == "by_labels":
                parts = by_labels(y, spec.m, spec.labels_per_device)
            else:
                parts = dirichlet(y, spec.m, spec.dirichlet_alpha,
                                  seed=spec.data_seed)
            ds = Dataset(x, y, parts, x_test, y_test)
            self._cache[k] = ds
        return ds


_DEFAULT_PROVIDER = SyntheticProvider()

# Graph and eval staging caches, module-level so the solo, sweep and service
# paths hand the engine cache the same objects (it keys eval fns by
# identity): a solo run of a scenario the service already ran, or the other
# way round, is an engine-cache hit.  Graphs are cached by fabric value,
# eval fns by (model, id(dataset)) with the dataset kept alive in the value
# so a recycled id cannot alias a stale entry.
_GRAPH_CACHE: "OrderedDict[tuple, GraphProcess]" = OrderedDict()
_EVAL_CACHE: "OrderedDict[tuple, tuple[EvalFn, Dataset]]" = OrderedDict()
_STAGING_CACHE_SIZE = 32


class _Stager:
    """Binds a data provider to the shared graph and eval staging caches."""

    def __init__(self, provider: Callable[[ScenarioSpec], Dataset] | None):
        self.provider = provider or _DEFAULT_PROVIDER

    @staticmethod
    def graph(spec: ScenarioSpec) -> GraphProcess:
        k = (spec.m, spec.topology, spec.time_varying, spec.drop,
             spec.cycle_len, spec.graph_seed)
        g = _GRAPH_CACHE.get(k)
        if g is None:
            g = make_process(spec.m, spec.topology,
                             time_varying=spec.time_varying, drop=spec.drop,
                             cycle_len=spec.cycle_len, seed=spec.graph_seed)
            _GRAPH_CACHE[k] = g
            while len(_GRAPH_CACHE) > _STAGING_CACHE_SIZE:
                _GRAPH_CACHE.popitem(last=False)
        return g

    @staticmethod
    def eval_fn(spec: ScenarioSpec, ds: Dataset) -> EvalFn:
        k = (spec.model, spec.dim, spec.n_classes, id(ds))
        hit = _EVAL_CACHE.get(k)
        if hit is None:
            hit = (make_eval_fn(spec.to_sim(), ds.x_test, ds.y_test), ds)
            _EVAL_CACHE[k] = hit
            while len(_EVAL_CACHE) > _STAGING_CACHE_SIZE:
                _EVAL_CACHE.popitem(last=False)
        return hit[0]


# the one-shot entry points' stager, so loops of simulate() / sweep() calls
# reuse staging (and engines) as the resident service does
_SOLO_STAGER = _Stager(None)


def solo_run(spec: ScenarioSpec, *, seed: int | None = None, provider=None,
             device="cuda") -> SimResult:
    """One scenario, one seed, on ``device``: the path behind
    ``repro_torch.api.simulate``."""
    stager = _Stager(provider) if provider is not None else _SOLO_STAGER
    ds = stager.provider(spec)
    s = spec.seeds[0] if seed is None else int(seed)
    return simulator.run(
        spec.to_sim(seed=s), stager.graph(spec), spec.batches(s, ds),
        stager.eval_fn(spec, ds), eval_every=spec.eval_every, device=device)


def sweep_run(spec: ScenarioSpec, *, seeds: Sequence[int] | None = None,
              policies: Sequence[str] = triggers.POLICIES, provider=None,
              device="cuda") -> sweep_mod.SweepResult:
    """The seeds x policies grid for one scenario as one batched engine
    call on ``device`` (``repro_torch.api.sweep``): ``spec.policy`` is
    ignored in favor of the ``policies`` axis."""
    stager = _Stager(provider) if provider is not None else _SOLO_STAGER
    ds = stager.provider(spec)
    return sweep_mod.run_sweep(
        spec.to_sim(), stager.graph(spec),
        lambda s: spec.batches(s, ds), stager.eval_fn(spec, ds),
        seeds=spec.seeds if seeds is None else seeds, policies=policies,
        eval_every=spec.eval_every, device=device)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioReport:
    """Per-request answer: results keyed by seed, with latency and cache
    accounting.

    ``queue_wait_s`` is submit -> launch start; ``stage_s`` the launch's
    staging (dataset, fabric, eval set, engine from the cache, batch
    indices); ``run_s`` the engine call, from the first host-to-device copy
    to the trajectories back on the host (both shared by the launch's
    requests)."""

    request_id: int
    spec: ScenarioSpec
    launch_id: int
    results: dict[int, SimResult]  # seed -> trajectory
    tx: dict[int, accounting.TxSummary]  # seed -> transmission accounting
    queue_wait_s: float
    stage_s: float
    run_s: float
    launch_cells: int  # real cells co-batched in this launch
    engine_cache_hit: bool
    program_cache_hit: bool
    # the error message when this request's round failed (``results`` and
    # ``tx`` empty); other rounds keep draining
    error: str | None = None
    # seeds whose trajectory diverged (non-finite loss or consensus error),
    # withheld from ``results``; their co-batched cells come back untouched
    quarantined: tuple[int, ...] = ()
    # poll rounds this request was relaunched after a contained failure
    retries: int = 0

    @property
    def ok(self) -> bool:
        return self.error is None

    def result(self, seed: int | None = None) -> SimResult:
        if self.error is not None:
            raise RuntimeError(
                f"request {self.request_id} failed: {self.error}")
        s = self.spec.seeds[0] if seed is None else seed
        if s in self.quarantined:
            raise RuntimeError(
                f"request {self.request_id} seed {s} was quarantined: "
                "trajectory diverged (non-finite loss/consensus_err)")
        return self.results[s]

    def timing_dict(self) -> dict:
        return {"request_id": self.request_id, "launch_id": self.launch_id,
                "queue_wait_s": self.queue_wait_s, "stage_s": self.stage_s,
                "run_s": self.run_s, "launch_cells": self.launch_cells,
                "cells": len(self.results),
                "engine_cache_hit": self.engine_cache_hit,
                "program_cache_hit": self.program_cache_hit}


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    cells: int = 0
    launches: int = 0
    program_hits: int = 0
    program_misses: int = 0
    padded_cells: int = 0  # bucket-padding cells executed
    failures: int = 0  # requests answered with error-tagged reports
    retries: int = 0  # failed requests re-queued for another round
    deadline_expired: int = 0  # requests expired in queue, never launched
    quarantined: int = 0  # diverged (non-finite) cells withheld
    engine: simulator.EngineCacheStats = dataclasses.field(
        default_factory=simulator.EngineCacheStats)

    def as_dict(self) -> dict:
        return {"requests": self.requests, "cells": self.cells,
                "launches": self.launches, "program_hits": self.program_hits,
                "program_misses": self.program_misses,
                "padded_cells": self.padded_cells,
                "failures": self.failures, "retries": self.retries,
                "deadline_expired": self.deadline_expired,
                "quarantined": self.quarantined,
                "engine_cache": self.engine.as_dict()}


@dataclasses.dataclass
class _Pending:
    rid: int
    spec: ScenarioSpec
    sig: tuple
    t_submit: float
    attempts: int = 0  # launch attempts already consumed (for retry caps)


def _bucket(n: int) -> int:
    """Next power-of-two cell count (the reference's padding bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


class ScenarioService:
    """Resident continuous-batching scenario server on ``device``.

    ``submit`` enqueues; ``poll`` serves one round: it takes the oldest
    request's signature, gathers every queued compatible request up to
    ``max_cells`` cells (FIFO within the signature) and launches them as
    one engine call.  ``serve`` submits a batch and polls until drained; a
    signature whose queue exceeds ``max_cells`` drains over several rounds,
    the later ones hitting the engine cache.

    A round that fails is retried up to ``max_retries`` times per request
    with exponential backoff before the error report goes out; a request
    still queued past its ``deadline_s`` is expired without launching; a
    cell whose trajectory diverged to NaN/Inf is quarantined out of the
    report.  ``mix_impl="sharded"`` requests are taken, and a launch runs
    their cells one after another through ``simulator.run`` on the one
    cached sharded engine, as in the reference.
    """

    def __init__(self, provider=None, *, max_cells: int = 16,
                 max_retries: int = 1, retry_backoff_s: float = 0.05,
                 device="cuda"):
        if max_cells < 1:
            raise ValueError(f"max_cells must be >= 1, got {max_cells}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        self.device = resolve_device(device)
        self._stager = _Stager(provider)
        self.max_cells = max_cells
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._queue: deque[_Pending] = deque()
        self._next_id = 0
        self._seen_programs: set[tuple] = set()
        self._stats = ServiceStats()

    # ------------------------------------------------------------- queue --
    def submit(self, spec: ScenarioSpec) -> int:
        if not isinstance(spec, ScenarioSpec):
            raise TypeError(f"submit takes a ScenarioSpec, got "
                            f"{type(spec).__name__}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, spec, spec.signature(),
                                    time.perf_counter()))
        self._stats.requests += 1
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def stats(self) -> ServiceStats:
        return dataclasses.replace(self._stats,
                                   engine=simulator.engine_cache_stats())

    # ------------------------------------------------------------- rounds --
    def _expire(self) -> list[ScenarioReport]:
        """Answers the requests queued past their ``deadline_s`` with error
        reports instead of launching them."""
        t_now = time.perf_counter()
        expired = [p for p in self._queue
                   if p.spec.deadline_s > 0
                   and t_now - p.t_submit > p.spec.deadline_s]
        reports: list[ScenarioReport] = []
        for p in expired:
            self._queue.remove(p)
            self._stats.deadline_expired += 1
            reports.append(ScenarioReport(
                request_id=p.rid, spec=p.spec, launch_id=-1, results={},
                tx={}, queue_wait_s=t_now - p.t_submit, stage_s=0.0,
                run_s=0.0, launch_cells=0, engine_cache_hit=False,
                program_cache_hit=False, retries=p.attempts,
                error=(f"DeadlineExceeded: queued "
                       f"{t_now - p.t_submit:.3f}s > deadline_s="
                       f"{p.spec.deadline_s}")))
        return reports

    def poll(self) -> list[ScenarioReport]:
        """Serves one batch round; [] when the queue is empty.

        Any failure of the round is contained to it: the failed requests
        are re-queued (up to ``max_retries`` attempts each, with
        ``retry_backoff_s * 2**attempt`` backoff) or come back as
        error-tagged reports, and the rest of the queue keeps draining."""
        reports = self._expire()
        if not self._queue:
            return reports
        sig = self._queue[0].sig
        group: list[_Pending] = []
        budget = self.max_cells
        for p in list(self._queue):
            n = len(p.spec.seeds)
            if p.sig == sig and (n <= budget or not group):
                group.append(p)
                budget -= n
                self._queue.remove(p)
        try:
            return reports + self._launch(group)
        except Exception as e:  # noqa: BLE001 -- contain any round failure
            t_now = time.perf_counter()
            backoff = 0.0
            for p in group:
                if p.attempts < self.max_retries:
                    p.attempts += 1
                    self._stats.retries += 1
                    backoff = max(
                        backoff,
                        self.retry_backoff_s * 2 ** (p.attempts - 1))
                    self._queue.append(p)  # back of the queue: FIFO fairness
                else:
                    self._stats.failures += 1
                    reports.append(ScenarioReport(
                        request_id=p.rid, spec=p.spec, launch_id=-1,
                        results={}, tx={}, queue_wait_s=t_now - p.t_submit,
                        stage_s=0.0, run_s=0.0, launch_cells=0,
                        engine_cache_hit=False, program_cache_hit=False,
                        retries=p.attempts,
                        error=f"{type(e).__name__}: {e}"))
            if backoff:
                time.sleep(backoff)
            return reports

    def serve(self, specs: Sequence[ScenarioSpec] = ()) -> list[ScenarioReport]:
        """Submit ``specs``, drain the queue, return reports by request id."""
        for spec in specs:
            self.submit(spec)
        reports: list[ScenarioReport] = []
        while self._queue:
            reports.extend(self.poll())
        return sorted(reports, key=lambda r: r.request_id)

    # ------------------------------------------------------------- launch --
    def _launch(self, group: list[_Pending]) -> list[ScenarioReport]:
        spec0 = group[0].spec
        t_start = time.perf_counter()
        launch_id = self._stats.launches
        self._stats.launches += 1

        ds = self._stager.provider(spec0)
        graph = self._stager.graph(spec0)
        eval_fn = self._stager.eval_fn(spec0, ds)
        cells = [(p, s) for p in group for s in p.spec.seeds]
        self._stats.cells += len(cells)
        if spec0.mix_impl == "sharded":
            return self._launch_serial(group, cells, ds, graph, eval_fn, t_start,
                                       launch_id)

        before = simulator.engine_cache_stats()
        eng, model_dim = simulator._cached_engine(
            spec0.to_sim(), graph, T=spec0.iters,
            eval_every=spec0.eval_every, x=ds.x, y=ds.y, eval_fn=eval_fn,
            device=self.device)
        engine_hit = simulator.engine_cache_stats().hits > before.hits

        pol = [triggers.policy_index(p.spec.policy) for p, _ in cells]
        seeds = [s for _, s in cells]
        idx = np.stack([p.spec.batches(s, ds).stage(p.spec.iters)
                        for p, s in cells])
        n = len(cells)
        b = min(_bucket(n), max(self.max_cells, n))
        if b > n:  # pad with copies of cell 0; padded outputs are dropped
            pad = b - n
            self._stats.padded_cells += pad
            pol, seeds = pol + pol[:1] * pad, seeds + seeds[:1] * pad
            idx = np.concatenate([idx, np.repeat(idx[:1], pad, 0)])
        t_staged = time.perf_counter()

        prog_key = (group[0].sig, b)
        program_hit = prog_key in self._seen_programs
        self._seen_programs.add(prog_key)
        self._stats.program_hits += int(program_hit)
        self._stats.program_misses += int(not program_hit)

        host, timing = eng(pol, seeds, idx)
        t_done = time.perf_counter()

        results = []
        for i in range(n):
            res = simulator.result_of_cell(host, i, model_dim, spec0.trace)
            res.timing = timing
            results.append(res)
        return self._reports(group, cells, results, t_start=t_start,
                             stage_s=t_staged - t_start,
                             run_s=t_done - t_staged, launch_id=launch_id,
                             engine_hit=engine_hit, program_hit=program_hit)

    def _launch_serial(self, group, cells, ds, graph, eval_fn, t_start,
                       launch_id) -> list[ScenarioReport]:
        """A sharded group's cells, one ``simulator.run`` each."""
        before = simulator.engine_cache_stats()
        results = [simulator.run(p.spec.to_sim(seed=s), graph, p.spec.batches(s, ds),
                                 eval_fn, eval_every=p.spec.eval_every, device=self.device)
                   for p, s in cells]
        after = simulator.engine_cache_stats()
        return self._reports(group, cells, results, t_start=t_start, stage_s=0.0,
                             run_s=time.perf_counter() - t_start, launch_id=launch_id,
                             engine_hit=after.hits > before.hits,
                             program_hit=after.misses == before.misses)

    @staticmethod
    def _diverged(res: SimResult) -> bool:
        """A cell whose loss or consensus error ever left the finite range
        is quarantined: a NaN/Inf trajectory must never read as an answer."""
        return not (np.isfinite(res.loss).all()
                    and np.isfinite(res.consensus_err).all())

    def _reports(self, group, cells, results, *, t_start, stage_s, run_s,
                 launch_id, engine_hit, program_hit) -> list[ScenarioReport]:
        per_req: dict[int, dict[int, SimResult]] = {p.rid: {} for p in group}
        bad: dict[int, list[int]] = {p.rid: [] for p in group}
        for (p, s), res in zip(cells, results):
            if self._diverged(res):
                bad[p.rid].append(s)
                self._stats.quarantined += 1
            else:
                per_req[p.rid][s] = res
        return [ScenarioReport(
            request_id=p.rid, spec=p.spec, launch_id=launch_id,
            results=per_req[p.rid],
            tx={s: accounting.tx_summary_from_result(r)
                for s, r in per_req[p.rid].items()},
            queue_wait_s=t_start - p.t_submit, stage_s=stage_s, run_s=run_s,
            launch_cells=len(cells), engine_cache_hit=engine_hit,
            program_cache_hit=program_hit, retries=p.attempts,
            quarantined=tuple(bad[p.rid])) for p in group]
