"""Scenario requests and their solo path (``api.simulate``).

Port of the part of ``repro.fl.service`` that one scenario run needs: the
validated request schema ``ScenarioSpec``, the synthetic data provider,
the graph and eval staging caches and ``solo_run``.  The continuous-batched
``ScenarioService`` and the sweep path are ROADMAP.md Queue 1 items 5 and
8.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

import numpy as np

from repro_torch.core.topology import GraphProcess, make_process
from repro_torch.data.loader import FederatedBatches
from repro_torch.data.partition import by_labels, dirichlet
from repro_torch.data.synthetic import image_dataset
from repro_torch.fl import simulator
from repro_torch.fl.simulator import EvalFn, SimConfig, SimResult, make_eval_fn

TOPOLOGIES: tuple[str, ...] = ("rgg", "er", "ring", "complete",
                               "scale_free", "clustered")
TIME_VARYING: tuple[str, ...] = ("static", "edge_dropout", "partition_cycle")
PARTITIONS: tuple[str, ...] = ("by_labels", "dirichlet")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One validated what-if request: the reference's fields, defaults and
    validation messages.  ``seeds`` fans a request out to one run per seed;
    ``simulate`` runs the first."""

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
    # --- resource dynamics (not ported: defaults only) ---------------------
    churn_rate: float = 0.0
    recover_rate: float = 0.5
    straggle_rate: float = 0.0
    bw_walk: float = 0.0
    budget_bytes: float = 0.0
    # --- fault injection (not ported: defaults only) -----------------------
    cluster_fail_rate: float = 0.0
    cluster_recover_rate: float = 0.25
    partition_start: int = -1
    partition_len: int = 0
    flap_rate: float = 0.0
    flap_len: int = 8
    crash_rate: float = 0.0
    rejoin_rate: float = 0.25
    warm_start: bool = False
    # --- B-connectivity watchdog (not ported: defaults only) ---------------
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
    repeated requests share the same arrays."""

    def __init__(self):
        self._cache: dict[tuple, Dataset] = {}

    @staticmethod
    def key(spec: ScenarioSpec) -> tuple:
        return (spec.m, spec.dim, spec.n_classes, spec.n_train, spec.n_test,
                spec.data_seed, spec.smooth, spec.partition,
                spec.labels_per_device, spec.dirichlet_alpha)

    def __call__(self, spec: ScenarioSpec) -> Dataset:
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


class _Stager:
    """Binds a data provider to small graph / eval staging caches, so a
    loop of ``simulate`` calls builds each fabric and test set once."""

    CACHE_SIZE = 32

    def __init__(self, provider: Callable[[ScenarioSpec], Dataset] | None = None):
        self.provider = provider or SyntheticProvider()
        self._graphs: "OrderedDict[tuple, GraphProcess]" = OrderedDict()
        self._evals: "OrderedDict[tuple, tuple[EvalFn, Dataset]]" = OrderedDict()

    def _put(self, cache: OrderedDict, k, v):
        cache[k] = v
        while len(cache) > self.CACHE_SIZE:
            cache.popitem(last=False)
        return v

    def graph(self, spec: ScenarioSpec) -> GraphProcess:
        k = (spec.m, spec.topology, spec.time_varying, spec.drop,
             spec.cycle_len, spec.graph_seed)
        g = self._graphs.get(k)
        if g is None:
            g = self._put(self._graphs, k, make_process(
                spec.m, spec.topology, time_varying=spec.time_varying,
                drop=spec.drop, cycle_len=spec.cycle_len,
                seed=spec.graph_seed))
        return g

    def eval_fn(self, spec: ScenarioSpec, ds: Dataset) -> EvalFn:
        # the dataset rides in the value so a recycled id cannot alias it
        k = (spec.model, spec.dim, spec.n_classes, id(ds))
        hit = self._evals.get(k)
        if hit is None:
            hit = self._put(self._evals, k, (
                make_eval_fn(spec.to_sim(), ds.x_test, ds.y_test), ds))
        return hit[0]


_SOLO_STAGER = _Stager()


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
