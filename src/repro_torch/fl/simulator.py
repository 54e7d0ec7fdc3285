"""Decentralized FL simulator (the paper's Sec. IV experiment harness).

Port of ``repro.fl.simulator`` (the scan engine).  ``make_engine`` builds
the engine over a list of cells (policy, seed, staged batch indices), the
reference's ``vmap(engine)`` contract written out: all cells advance
together, one ``efhc.step`` over a leading cell axis per iteration, so
each kernel launches once per iteration whatever the number of cells, and
the graph is realized once per iteration for all of them.  ``run``
simulates one scenario as the one-cell call and returns the paper's
trajectories as a ``SimResult``; ``repro_torch.fl.sweep`` runs the seeds x
policies grid through the same engine.

The reference compiles the horizon as one chunked ``lax.scan``; here it is
a Python loop over ``efhc.step`` that stays on the device:

* batches are pre-staged as (T, C, m, batch) index arrays
  (``FederatedBatches.stage`` per cell) and gathered from the
  device-resident dataset each step;
* every per-iteration metric is written into a preallocated (T, C, m) /
  (T, C) device tensor, and evaluation runs on the device after the first
  step of each ``eval_every`` chunk (iterations 0, E, 2E, ...) and once
  more after the last step (the k = T-1 overwrite);
* nothing in the loop reads a tensor's value on the host, so the host
  syncs once per engine call, when the trajectories are copied back at
  the end.

``run`` (and the sweep and the scenario service) take their engine from a
small value-keyed LRU (``_cached_engine``, ``engine_cache_stats``): a hit
skips the host-to-device copies of the dataset, the eval set and the
neighbor table, which is what a run repeated with another seed or policy
would redo.  Nothing is compiled, so a miss costs those copies alone.

Resource dynamics, fault injection, the watchdog, the sharded engine and
the python engine are not ported yet: a config that asks for one raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import efhc, topology, triggers
from repro_torch.core.topology import GraphProcess
from repro_torch.data.loader import FederatedBatches
from repro_torch.fl import modelspec as modelspec_mod
from repro_torch.fl import trace as trace_mod
from repro_torch.kernels.mixing import ops as mixing_ops
from repro_torch.optim.optimizers import OPT_NAMES, init_opt
from repro_torch.optim.schedules import paper_diminishing
from repro_torch.tree import first_leaf, tree_map

# every mix_impl a SimConfig may name, as in the reference
SIM_MIX_IMPLS: tuple[str, ...] = efhc.MIX_IMPLS + ("sharded",)

# scenario-dynamics knobs at their disabled defaults; any other value asks
# for a subsystem this port does not have yet
_DYNAMICS_DEFAULTS = {
    "churn_rate": 0.0, "recover_rate": 0.5, "straggle_rate": 0.0,
    "bw_walk": 0.0, "budget_bytes": 0.0,
    "cluster_fail_rate": 0.0, "cluster_recover_rate": 0.25,
    "partition_start": -1, "partition_len": 0, "flap_rate": 0.0,
    "flap_len": 8, "crash_rate": 0.0, "rejoin_rate": 0.25,
    "warm_start": False, "watchdog_window": 0, "watchdog_nprop": 0,
}


@dataclasses.dataclass
class SimConfig:
    """The reference's ``SimConfig``: same fields, defaults and validation
    messages.  Valid values this port cannot run yet raise
    ``NotImplementedError``."""

    m: int = 10
    model: str = "svm"
    n_classes: int = 10
    dim: int = 784
    batch: int = 16
    iters: int = 300
    policy: str = "efhc"  # efhc | zero | global | gossip
    r: float = 50.0  # threshold scale (paper: b_M * 1e-2)
    b_mean: float = 5000.0
    sigma_n: float = 0.9
    alpha0: float = 0.1
    optimizer: str = "sgd"
    seed: int = 0
    mix_impl: str = "dense"  # see efhc.MIX_IMPLS
    shards: int = 1
    trace: str = "full"  # full | packed | summary
    churn_rate: float = 0.0
    recover_rate: float = 0.5
    straggle_rate: float = 0.0
    bw_walk: float = 0.0
    budget_bytes: float = 0.0
    cluster_fail_rate: float = 0.0
    cluster_recover_rate: float = 0.25
    partition_start: int = -1
    partition_len: int = 0
    flap_rate: float = 0.0
    flap_len: int = 8
    crash_rate: float = 0.0
    rejoin_rate: float = 0.25
    warm_start: bool = False
    watchdog_window: int = 0
    watchdog_nprop: int = 0

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.policy not in triggers.POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"allowed: {triggers.POLICIES}")
        if self.model not in modelspec_mod.MODEL_NAMES:
            raise ValueError(f"unknown model {self.model!r}; "
                             f"allowed: {modelspec_mod.MODEL_NAMES}")
        if self.optimizer not in OPT_NAMES:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"allowed: {OPT_NAMES}")
        if self.mix_impl not in SIM_MIX_IMPLS:
            raise ValueError(f"unknown mix_impl {self.mix_impl!r}; "
                             f"allowed: {SIM_MIX_IMPLS}")
        trace_mod.check_trace_mode(self.trace)
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.shards > 1 and self.mix_impl != "sharded":
            raise ValueError(
                f"shards={self.shards} requires mix_impl='sharded' "
                f"(got mix_impl={self.mix_impl!r}); every other impl runs "
                f"single-device")
        if self.mix_impl == "sharded" and self.trace != "summary":
            raise ValueError(
                f"mix_impl='sharded' keeps only summary traces (per-device "
                f"counts); got trace={self.trace!r} -- link matrices would "
                f"densify (T, m, m) at fleet scale")
        triggers.check_sigma_n(self.sigma_n)
        # valid, but not in this port yet
        if self.mix_impl == "sharded":
            raise NotImplementedError(
                "mix_impl='sharded' is not ported yet (ROADMAP.md Queue 1 "
                "item 9, sharded fleet engine)")
        changed = [name for name, default in _DYNAMICS_DEFAULTS.items()
                   if getattr(self, name) != default]
        if changed:
            raise NotImplementedError(
                f"resource dynamics, fault injection and the watchdog are not "
                f"ported yet (ROADMAP.md Queue 1 item 7, scenario dynamics); "
                f"non-default knobs: {changed}")


@dataclasses.dataclass
class SimResult:
    """Host-side trajectories, the reference's contract (numpy arrays).

    ``comm``/``adj`` are accessors whose storage follows ``trace``; the
    scenario-dynamics channels are all-zero (all-True for
    ``window_connected``) because the port runs no such process yet."""

    loss: np.ndarray  # (T, m)
    acc: np.ndarray  # (T,)
    tx_time: np.ndarray  # (T,)
    util: np.ndarray  # (T,)
    v: np.ndarray  # (T, m)
    comm_count: np.ndarray  # (T, m) int32
    deg: np.ndarray  # (T, m) int32
    consensus_err: np.ndarray  # (T,)
    model_dim: int
    bandwidths: np.ndarray
    trace: str = "full"
    _comm: np.ndarray | None = None  # (T,m,m) bool | (T,m,W) uint32 | None
    _adj: np.ndarray | None = None
    down_count: np.ndarray | None = None
    exhausted_count: np.ndarray | None = None
    fault_down_count: np.ndarray | None = None
    stale_max: np.ndarray | None = None
    window_connected: np.ndarray | None = None
    window_needed: np.ndarray | None = None
    # run timing in ms on the run's device clock (``_Clock``): the first
    # iteration (with its eval) and the mean of the later ones
    timing: dict | None = None

    @property
    def m(self) -> int:
        return int(self.bandwidths.shape[-1])

    @property
    def comm(self) -> np.ndarray:  # (T, m, m) bool
        return trace_mod.stored_links(self._comm, self.trace, self.m, "comm")

    @property
    def adj(self) -> np.ndarray:  # (T, m, m) bool
        return trace_mod.stored_links(self._adj, self.trace, self.m, "adj")

    @property
    def cum_tx_time(self) -> np.ndarray:
        return np.cumsum(self.tx_time)


def as_inputs(x) -> torch.Tensor:
    """A dataset's inputs as a host tensor: float32 features, or int64
    token ids where the array holds integers."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.float32))


class EvalFn:
    """Mean test accuracy over devices, per cell, computed on the device.

    ``device(w)`` takes the stacked parameter tree, leaves (C, m, ...), and
    returns a (C,) float32 tensor without syncing; the test set moves to a
    device once and is cached there.  ``argmax`` ties resolve to the first
    maximum, as in jax."""

    def __init__(self, logits_fn, x_test: np.ndarray, y_test: np.ndarray):
        self._logits_fn = logits_fn
        self.x_test = as_inputs(x_test).numpy()
        self.y_test = np.asarray(y_test)
        self._on: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def _data(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        hit = self._on.get(str(device))
        if hit is None:
            hit = (torch.as_tensor(self.x_test).to(device),
                   torch.as_tensor(self.y_test, dtype=torch.int64).to(device))
            self._on[str(device)] = hit
        return hit

    def device(self, w_stack) -> torch.Tensor:
        leaf = first_leaf(w_stack)
        cells, m = leaf.shape[:2]
        x, y = self._data(leaf.device)
        # the cells as more devices: one batched forward over C m models
        w = tree_map(efhc.fold_cells, w_stack)
        pred = self._logits_fn(w, x).argmax(-1)  # (C m, n)
        return (pred == y).float().mean(-1).reshape(cells, m).mean(-1)


def model_spec(sim: SimConfig) -> modelspec_mod.ModelSpec:
    return modelspec_mod.make_model_spec(sim.model, dim=sim.dim,
                                         n_classes=sim.n_classes)


def make_eval_fn(sim: SimConfig, x_test: np.ndarray, y_test: np.ndarray) -> EvalFn:
    spec = model_spec(sim)
    return EvalFn(spec.logits, x_test, y_test)


def _efhc_cfg(sim: SimConfig) -> efhc.EFHCConfig:
    return efhc.EFHCConfig(
        trigger=triggers.TriggerConfig(policy=sim.policy, r=sim.r,
                                       b_mean=sim.b_mean),
        mix_impl=sim.mix_impl)


class _Buffers:
    """Preallocated device trajectories for a T-iteration run of C cells;
    the adjacency, shared by the cells, is kept once."""

    def __init__(self, T: int, C: int, m: int, trace: str, device: torch.device):
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.trace = trace
        self.ys = {"loss": z((T, C, m), f32), "tx_time": z((T, C), f32),
                   "util": z((T, C), f32), "v": z((T, C, m), torch.bool),
                   "consensus_err": z((T, C), f32),
                   "comm_count": z((T, C, m), i32), "deg": z((T, C, m), i32),
                   "acc": z((T, C), f32)}
        if trace == "full":
            self.ys["comm"] = z((T, C, m, m), torch.bool)
            self.ys["adj"] = z((T, m, m), torch.bool)
        elif trace == "packed":
            w = trace_mod.packed_words(m)
            self.ys["comm"] = z((T, C, m, w), torch.int64)
            self.ys["adj"] = z((T, m, w), torch.int64)

    def write(self, k: int, aux: efhc.StepAux) -> None:
        ys = self.ys
        ys["loss"][k] = aux.loss
        ys["tx_time"][k] = aux.tx_time
        ys["util"][k] = aux.util
        ys["v"][k] = aux.v
        ys["consensus_err"][k] = aux.consensus_err
        ys["comm_count"][k] = aux.comm_count
        ys["deg"][k] = aux.deg
        if self.trace == "full":
            ys["comm"][k] = aux.comm
            ys["adj"][k] = aux.adj
        elif self.trace == "packed":
            ys["comm"][k] = trace_mod.pack_links(aux.comm)
            ys["adj"][k] = trace_mod.pack_links(aux.adj)


class _Clock:
    """Marks points of the run without syncing: CUDA events on the card,
    the host clock on the CPU (where every op has finished when it
    returns).  ``ms(a, b)`` is read after the run's final sync."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: dict[str, object] = {}

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        else:
            self.marks[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        if self.cuda:
            return float(self.marks[a].elapsed_time(self.marks[b]))
        return (self.marks[b] - self.marks[a]) * 1e3


def _to_host(ys: dict, bw: torch.Tensor) -> dict[str, np.ndarray]:
    """Copies the trajectories back, the engine call's single host sync:
    per-cell channels (C, T, ...) (the shared adjacency stays (T, ...)),
    and ``bandwidths`` (C, m)."""
    host = {k: v.cpu().numpy() for k, v in ys.items()}
    out = {k: (v if k == "adj" else np.ascontiguousarray(np.moveaxis(v, 1, 0)))
           for k, v in host.items()}
    out["bandwidths"] = bw.cpu().numpy()
    return out


def result_of_cell(host: dict, c: int, model_dim: int, trace: str) -> SimResult:
    """Cell ``c`` of an engine call's host trajectories as a ``SimResult``."""
    T = host["acc"].shape[1]
    zeros = np.zeros(T, np.int32)
    link = trace_mod.link_dtype(trace)
    return SimResult(
        loss=host["loss"][c], acc=host["acc"][c], tx_time=host["tx_time"][c],
        util=host["util"][c], v=host["v"][c], comm_count=host["comm_count"][c],
        deg=host["deg"][c], consensus_err=host["consensus_err"][c],
        model_dim=model_dim, bandwidths=host["bandwidths"][c], trace=trace,
        _comm=host["comm"][c].astype(link) if "comm" in host else None,
        _adj=host["adj"].astype(link) if "adj" in host else None,
        down_count=zeros, exhausted_count=zeros.copy(),
        fault_down_count=zeros.copy(), stale_max=zeros.copy(),
        window_connected=np.ones(T, bool), window_needed=zeros.copy())


def make_engine(
    sim: SimConfig,
    graph: GraphProcess,
    *,
    T: int,
    eval_every: int = 10,
    x: np.ndarray,
    y: np.ndarray,
    eval_fn: EvalFn | None = None,
    device="cuda",
):
    """Builds the device-resident simulation engine over a list of cells,
    the reference's ``make_engine`` contract with its cell axis written
    out:

        engine(policy_idx, seeds, idx) -> (host trajectories, timing)

    ``policy_idx`` (C,) indexes ``triggers.POLICIES``, ``seeds`` (C,) are
    the cells' run seeds and ``idx`` (C, T, m, batch) their staged dataset
    rows (``FederatedBatches.stage``) into the shared ``x``/``y``.  The
    trajectories are host numpy arrays with a leading cell axis (the
    shared adjacency excepted) and ``bandwidths`` (C, m); cell ``c`` is
    ``result_of_cell(out, c, model_dim, sim.trace)``.  ``timing`` holds the
    first iteration's ms (with its eval) and the mean ms of the later ones
    on the device's clock.  Returns ``(engine, model_dim)``.

    Set ``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) for
    true-fp32 products on the card; TF32 breaks parity with the reference.
    """
    if eval_fn is not None and not isinstance(eval_fn, EvalFn):
        raise NotImplementedError(
            "host eval callables need the python engine, which is not ported; "
            "pass an EvalFn (make_eval_fn) or None")
    dev = resolve_device(device)
    m, E = sim.m, max(1, int(eval_every))
    if graph.m != m:
        raise ValueError(f"sim.m={m} but the graph has {graph.m} devices")
    trace = trace_mod.check_trace_mode(sim.trace)
    spec = model_spec(sim)
    opt = init_opt(sim.optimizer)
    cfg = _efhc_cfg(sim)
    sparse = cfg.mix_impl in efhc.SPARSE_MIX_IMPLS
    sched = paper_diminishing(sim.alpha0, gamma=1.0, theta=0.5)
    model_dim = spec.flat_dim
    nl = (topology.StagedNeighbors.from_host(graph.neighbors(), dev)
          if sparse else None)
    x_all = as_inputs(x).to(dev)
    y_all = torch.as_tensor(np.asarray(y), dtype=torch.int64).to(dev)
    dense_aux = trace != "summary"

    def init(seeds):
        # the reference's init stream (_EngineCore.init), cell by cell
        bws, w0s, keys = [], [], []
        for seed in seeds:
            k_bw, k_init, k_state = prng.split(prng.PRNGKey(int(seed), dev), 3)
            bws.append(triggers.sample_bandwidths(k_bw, m, sim.b_mean, sim.sigma_n))
            w0s.append(spec.init_stack(k_init, m))
            keys.append(k_state)
        w0 = tree_map(lambda *ts: torch.stack(ts), *w0s)
        bw, key = torch.stack(bws), torch.stack(keys)
        adj0 = graph.adjacency_ell(0, nl) if sparse else graph.adjacency(0, dev)
        return efhc.init_state(w0, bw, adj0, key, opt_state=opt.init(w0))

    def engine(policy_idx, seeds, idx):
        idx = np.asarray(idx)
        C = len(seeds)
        if len(policy_idx) != C or idx.shape[:3] != (C, T, m):
            raise ValueError(
                f"engine takes C policy indices, C seeds and idx (C, T={T}, "
                f"m={m}, batch); got {len(policy_idx)}, {C}, {idx.shape}")
        cells = triggers.CellPolicies.of(
            [triggers.POLICIES[int(i)] for i in policy_idx], dev)
        if cfg.mix_impl == "sparse_pallas":  # the gather-mix kernel's plan, before the loop
            mixing_ops.prepare_plan(nl.idx)
        # (T, C, m, batch): iteration k's rows of every cell are contiguous
        ix_all = torch.as_tensor(np.ascontiguousarray(np.swapaxes(idx, 0, 1)),
                                 dtype=torch.int64).to(dev)
        alphas = sched(torch.arange(T, device=dev))
        state = init(seeds)
        bw = state.bandwidths
        buf = _Buffers(T, C, m, trace, dev)

        def eval_acc(st):
            if eval_fn is None:
                return torch.zeros(C, dtype=torch.float32, device=dev)
            return eval_fn.device(st.w).float()

        clock = _Clock(dev)
        clock.mark("start")
        for k in range(T):
            ix = ix_all[k]
            state, aux = efhc.step(cfg, graph, state, loss_and_grad=spec.loss_and_grad,
                                   batch=(x_all[ix], y_all[ix]), alpha_k=alphas[k],
                                   model_dim=model_dim, cells=cells, nl=nl,
                                   opt_update=opt.update, dense_aux=dense_aux)
            buf.write(k, aux)
            if k % E == 0:
                # eval after the chunk's first step covers the whole chunk
                buf.ys["acc"][k:k + E] = eval_acc(state)
            if k == 0:
                clock.mark("first")
        clock.mark("end")
        buf.ys["acc"][T - 1] = eval_acc(state)  # the reference's k == T-1 eval
        host = _to_host(buf.ys, bw)
        timing = {"first_step_ms": clock.ms("start", "first"),
                  "ms_per_step": (clock.ms("first", "end") / (T - 1)
                                  if T > 1 else float("nan"))}
        return host, timing

    return engine, model_dim


# The engine cache: ``run``, the sweep and the service take their engine
# from this LRU, so sequential runs over policies and seeds (the service's
# rounds, notebook loops, parity tests) stage the dataset, the eval set and
# the neighbor table on the device once per (config, graph, data, eval,
# device).  The graph enters the key by value (its fields and canonical
# edge list), data and eval by identity; an entry keeps those referents
# alive so a recycled id cannot alias it.


@dataclasses.dataclass
class EngineCacheStats:
    """Point-in-time counters of the engine LRU, the reference's.

    ``hits``/``misses``/``evictions`` are lifetime (they survive
    ``clear()``, reset only by ``reset_stats=True``); ``entries`` and
    ``key_bytes`` describe the current contents (``key_bytes``: the
    edge-list bytes held in the keys)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    entries: int = 0
    key_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": self.entries,
                "key_bytes": self.key_bytes, "hit_rate": self.hit_rate}


def _key_nbytes(key) -> int:
    if isinstance(key, bytes):
        return len(key)
    if isinstance(key, tuple):
        return sum(_key_nbytes(k) for k in key)
    return 0


class EngineCache:
    """LRU of built (engine, model_dim, keepalive) entries with hit/miss
    accounting; supports ``len()`` and ``clear()``."""

    def __init__(self, size: int = 8):
        self.size = size
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def clear(self, *, reset_stats: bool = False) -> None:
        self._d.clear()
        if reset_stats:
            self._hits = self._misses = self._evictions = 0

    def get_or_build(self, key: tuple, build) -> tuple:
        hit = self._d.get(key)
        if hit is None:
            self._misses += 1
            hit = build()
            self._d[key] = hit
            while len(self._d) > self.size:
                self._d.popitem(last=False)
                self._evictions += 1
        else:
            self._hits += 1
            self._d.move_to_end(key)
        return hit

    def stats(self) -> EngineCacheStats:
        return EngineCacheStats(
            hits=self._hits, misses=self._misses, evictions=self._evictions,
            entries=len(self._d),
            key_bytes=sum(_key_nbytes(k) for k in self._d))


_ENGINE_CACHE = EngineCache(size=8)


def engine_cache_stats() -> EngineCacheStats:
    """Snapshot of the engine cache's counters (the scenario service
    reports them per request)."""
    return _ENGINE_CACHE.stats()


def _graph_cache_key(graph: GraphProcess) -> tuple:
    """Value key of a GraphProcess: every field that shapes its adjacency
    stream, the fabric by its canonical (lexsorted) edge list, O(E)."""
    return (graph.kind, float(graph.drop), int(graph.cycle_len),
            int(graph.seed), graph.edges.m,
            graph.edges.u.tobytes(), graph.edges.v.tobytes())


def _cached_engine(sim: SimConfig, graph: GraphProcess, *, T: int,
                   eval_every: int, x, y, eval_fn, device="cuda"):
    """``make_engine``'s ``(engine, model_dim)`` from the engine cache: the
    reference's key fields, and the device."""
    dev = resolve_device(device)
    key = (sim.m, sim.model, sim.n_classes, sim.dim, sim.batch, sim.r,
           sim.b_mean, sim.sigma_n, sim.alpha0, sim.optimizer, sim.mix_impl,
           sim.trace, int(sim.shards), T, max(1, int(eval_every)),
           sim.churn_rate, sim.recover_rate, sim.straggle_rate, sim.bw_walk,
           sim.budget_bytes,
           sim.cluster_fail_rate, sim.cluster_recover_rate,
           int(sim.partition_start), int(sim.partition_len),
           sim.flap_rate, int(sim.flap_len), sim.crash_rate,
           sim.rejoin_rate, bool(sim.warm_start),
           int(sim.watchdog_window), int(sim.watchdog_nprop),
           _graph_cache_key(graph), id(x), id(y), id(eval_fn), str(dev))

    def build():
        eng, model_dim = make_engine(sim, graph, T=T, eval_every=eval_every,
                                     x=x, y=y, eval_fn=eval_fn, device=dev)
        return (eng, model_dim, (graph, x, y, eval_fn))

    hit = _ENGINE_CACHE.get_or_build(key, build)
    return hit[0], hit[1]


def run(
    sim: SimConfig,
    graph: GraphProcess,
    batches: FederatedBatches,
    eval_fn: EvalFn | None = None,
    *,
    eval_every: int = 10,
    engine: str = "scan",
    device="cuda",
) -> SimResult:
    """Simulates ``sim.iters`` universal iterations on ``device``; returns
    ``SimResult``: the one-cell call of the cached engine
    (``_cached_engine``).  The run is deterministic
    given ``sim.seed``, the graph process and the batch sampler's seed, and
    realizes the reference's streams (bandwidths, init, graphs, gossip).
    ``SimResult.timing`` holds the first iteration's ms and the mean ms per
    later iteration on the device's clock.
    """
    if engine == "python":
        raise NotImplementedError(
            "engine='python' is not ported (ROADMAP.md Queue 1 item 4 keeps "
            "only the device-resident engine); use engine='scan'")
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; allowed: ('scan', 'python')")
    if graph.m != sim.m or batches.m != sim.m:
        raise ValueError(f"sim.m={sim.m} but the graph has {graph.m} devices and "
                         f"the sampler {batches.m}")
    eng, model_dim = _cached_engine(sim, graph, T=sim.iters, eval_every=eval_every,
                                    x=batches.x, y=batches.y, eval_fn=eval_fn,
                                    device=device)
    host, timing = eng([triggers.policy_index(sim.policy)], [sim.seed],
                       batches.stage(sim.iters)[None])
    res = result_of_cell(host, 0, model_dim, sim.trace)
    res.timing = timing
    return res
