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

Resource dynamics, fault injection and the B-connectivity watchdog
(``SimConfig.resources()`` / ``.faults()`` / ``.watchdog()``) run inside
the step, each cell on its own streams.  ``run_checkpointed`` cuts the
horizon into segments that drive the same ``_EngineCore.span`` as ``run``
and persists the whole carry between them (``checkpoint.msgpack_ckpt``),
so a run killed between segments resumes bit for bit.

``mix_impl="sharded"`` routes to the sharded fleet engine
(``fl/sharded.py``: the fleet partitioned into ``shards`` shards with a
halo exchange, in one process or across ``torch.distributed`` ranks),
through the same cache.  The python engine is not ported: asking for it
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that brings
it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import efhc, topology, triggers
from repro_torch.core import faults as faults_mod
from repro_torch.core import flow as flow_mod
from repro_torch.core import resources as resources_mod
from repro_torch.core.topology import GraphProcess
from repro_torch.data.loader import FederatedBatches
from repro_torch.fl import modelspec as modelspec_mod
from repro_torch.fl import sharded as sharded_mod
from repro_torch.fl import trace as trace_mod
from repro_torch.kernels.mixing import ops as mixing_ops
from repro_torch.launch.mesh import make_fleet_group
from repro_torch.optim.optimizers import OPT_NAMES, init_opt
from repro_torch.optim.schedules import paper_diminishing
from repro_torch.tree import first_leaf, tree_map

# every mix_impl a SimConfig may name, as in the reference
SIM_MIX_IMPLS: tuple[str, ...] = efhc.MIX_IMPLS + ("sharded",)

@dataclasses.dataclass
class SimConfig:
    """The reference's ``SimConfig``: same fields, defaults and validation
    messages.  ``mix_impl="sharded"`` runs the sharded fleet engine over
    ``shards`` shards (m divisible by it, summary traces only)."""

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
        self.resources()  # ResourceConfig validates the knobs
        self.faults()  # FaultConfig validates the knobs
        self.watchdog()  # WatchdogConfig validates the knobs

    def resources(self) -> resources_mod.ResourceConfig | None:
        """The run's ``ResourceConfig``, or None when every knob is at its
        disabled default.  Its ``seed`` stays 0: the stream derives from
        each cell's root key ``PRNGKey(seed)``, so a batched cell realizes
        its solo run's stream."""
        rcfg = resources_mod.ResourceConfig(
            churn_rate=self.churn_rate, recover_rate=self.recover_rate,
            straggle_rate=self.straggle_rate, bw_walk=self.bw_walk,
            budget_bytes=self.budget_bytes)
        return rcfg if rcfg.enabled else None

    def faults(self) -> faults_mod.FaultConfig | None:
        """The run's ``FaultConfig``, or None when disabled (``seed`` 0, as
        for the resources)."""
        fcfg = faults_mod.FaultConfig(
            cluster_fail_rate=self.cluster_fail_rate,
            cluster_recover_rate=self.cluster_recover_rate,
            partition_start=self.partition_start,
            partition_len=self.partition_len,
            flap_rate=self.flap_rate, flap_len=self.flap_len,
            crash_rate=self.crash_rate, rejoin_rate=self.rejoin_rate,
            warm_start=self.warm_start)
        return fcfg if fcfg.enabled else None

    def watchdog(self) -> flow_mod.WatchdogConfig | None:
        """The run's ``WatchdogConfig``, or None when ``watchdog_window``
        is 0."""
        wcfg = flow_mod.WatchdogConfig(window=self.watchdog_window,
                                       n_prop=self.watchdog_nprop)
        return wcfg if wcfg.enabled else None


@dataclasses.dataclass
class SimResult:
    """Host-side trajectories, the reference's contract (numpy arrays).

    ``comm``/``adj`` are accessors whose storage follows ``trace``.  The
    scenario-dynamics channels (``trace.RESOURCE_CHANNELS``,
    ``FAULT_CHANNELS``, ``WATCHDOG_CHANNELS``) are (T,) per iteration:
    all-zero (all-True for ``window_connected``) for a run without that
    process."""

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

    def per_device(self, w_stack) -> torch.Tensor:
        """Each device's test accuracy, (C, m) for leaves (C, m, ...)."""
        leaf = first_leaf(w_stack)
        cells, m = leaf.shape[:2]
        x, y = self._data(leaf.device)
        # the cells as more devices: one batched forward over C m models
        w = tree_map(efhc.fold_cells, w_stack)
        pred = self._logits_fn(w, x).argmax(-1)  # (C m, n)
        return (pred == y).float().mean(-1).reshape(cells, m)

    def device(self, w_stack) -> torch.Tensor:
        return self.per_device(w_stack).mean(-1)


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
        mix_impl=sim.mix_impl, resources=sim.resources(), faults=sim.faults(),
        watchdog=sim.watchdog())


# the scenario-dynamics channels, (T, C) each, and their value while
# their process is off
_DYN_CHANNELS = {**{f: (torch.int32, 0) for f in trace_mod.RESOURCE_CHANNELS
                    + trace_mod.FAULT_CHANNELS},
                 "window_connected": (torch.bool, 1),
                 "window_needed": (torch.int32, 0)}


class _Buffers:
    """Preallocated device trajectories for a T-iteration span of C cells;
    the adjacency is kept once when the cells share it (``adj_cells`` 1)
    and per cell otherwise."""

    def __init__(self, T: int, C: int, m: int, trace: str, device: torch.device,
                 adj_cells: int = 1):
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.trace = trace
        self.ys = {"loss": z((T, C, m), f32), "tx_time": z((T, C), f32),
                   "util": z((T, C), f32), "v": z((T, C, m), torch.bool),
                   "consensus_err": z((T, C), f32),
                   "comm_count": z((T, C, m), i32), "deg": z((T, C, m), i32),
                   "acc": z((T, C), f32)}
        for name, (dtype, fill) in _DYN_CHANNELS.items():
            self.ys[name] = torch.full((T, C), fill, dtype=dtype, device=device)
        if trace == "full":
            self.ys["comm"] = z((T, C, m, m), torch.bool)
            self.ys["adj"] = z((T, adj_cells, m, m), torch.bool)
        elif trace == "packed":
            w = trace_mod.packed_words(m)
            self.ys["comm"] = z((T, C, m, w), torch.int64)
            self.ys["adj"] = z((T, adj_cells, m, w), torch.int64)

    def write(self, k: int, aux: efhc.StepAux) -> None:
        ys = self.ys
        ys["loss"][k] = aux.loss
        ys["tx_time"][k] = aux.tx_time
        ys["util"][k] = aux.util
        ys["v"][k] = aux.v
        ys["consensus_err"][k] = aux.consensus_err
        ys["comm_count"][k] = aux.comm_count
        ys["deg"][k] = aux.deg
        for name in _DYN_CHANNELS:
            val = getattr(aux, name)
            if val is not None:
                ys[name][k] = val
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


def _to_host(ys: dict) -> dict[str, np.ndarray]:
    """Copies a span's trajectories back, the span's single host sync, as
    (C, T, ...) per cell; ``adj`` is (C', T, ...) with C' = 1 where the
    cells share it."""
    return {k: np.ascontiguousarray(np.moveaxis(v.cpu().numpy(), 1, 0))
            for k, v in ys.items()}


def _cell_ys(host: dict, c: int, trace: str) -> dict[str, np.ndarray]:
    """Cell ``c``'s (T, ...) trajectories of a span's host copy, the link
    matrices in their stored dtype: the reference's per-run ys layout (what
    a checkpoint segment keeps)."""
    link = trace_mod.link_dtype(trace)
    out = {}
    for k, v in host.items():
        if k == "bandwidths":
            continue
        if k == "adj":
            out[k] = v[c if v.shape[0] > 1 else 0].astype(link)
        elif k == "comm":
            out[k] = v[c].astype(link)
        else:
            out[k] = v[c]
    return out


def _result_of_ys(ys: dict, bandwidths: np.ndarray, model_dim: int,
                  trace: str) -> SimResult:
    return SimResult(
        loss=ys["loss"], acc=ys["acc"], tx_time=ys["tx_time"], util=ys["util"],
        v=ys["v"], comm_count=ys["comm_count"], deg=ys["deg"],
        consensus_err=ys["consensus_err"], model_dim=model_dim,
        bandwidths=bandwidths, trace=trace, _comm=ys.get("comm"),
        _adj=ys.get("adj"), **{f: ys[f] for f in _DYN_CHANNELS})


def result_of_cell(host: dict, c: int, model_dim: int, trace: str) -> SimResult:
    """Cell ``c`` of an engine call's host trajectories as a ``SimResult``."""
    return _result_of_ys(_cell_ys(host, c, trace), host["bandwidths"][c],
                         model_dim, trace)


class _Span(NamedTuple):
    state: efhc.EFHCState
    ys: dict  # device trajectories (T_span, C, ...)
    clock: _Clock
    steps: int

    def timing(self) -> dict:
        """The first iteration's ms (with its eval) and the mean ms of the
        later ones; read after the span's host sync."""
        return {"first_step_ms": self.clock.ms("start", "first"),
                "ms_per_step": (self.clock.ms("first", "end") / (self.steps - 1)
                                if self.steps > 1 else float("nan"))}


class _EngineCore:
    """Staging and the step loop behind ``make_engine`` and
    ``run_checkpointed``, the reference's ``_EngineCore``: ``init`` builds
    the cells' carry and ``span`` steps it over iterations [k0, k1).  A
    whole run is ``init`` + one ``span``; a checkpointed run drives the
    same ``span`` over consecutive segments, so it replays the
    uninterrupted run's operations exactly."""

    def __init__(self, sim: SimConfig, graph: GraphProcess, *, T: int,
                 eval_every: int, x, y, eval_fn: EvalFn | None, device):
        if eval_fn is not None and not isinstance(eval_fn, EvalFn):
            raise NotImplementedError(
                "host eval callables need the python engine, which is not "
                "ported; pass an EvalFn (make_eval_fn) or None")
        self.dev = dev = resolve_device(device)
        self.sim, self.graph, self.T = sim, graph, T
        self.m, self.E = sim.m, max(1, int(eval_every))
        if graph.m != self.m:
            raise ValueError(f"sim.m={self.m} but the graph has {graph.m} devices")
        self.trace = trace_mod.check_trace_mode(sim.trace)
        self.spec = model_spec(sim)
        self.opt = init_opt(sim.optimizer)
        self.cfg = cfg = _efhc_cfg(sim)
        self.sparse = cfg.mix_impl in efhc.SPARSE_MIX_IMPLS
        self.sched = paper_diminishing(sim.alpha0, gamma=1.0, theta=0.5)
        self.model_dim = self.spec.flat_dim
        self.eval_fn = eval_fn
        # the watchdog reads the neighbor list under every impl
        host_nl = (graph.neighbors()
                   if self.sparse or cfg.watchdog_enabled() else None)
        self.nl = (topology.StagedNeighbors.from_host(host_nl, dev)
                   if host_nl is not None else None)
        self.fab = self.ftabs = None
        if cfg.faults_enabled():
            self.fab = faults_mod.fault_fabric(graph, cfg.faults)
            self.ftabs = (faults_mod.edge_tables_rows(
                self.fab, graph.edges, host_nl.idx, host_nl.mask, device=dev)
                if self.sparse else
                faults_mod.edge_tables_dense(self.fab, graph.edges, device=dev))
        self.x_all = as_inputs(x).to(dev)
        self.y_all = torch.as_tensor(np.asarray(y), dtype=torch.int64).to(dev)
        self.dense_aux = self.trace != "summary"

    def init(self, seeds) -> efhc.EFHCState:
        """The cells' initial carry: the reference's init stream, cell by
        cell, with the resource and fault streams folded from each cell's
        root key ``PRNGKey(seed)``."""
        m, dev, cfg, sim = self.m, self.dev, self.cfg, self.sim
        roots = torch.stack([prng.PRNGKey(int(s), dev) for s in seeds])
        ks = prng.split(roots, 3)  # (C, 3, 2): k_bw, k_init, k_state
        bw = torch.stack([triggers.sample_bandwidths(k, m, sim.b_mean, sim.sigma_n)
                          for k in ks[:, 0]])
        w0 = tree_map(lambda *ts: torch.stack(ts),
                      *[self.spec.init_stack(k, m) for k in ks[:, 1]])
        adj0 = (self.graph.adjacency_ell(0, self.nl) if self.sparse
                else self.graph.adjacency(0, dev))
        res0 = (resources_mod.init_state(
                    cfg.resources, bw, resources_mod.resource_key(roots, cfg.resources))
                if cfg.resources_enabled() else None)
        f0 = (faults_mod.init_state(cfg.faults, self.fab,
                                    faults_mod.fault_key(roots, cfg.faults))
              if cfg.faults_enabled() else None)
        wd0 = (flow_mod.watchdog_init(m, self.nl.d_max, (len(seeds),), dev)
               if cfg.watchdog_enabled() else None)
        return efhc.init_state(w0, bw, adj0, ks[:, 2].contiguous(),
                               opt_state=self.opt.init(w0), resources=res0,
                               faults=f0, watchdog=wd0)

    def prepare(self) -> None:
        """Per-call set-up before a loop: the gather-mix kernel's plan."""
        if self.cfg.mix_impl == "sparse_pallas":
            mixing_ops.prepare_plan(self.nl.idx)

    def span(self, state: efhc.EFHCState, cells: triggers.CellPolicies,
             idx: np.ndarray, k0: int, k1: int, *, final: bool) -> _Span:
        """Steps ``state`` over iterations [k0, k1), ``idx`` (C, T, m,
        batch) holding the staged rows of the whole horizon.  Eval runs
        after the first step of each ``eval_every`` chunk (k0 is a chunk
        boundary) and, with ``final``, once more after the last step (the
        reference's k == T-1 overwrite)."""
        C, T_span, E, dev = len(cells.names), k1 - k0, self.E, self.dev
        # (T_span, C, m, batch): iteration k's rows of every cell are contiguous
        ix_all = torch.as_tensor(np.ascontiguousarray(np.swapaxes(idx[:, k0:k1], 0, 1)),
                                 dtype=torch.int64).to(dev)
        alphas = self.sched(torch.arange(k0, k1, device=dev))
        buf = _Buffers(T_span, C, self.m, self.trace, dev,
                       adj_cells=C if self.cfg.cell_adjacency() else 1)

        def eval_acc(st):
            if self.eval_fn is None:
                return torch.zeros(C, dtype=torch.float32, device=dev)
            return self.eval_fn.device(st.w).float()

        clock = _Clock(dev)
        clock.mark("start")
        for j in range(T_span):
            ix = ix_all[j]
            state, aux = efhc.step(
                self.cfg, self.graph, state, loss_and_grad=self.spec.loss_and_grad,
                batch=(self.x_all[ix], self.y_all[ix]), alpha_k=alphas[j],
                model_dim=self.model_dim, cells=cells, nl=self.nl,
                opt_update=self.opt.update, dense_aux=self.dense_aux,
                ftabs=self.ftabs)
            buf.write(j, aux)
            if j % E == 0:
                # eval after the chunk's first step covers the whole chunk
                buf.ys["acc"][j:j + E] = eval_acc(state)
            if j == 0:
                clock.mark("first")
        clock.mark("end")
        if final:
            buf.ys["acc"][T_span - 1] = eval_acc(state)
        return _Span(state, buf.ys, clock, T_span)

    def engine(self, policy_idx, seeds, idx):
        """engine(policy_idx, seeds, idx) -> (host trajectories, timing):
        ``make_engine``'s contract."""
        idx = np.asarray(idx)
        C, T, m = len(seeds), self.T, self.m
        if len(policy_idx) != C or idx.shape[:3] != (C, T, m):
            raise ValueError(
                f"engine takes C policy indices, C seeds and idx (C, T={T}, "
                f"m={m}, batch); got {len(policy_idx)}, {C}, {idx.shape}")
        cells = triggers.CellPolicies.of(
            [triggers.POLICIES[int(i)] for i in policy_idx], self.dev)
        self.prepare()
        state = self.init(seeds)
        span = self.span(state, cells, idx, 0, T, final=True)
        host = _to_host(span.ys)
        host["bandwidths"] = state.bandwidths.cpu().numpy()
        return host, span.timing()


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
    trajectories are host numpy arrays with a leading cell axis (C, T,
    ...) (``adj`` (1, T, ...) where the cells share it) and ``bandwidths``
    (C, m); cell ``c`` is ``result_of_cell(out, c, model_dim, sim.trace)``.
    ``timing`` holds the first iteration's ms (with its eval) and the mean
    ms of the later ones on the device's clock.  Returns ``(engine,
    model_dim)``.

    Set ``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) for
    true-fp32 products on the card; TF32 breaks parity with the reference.

    ``mix_impl="sharded"`` builds the sharded engine
    (``fl.sharded.make_sharded_engine``), one cell a call.
    """
    if sim.mix_impl == "sharded":
        eng, model_dim, _plan = sharded_mod.make_sharded_engine(
            sim, graph, T=T, eval_every=eval_every, x=x, y=y, eval_fn=eval_fn,
            device=device)
        return eng, model_dim
    core = _EngineCore(sim, graph, T=T, eval_every=eval_every, x=x, y=y,
                       eval_fn=eval_fn, device=device)
    return core.engine, core.model_dim


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
    """LRU of built (engine core, keepalive) entries with hit/miss
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


def _cached_core(sim: SimConfig, graph: GraphProcess, *, T: int,
                 eval_every: int, x, y, eval_fn, device="cuda"):
    """The ``_EngineCore`` (``fl.sharded.ShardedCore`` under
    ``mix_impl="sharded"``) from the engine cache: the reference's key
    fields, the device, and a sharded engine's process group."""
    dev = resolve_device(device)
    sharded = sim.mix_impl == "sharded"

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
    if sharded:
        key += (make_fleet_group(int(sim.shards)).key(),)

    def build():
        make = sharded_mod.ShardedCore if sharded else _EngineCore
        core = make(sim, graph, T=T, eval_every=eval_every, x=x, y=y,
                    eval_fn=eval_fn, device=dev)
        return (core, (graph, x, y, eval_fn))

    return _ENGINE_CACHE.get_or_build(key, build)[0]


def _cached_engine(sim: SimConfig, graph: GraphProcess, *, T: int,
                   eval_every: int, x, y, eval_fn, device="cuda"):
    """``make_engine``'s ``(engine, model_dim)`` from the engine cache."""
    core = _cached_core(sim, graph, T=T, eval_every=eval_every, x=x, y=y,
                        eval_fn=eval_fn, device=device)
    return core.engine, core.model_dim


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
    later iteration on the device's clock.  ``mix_impl="sharded"`` runs the
    sharded engine (``fl/sharded.py``) from the same cache.
    """
    if sim.mix_impl == "sharded" and (
            engine != "scan" or (eval_fn is not None and not isinstance(eval_fn, EvalFn))):
        raise ValueError(
            "mix_impl='sharded' runs only under engine='scan' with an EvalFn "
            "(or None): the sharded engine cannot call back into a host loop "
            "or a host eval callable")
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


# ---------------------------------------------------------------------------
# crash-safe checkpoint/resume
# ---------------------------------------------------------------------------

class CheckpointHalt(RuntimeError):
    """Raised by ``run_checkpointed(halt_after=...)`` right after a segment
    checkpoint lands: a deterministic stand-in for a crash between
    segments."""


def _on_device(tree, device):
    """A restored tree's numpy leaves as tensors on ``device``."""
    return tree_map(lambda a: None if a is None else torch.from_numpy(a).to(device),
                    tree)


def run_checkpointed(
    sim: SimConfig,
    graph: GraphProcess,
    batches: FederatedBatches,
    eval_fn: EvalFn | None = None,
    *,
    ckpt_dir: str,
    checkpoint_every: int,
    eval_every: int = 10,
    resume: bool = True,
    halt_after: int | None = None,
    device="cuda",
) -> SimResult:
    """Whole-horizon simulation with crash-safe segment checkpoints, the
    reference's contract and on-disk format.

    The horizon is cut into segments of ``checkpoint_every`` iterations (a
    multiple of ``eval_every``, so segments end on eval-chunk boundaries).
    Each segment runs ``_EngineCore.span``, the loop ``run`` runs, then
    persists the whole carry (``EFHCState`` with the optimizer, resource,
    fault and watchdog state), the bandwidths and the segment's
    trajectories as ``<ckpt_dir>/step_<end>.msgpack`` (atomic write, never
    rotated).  With ``resume`` (the default) a later call restores the
    newest carry and runs only the remaining segments; the result equals
    the uninterrupted checkpointed run bit for bit on every channel.
    ``halt_after=n`` raises ``CheckpointHalt`` after ``n`` segments.
    ``FederatedBatches.stage`` draws from the sampler's construction
    seed, so a fresh sampler in a resuming process stages the same rows.

    ``SimResult.timing`` holds, per segment written by this call, its end,
    bytes on disk, ms on the device's clock and save seconds, and the
    restore seconds of a resume."""
    from repro_torch.checkpoint import msgpack_ckpt

    if sim.mix_impl == "sharded":
        raise ValueError(
            "run_checkpointed drives the single-device chunked engine; "
            "mix_impl='sharded' is not checkpointable yet")
    E = max(1, int(eval_every))
    seg = int(checkpoint_every)
    if seg < 1 or seg % E != 0:
        raise ValueError(
            f"checkpoint_every must be a positive multiple of eval_every "
            f"(segment boundaries must fall on eval-chunk boundaries); got "
            f"checkpoint_every={checkpoint_every}, eval_every={eval_every}")
    T = sim.iters
    core = _cached_core(sim, graph, T=T, eval_every=E, x=batches.x, y=batches.y,
                        eval_fn=eval_fn, device=device)
    idx = batches.stage(T)[None]
    cells = triggers.CellPolicies.of([sim.policy], core.dev)
    meta = {"sim": dataclasses.asdict(sim), "T": int(T), "eval_every": int(E),
            "checkpoint_every": int(seg)}
    timing: dict = {"segments": [], "restore_s": None}

    done = 0
    ys_parts: list[dict] = []
    state = bw = None
    if resume:
        t0 = time.perf_counter()
        ends = msgpack_ckpt._steps(ckpt_dir)
        for end in ends:
            payload = msgpack_ckpt.restore(ckpt_dir, end)
            if payload.get("meta") != meta:
                raise ValueError(
                    f"checkpoint {ckpt_dir}/step_{end} was written by a "
                    f"different scenario (sim/T/eval_every/checkpoint_every "
                    f"mismatch); refusing to resume into it")
            ys_parts.append(payload["ys"])
            if end == ends[-1]:
                state = _on_device(payload["state"], core.dev)
                bw = np.asarray(payload["bandwidths"])
                done = int(end)
        if ends:
            timing["restore_s"] = time.perf_counter() - t0
    if state is None:
        state = core.init([sim.seed])
        bw = state.bandwidths[0].cpu().numpy()

    core.prepare()
    segments_run = 0
    while done < T:
        end = min(done + seg, T)
        span = core.span(state, cells, idx, done, end, final=end == T)
        state = span.state
        ys_host = _cell_ys(_to_host(span.ys), 0, sim.trace)
        ys_parts.append(ys_host)
        t0 = time.perf_counter()
        path = msgpack_ckpt.save(
            ckpt_dir, end, {"meta": meta, "end": int(end), "state": state,
                            "bandwidths": bw, "ys": ys_host},
            keep=0)  # keep every segment: earlier ys are part of the result
        timing["segments"].append({
            "end": int(end), "bytes": os.path.getsize(path),
            "save_s": time.perf_counter() - t0,
            "ms_per_step": span.timing()["ms_per_step"]})
        done = end
        segments_run += 1
        if halt_after is not None and segments_run >= halt_after and done < T:
            raise CheckpointHalt(
                f"halted after {segments_run} segment(s) at iteration {done} "
                f"(checkpoint {ckpt_dir}/step_{done}.msgpack)")

    out = {k: np.concatenate([np.asarray(p[k]) for p in ys_parts], axis=0)
           for k in ys_parts[0]}
    res = _result_of_ys(out, bw, core.model_dim, sim.trace)
    res.timing = timing
    return res
