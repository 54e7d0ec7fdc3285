"""Decentralized FL simulator (the paper's Sec. IV experiment harness).

Port of ``repro.fl.simulator`` (the scan engine).  ``run`` simulates
``sim.iters`` universal iterations of EF-HC for m devices and returns the
paper's trajectories as a ``SimResult``.

The reference compiles the horizon as one chunked ``lax.scan``; here it is
a Python loop over ``efhc.step`` that stays on the device:

* batches are pre-staged as (T, m, batch) index arrays
  (``FederatedBatches.stage``) and gathered from the device-resident
  dataset each step;
* every per-iteration metric is written into a preallocated (T, m) / (T,)
  device tensor, and evaluation runs on the device after the first step
  of each ``eval_every`` chunk (iterations 0, E, 2E, ...) and once more
  after the last step (the k = T-1 overwrite);
* nothing in the loop reads a tensor's value on the host, so the host
  syncs once per run, when the trajectories are copied back at the end.

Resource dynamics, fault injection, the watchdog, the sharded engine and
the python engine are not ported yet: a config that asks for one raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import efhc, topology, triggers
from repro_torch.core.topology import GraphProcess
from repro_torch.data.loader import FederatedBatches
from repro_torch.fl import modelspec as modelspec_mod
from repro_torch.fl import trace as trace_mod
from repro_torch.optim.optimizers import OPT_NAMES, init_opt
from repro_torch.optim.schedules import paper_diminishing

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
        if self.model not in modelspec_mod.PORTED_MODELS:
            raise NotImplementedError(
                f"model={self.model!r} is not ported yet (ROADMAP.md Queue 1 "
                f"item 6, real models); the port runs "
                f"{modelspec_mod.PORTED_MODELS}")
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


class EvalFn:
    """Mean test accuracy over devices, computed on the device.

    ``device(w)`` takes the stacked parameter dict and returns a 0-d float32
    tensor without syncing; the test set moves to a device once and is
    cached there.  ``argmax`` ties resolve to the first maximum, as in jax."""

    def __init__(self, logits_fn, x_test: np.ndarray, y_test: np.ndarray):
        self._logits_fn = logits_fn
        self.x_test = np.asarray(x_test, np.float32)
        self.y_test = np.asarray(y_test)
        self._on: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def _data(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        hit = self._on.get(str(device))
        if hit is None:
            hit = (torch.as_tensor(self.x_test).to(device),
                   torch.as_tensor(self.y_test, dtype=torch.int64).to(device))
            self._on[str(device)] = hit
        return hit

    def device(self, w_stack: dict[str, torch.Tensor]) -> torch.Tensor:
        x, y = self._data(next(iter(w_stack.values())).device)
        pred = self._logits_fn(w_stack, x).argmax(-1)  # (m, n)
        return (pred == y).float().mean(-1).mean()


def model_spec(sim: SimConfig) -> modelspec_mod.ModelSpec:
    return modelspec_mod.make_model_spec(sim.model, dim=sim.dim,
                                         n_classes=sim.n_classes)


def make_eval_fn(sim: SimConfig, x_test: np.ndarray, y_test: np.ndarray) -> EvalFn:
    return EvalFn(model_spec(sim).logits, x_test, y_test)


def _efhc_cfg(sim: SimConfig) -> efhc.EFHCConfig:
    return efhc.EFHCConfig(
        trigger=triggers.TriggerConfig(policy=sim.policy, r=sim.r,
                                       b_mean=sim.b_mean),
        mix_impl=sim.mix_impl)


class _Buffers:
    """Preallocated device trajectories for a T-iteration run."""

    def __init__(self, T: int, m: int, trace: str, device: torch.device):
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.trace = trace
        self.ys = {"loss": z((T, m), f32), "tx_time": z(T, f32),
                   "util": z(T, f32), "v": z((T, m), torch.bool),
                   "consensus_err": z(T, f32), "comm_count": z((T, m), i32),
                   "deg": z((T, m), i32), "acc": z(T, f32)}
        if trace == "full":
            self.ys["comm"] = z((T, m, m), torch.bool)
            self.ys["adj"] = z((T, m, m), torch.bool)
        elif trace == "packed":
            w = trace_mod.packed_words(m)
            self.ys["comm"] = z((T, m, w), torch.int64)
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


def _result_from_device(ys: dict, bw: torch.Tensor, model_dim: int,
                        trace: str) -> SimResult:
    """Copies the trajectories back: the run's single host sync."""
    host = {k: v.cpu().numpy() for k, v in ys.items()}
    T = host["acc"].shape[0]
    zeros = np.zeros(T, np.int32)
    link = trace_mod.link_dtype(trace)
    return SimResult(
        loss=host["loss"], acc=host["acc"], tx_time=host["tx_time"],
        util=host["util"], v=host["v"], comm_count=host["comm_count"],
        deg=host["deg"], consensus_err=host["consensus_err"],
        model_dim=model_dim, bandwidths=bw.cpu().numpy(), trace=trace,
        _comm=host["comm"].astype(link) if "comm" in host else None,
        _adj=host["adj"].astype(link) if "adj" in host else None,
        down_count=zeros, exhausted_count=zeros.copy(),
        fault_down_count=zeros.copy(), stale_max=zeros.copy(),
        window_connected=np.ones(T, bool), window_needed=zeros.copy())


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
    ``SimResult``.  The run is deterministic given ``sim.seed``, the graph
    process and the batch sampler's seed, and realizes the reference's
    streams (bandwidths, init, graphs, gossip).

    Set ``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) for
    true-fp32 products on the card; TF32 breaks parity with the reference.
    """
    if engine == "python":
        raise NotImplementedError(
            "engine='python' is not ported (ROADMAP.md Queue 1 item 4 keeps "
            "only the device-resident engine); use engine='scan'")
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; allowed: ('scan', 'python')")
    if eval_fn is not None and not isinstance(eval_fn, EvalFn):
        raise NotImplementedError(
            "host eval callables need the python engine, which is not ported; "
            "pass an EvalFn (make_eval_fn) or None")
    dev = resolve_device(device)
    T, m, E = sim.iters, sim.m, max(1, int(eval_every))
    if graph.m != m or batches.m != m:
        raise ValueError(f"sim.m={m} but the graph has {graph.m} devices and "
                         f"the sampler {batches.m}")
    spec = model_spec(sim)
    opt = init_opt(sim.optimizer)
    cfg = _efhc_cfg(sim)
    sparse = cfg.mix_impl in efhc.SPARSE_MIX_IMPLS
    sched = paper_diminishing(sim.alpha0, gamma=1.0, theta=0.5)
    model_dim = spec.flat_dim
    nl = (topology.StagedNeighbors.from_host(graph.neighbors(), dev)
          if sparse else None)

    idx = torch.as_tensor(batches.stage(T), dtype=torch.int64).to(dev)
    x_all = torch.as_tensor(np.asarray(batches.x, np.float32)).to(dev)
    y_all = torch.as_tensor(np.asarray(batches.y), dtype=torch.int64).to(dev)
    alphas = sched(torch.arange(T, device=dev))

    # the reference's init stream (_EngineCore.init)
    key = prng.PRNGKey(sim.seed, dev)
    k_bw, k_init, k_state = prng.split(key, 3)
    bw = triggers.sample_bandwidths(k_bw, m, sim.b_mean, sim.sigma_n)
    w0 = spec.init_stack(k_init, m)
    adj0 = graph.adjacency_ell(0, nl) if sparse else graph.adjacency(0, dev)
    state = efhc.init_state(w0, bw, adj0, k_state, opt_state=opt.init(w0))

    buf = _Buffers(T, m, sim.trace, dev)
    dense_aux = sim.trace != "summary"

    def eval_acc(st):
        if eval_fn is None:
            return torch.zeros((), dtype=torch.float32, device=dev)
        return eval_fn.device(st.w).float()

    clock = _Clock(dev)
    clock.mark("start")
    for k in range(T):
        batch = (x_all[idx[k]], y_all[idx[k]])
        state, aux = efhc.step(cfg, graph, state, loss_and_grad=spec.loss_and_grad,
                               batch=batch, alpha_k=alphas[k],
                               model_dim=model_dim, nl=nl,
                               opt_update=opt.update, dense_aux=dense_aux)
        buf.write(k, aux)
        if k % E == 0:
            # eval after the chunk's first step covers the whole chunk
            buf.ys["acc"][k:k + E] = eval_acc(state)
        if k == 0:
            clock.mark("first")
    clock.mark("end")
    buf.ys["acc"][T - 1] = eval_acc(state)  # the reference's k == T-1 eval
    res = _result_from_device(buf.ys, bw, model_dim, sim.trace)
    res.timing = {"first_step_ms": clock.ms("start", "first"),
                  "ms_per_step": (clock.ms("first", "end") / (T - 1)
                                  if T > 1 else float("nan"))}
    return res
