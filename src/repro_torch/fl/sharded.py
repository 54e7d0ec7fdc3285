"""The sharded fleet engine: the simulation with the fleet partitioned
into shards.

Port of ``repro.fl.sharded``.  ``topology.shard_plan`` splits the m devices
into S shards of ms = m / S rows (Morton blocks on a geometric fabric),
each shard runs Events 1-4 on its own rows (``efhc.step_sharded``), and
the rows a shard reads from another arrive by one halo exchange of only
the boundary rows per iteration.  The reference runs the shards inside
``shard_map``, one a device; here a process holds L of them, their rows
stacked, and what crosses shards goes through a ``launch.mesh.ShardGroup``:
on one process (L = S) an index gather, under ``torch.distributed`` (NCCL
across cards, gloo across CPU processes, S / world shards a rank) an
all-gather through the default process group.

Graph realization, triggers, resource and fault draws, mixing order and
the gradient step are global-id keyed, and the fleet's scalars reduce in
global device order, so every channel but ``consensus_err`` (a
hierarchical sum) is the single-device sparse engine's bit for bit, at
every S and every world size.  The gather-mix kernel serves the mix on
the card: one launch an iteration for all local shards, over the stacked
``[own rows ; halo rows]`` buffer.

Trace mode is ``summary`` only: the (m, m) link matrices are what sharding
exists to avoid.  Every rank returns the whole fleet's trajectories, in
global device order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import efhc, topology, triggers
from repro_torch.core import faults as faults_mod
from repro_torch.core import flow as flow_mod
from repro_torch.core import resources as resources_mod
from repro_torch.core.topology import GraphProcess
from repro_torch.fl import trace as trace_mod
from repro_torch.kernels.mixing import ops as mixing_ops
from repro_torch.launch.mesh import make_fleet_group
from repro_torch.optim.optimizers import init_opt
from repro_torch.optim.schedules import paper_diminishing
from repro_torch.tree import tree_map

# per-device channels, (T, n) on a rank until the run's end
_DEVICE_CHANNELS = ("v", "loss", "comm_count", "deg")


class ShardedCore:
    """Staging and the step loop of the sharded engine: the plan, the
    rank's ``ShardCtx``, the dataset and the fault tables on the device,
    built once (the simulator's engine cache keeps it)."""

    def __init__(self, sim, graph: GraphProcess, *, T: int, eval_every: int, x, y,
                 eval_fn, n_shards: int | None = None, device="cuda"):
        from repro_torch.fl import simulator  # deferred: simulator imports this module

        if trace_mod.check_trace_mode(sim.trace) != "summary":
            raise ValueError(
                f"the sharded engine records summary traces only (per-device "
                f"counts); got trace={sim.trace!r} -- full/packed link matrices "
                "are the (m, m) state sharding exists to avoid")
        if eval_fn is not None and not isinstance(eval_fn, simulator.EvalFn):
            raise ValueError(
                "the sharded engine folds evaluation into its device loop; pass "
                "an EvalFn (or None), not a host callable")
        if graph.m != sim.m:
            raise ValueError(f"sim.m={sim.m} but the graph has {graph.m} devices")
        self.sim, self.graph, self.T = sim, graph, T
        self.m, self.E = sim.m, max(1, int(eval_every))
        S = int(sim.shards if n_shards is None else n_shards)
        self.plan = topology.shard_plan(graph.edges, S, coords=graph.coords)
        self.group = make_fleet_group(S)
        self.dev = dev = self.group.device(resolve_device(device))
        self.ctx = efhc.ShardCtx.of(self.plan, self.group.shards, dev)
        self.owned = self.plan.owned[self.group.shards.start:
                                     self.group.shards.stop].reshape(-1)
        self.spec = simulator.model_spec(sim)
        self.opt = init_opt(sim.optimizer)
        self.cfg = cfg = simulator._efhc_cfg(sim)
        self.sched = paper_diminishing(sim.alpha0, gamma=1.0, theta=0.5)
        self.model_dim = self.spec.flat_dim
        self.eval_fn = eval_fn
        self.x_all = simulator.as_inputs(x).to(dev)
        self.y_all = torch.as_tensor(np.asarray(y), dtype=torch.int64).to(dev)
        self.fab = self.ftabs = None
        if cfg.faults_enabled():
            # the local rows' fault tables, keyed by canonical global edge id
            self.fab = faults_mod.fault_fabric(graph, cfg.faults)
            self.ftabs = faults_mod.edge_tables_rows(
                self.fab, graph.edges, self.ctx.nbr_gid.cpu().numpy(),
                self.ctx.mask.cpu().numpy(), rows=self.owned, device=dev)

    def global_order(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) local rows -> (m, ...) of the whole fleet in global
        device order."""
        return self.ctx.global_order(self.group, x)

    def init(self, seed: int) -> efhc.EFHCState:
        """The local rows of the single-device engine's initial carry: the
        fleet-global streams of ``PRNGKey(seed)``, taken at the owned rows."""
        ctx, m, cfg, sim = self.ctx, self.m, self.cfg, self.sim
        root = prng.PRNGKey(int(seed), self.dev)
        k_bw, k_init, k_state = prng.split(root, 3)
        bw = triggers.sample_bandwidths(k_bw, m, sim.b_mean, sim.sigma_n)[ctx.owned]
        w0 = self.spec.init_rows(k_init, m, ctx.owned)
        adj0 = self.graph.adjacency_ell_rows(0, ctx.nbr_gid, ctx.mask, ctx.owned)
        res0 = (resources_mod.init_state(cfg.resources, bw,
                                         resources_mod.resource_key(root, cfg.resources))
                if cfg.resources_enabled() else None)
        f0 = (faults_mod.init_state(cfg.faults, self.fab,
                                    faults_mod.fault_key(root, cfg.faults), rows=self.owned)
              if cfg.faults_enabled() else None)
        wd0 = (flow_mod.watchdog_init(ctx.nbr_loc.shape[0], ctx.nbr_loc.shape[1],
                                      device=self.dev)
               if cfg.watchdog_enabled() else None)
        return efhc.init_state(w0, bw, adj0, k_state, opt_state=self.opt.init(w0),
                               resources=res0, faults=f0, watchdog=wd0)

    def _eval(self, state: efhc.EFHCState) -> torch.Tensor:
        if self.eval_fn is None:
            return torch.zeros((), dtype=torch.float32, device=self.dev)
        # per-device accuracies reduced in global order, as ``EvalFn.device``
        # reduces a cell's (1, m)
        acc = self.eval_fn.per_device(tree_map(lambda t: t[None], state.w))[0]
        return self.global_order(acc)[None].mean(dim=-1)[0].float()

    def run(self, policy: int, seed: int, idx: np.ndarray):
        """One cell over the horizon: ``idx`` (T, m, batch) staged rows in
        global device order.  Returns the trajectories on the device (the
        whole fleet's, in global device order), the run's ``_Clock`` and T."""
        from repro_torch.fl.simulator import _DYN_CHANNELS, _Clock

        T, E, dev, n = self.T, self.E, self.dev, self.ctx.owned.shape[0]
        mixing_ops.prepare_plan(self.ctx.nbr_loc)
        state = self.init(seed)
        # (T, n, batch): the local rows' staged dataset rows
        ix_all = torch.as_tensor(np.ascontiguousarray(np.asarray(idx)[:, self.owned]),
                                 dtype=torch.int64).to(dev)
        alphas = self.sched(torch.arange(T, device=dev))
        f32, i32 = torch.float32, torch.int32
        ys = {"v": torch.zeros((T, n), dtype=torch.bool, device=dev),
              "loss": torch.zeros((T, n), dtype=f32, device=dev),
              "comm_count": torch.zeros((T, n), dtype=i32, device=dev),
              "deg": torch.zeros((T, n), dtype=i32, device=dev),
              **{f: torch.zeros(T, dtype=f32, device=dev)
                 for f in ("tx_time", "util", "consensus_err", "acc")},
              **{f: torch.full((T,), fill, dtype=dtype, device=dev)
                 for f, (dtype, fill) in _DYN_CHANNELS.items()}}
        clock = _Clock(dev)
        clock.mark("start")
        for j in range(T):
            ix = ix_all[j]
            state, aux = efhc.step_sharded(
                self.cfg, self.graph, self.ctx, state, group=self.group,
                loss_and_grad=self.spec.loss_and_grad,
                batch=(self.x_all[ix], self.y_all[ix]), alpha_k=alphas[j],
                model_dim=self.model_dim, m=self.m, policy=policy,
                opt_update=self.opt.update, ftabs=self.ftabs)
            for name, val in aux._asdict().items():
                if val is not None:
                    ys[name][j] = val
            if j % E == 0:
                # eval after the chunk's first step covers the whole chunk
                ys["acc"][j:j + E] = self._eval(state)
            if j == 0:
                clock.mark("first")
        clock.mark("end")
        ys["acc"][T - 1] = self._eval(state)
        for name in _DEVICE_CHANNELS:  # (T, n) -> (T, m), global order
            ys[name] = self.global_order(ys[name].t()).t()
        ys["bandwidths"] = self.global_order(state.bandwidths)
        return ys, clock, T

    def engine(self, policy_idx, seeds, idx):
        """``simulator.make_engine``'s contract for one cell: (host
        trajectories with a leading cell axis of 1, timing).  Sharded runs
        take their cells one at a time, as the reference's do."""
        from repro_torch.fl.simulator import _Span

        idx = np.asarray(idx)
        if len(policy_idx) != 1 or len(seeds) != 1 or idx.shape[:3] != (1, self.T, self.m):
            raise ValueError(
                f"the sharded engine runs one cell a call (sweeps and the service "
                f"run sharded cells one after another): takes 1 policy index, 1 "
                f"seed and idx (1, T={self.T}, m={self.m}, batch); got "
                f"{len(policy_idx)}, {len(seeds)}, {idx.shape}")
        ys, clock, T = self.run(int(policy_idx[0]), int(seeds[0]), idx[0])
        host = {k: v.cpu().numpy()[None] for k, v in ys.items()}
        return host, _Span(None, ys, clock, T).timing()


def make_sharded_engine(sim, graph: GraphProcess, *, T: int, eval_every: int = 10,
                        x: np.ndarray, y: np.ndarray, eval_fn=None,
                        n_shards: int | None = None, device="cuda"):
    """The sharded simulation engine, the reference's ``(engine, model_dim,
    plan)``: ``engine(policy_idx, seeds, idx)`` is ``simulator.
    make_engine``'s contract for one cell, its trajectories in global
    device order.  ``n_shards`` defaults to ``sim.shards``; under
    ``torch.distributed`` it must be a multiple of the world size."""
    core = ShardedCore(sim, graph, T=T, eval_every=eval_every, x=x, y=y,
                       eval_fn=eval_fn, n_shards=n_shards, device=device)
    return core.engine, core.model_dim, core.plan
