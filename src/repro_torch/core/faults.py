"""Correlated fault injection: cluster outages, scripted partitions,
flapping links, crash/rejoin with staleness.

Port of ``repro.core.faults``.  Four mechanisms, evolved inside the run:

* cluster outages -- the fleet is grouped into spatial clusters (the
  clustered fabric's own labels, Morton-order blocks over coords, or
  contiguous id blocks); each cluster carries one up/down Markov bit and a
  down cluster silences every member (edges, triggers and Event 4);
* scripted bridge partition -- every cross-cluster edge is severed for
  ``[partition_start, partition_start + partition_len)``;
* flapping links -- a seeded ``flap_rate`` fraction of base edges follows
  a square wave of half-period ``flap_len`` with a per-edge phase;
* crash/rejoin with staleness -- per-device Markov kill bits; a crashed
  device freezes theta and counts staleness, and with ``warm_start`` a
  rejoining device restarts from the average of its live neighbors.

The stream derives from each cell's root key by ``fold_in`` under its own
salt (``fault_key``); the flap assignment is staging-time host randomness
keyed on ``FaultConfig.seed``, a property of the scenario.  State tensors
lead with the cell axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.topology import EdgeList, GraphProcess, _morton_codes

# fold_in salt separating the fault stream from the engine and resource
# (0x7E50) streams
_STREAM_SALT = 0xFA17

# staleness counter saturation: far beyond any horizon, below int32's max
STALE_CAP = 1 << 30


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static knobs of the correlated-failure process; all defaults mean
    disabled (``enabled`` False) and the step takes the plain path."""

    cluster_fail_rate: float = 0.0  # P(an up cluster goes down) per iteration
    cluster_recover_rate: float = 0.25  # P(a down cluster recovers)
    # every cross-cluster edge is severed for k in [start, start + len);
    # a negative start or zero length disables the window
    partition_start: int = -1
    partition_len: int = 0
    # fraction of base edges marked flapping; a flapping edge is down when
    # ((k // flap_len) + phase) is odd
    flap_rate: float = 0.0
    flap_len: int = 8
    crash_rate: float = 0.0  # per-device Markov kill bits
    rejoin_rate: float = 0.25
    # a rejoining device restarts from the average of its live neighbors
    warm_start: bool = False
    # fault-stream offset and seed of the staging-time flap assignment
    seed: int = 0

    def __post_init__(self):
        for name in ("cluster_fail_rate", "cluster_recover_rate",
                     "flap_rate", "crash_rate", "rejoin_rate"):
            val = getattr(self, name)
            if not 0.0 <= val <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]; got {name}={val}")
        if self.partition_len < 0:
            raise ValueError(
                f"partition_len must be >= 0; got {self.partition_len}")
        if self.flap_len < 1:
            raise ValueError(f"flap_len must be >= 1; got {self.flap_len}")

    @property
    def partition_scripted(self) -> bool:
        return self.partition_start >= 0 and self.partition_len > 0

    @property
    def enabled(self) -> bool:
        return (self.cluster_fail_rate > 0.0 or self.partition_scripted
                or self.flap_rate > 0.0 or self.crash_rate > 0.0)

    @property
    def edge_faults(self) -> bool:
        """True when an edge-level mechanism (partition, flapping) is on."""
        return self.partition_scripted or self.flap_rate > 0.0


class FaultState(NamedTuple):
    """Fault state, each leaf with a leading cell axis."""

    crashed: torch.Tensor  # (C, m) bool
    staleness: torch.Tensor  # (C, m) int32 iterations spent crashed
    cluster_down: torch.Tensor  # (C, n_clusters) bool outage bits
    key: torch.Tensor  # (C, 2) fault PRNG stream


class FaultFabric(NamedTuple):
    """Staging-time (host numpy) structure of the fault process, in
    canonical edge order."""

    labels: np.ndarray  # (m,) int32 cluster label per device
    n_clusters: int
    cross: np.ndarray  # (E,) bool: endpoints in different clusters
    flap: np.ndarray  # (E,) bool: edge marked flapping
    phase: np.ndarray  # (E,) int32 in {0, 1}: flap square-wave phase


class FaultTabs(NamedTuple):
    """One layout's view of the fabric on the run's device: ``labels`` per
    row and the edge tables as (m, m) dense or (R, d_max) ELL slots."""

    labels: torch.Tensor  # (R,) int64
    cross: torch.Tensor  # bool
    flap: torch.Tensor  # bool
    phase: torch.Tensor  # int32


def fault_key(key: torch.Tensor, cfg: FaultConfig) -> torch.Tensor:
    """The fault stream of root key(s) ``key`` (..., 2)."""
    return prng.fold_in(prng.fold_in(key, _STREAM_SALT),
                        int(cfg.seed) & 0x7FFFFFFF)


def _fallback_labels(graph: GraphProcess, n_groups: int) -> np.ndarray:
    """Pseudo-clusters for fabrics without labels: Morton-order blocks over
    device coords when there are coords, else contiguous id blocks."""
    m = graph.m
    if graph.coords is not None:
        order = np.argsort(_morton_codes(graph.coords), kind="stable")
    else:
        order = np.arange(m)
    labels = np.empty(m, np.int32)
    block = -(-m // n_groups)
    labels[order] = (np.arange(m) // block).astype(np.int32)
    return labels


def fault_fabric(graph: GraphProcess, cfg: FaultConfig) -> FaultFabric:
    """Cluster labels, cross-cluster edge marks and the seeded flap
    assignment of a graph (host numpy, O(E))."""
    m = graph.m
    edges = graph.edges
    if graph.labels is not None:
        labels = np.asarray(graph.labels, np.int32)
    else:
        n_groups = max(2, int(round(np.sqrt(m) / 2.0))) if m > 2 else 1
        labels = _fallback_labels(graph, n_groups)
    n_clusters = int(labels.max()) + 1 if m else 1
    cross = labels[edges.u] != labels[edges.v]
    e = edges.n_edges
    if cfg.flap_rate > 0.0:
        rng = np.random.default_rng([int(cfg.seed) & 0x7FFFFFFF, _STREAM_SALT])
        flap = rng.uniform(size=e) < cfg.flap_rate
        phase = rng.integers(0, 2, size=e).astype(np.int32)
    else:
        flap = np.zeros(e, bool)
        phase = np.zeros(e, np.int32)
    return FaultFabric(labels=labels, n_clusters=n_clusters,
                       cross=np.asarray(cross, bool), flap=flap, phase=phase)


def _tabs(labels, cross, flap, phase, device) -> FaultTabs:
    return FaultTabs(
        labels=torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(device),
        cross=torch.as_tensor(cross).to(device),
        flap=torch.as_tensor(flap).to(device),
        phase=torch.as_tensor(phase, dtype=torch.int32).to(device))


def edge_tables_dense(fab: FaultFabric, edges: EdgeList, device="cpu") -> FaultTabs:
    """The fabric's tables in the dense (m, m) layout (symmetric)."""
    m = edges.m

    def scatter(vals, dtype):
        a = np.zeros((m, m), dtype)
        a[edges.u, edges.v] = vals
        a[edges.v, edges.u] = vals
        return a

    return _tabs(fab.labels, scatter(fab.cross, bool), scatter(fab.flap, bool),
                 scatter(fab.phase, np.int32), device)


def edge_tables_rows(fab: FaultFabric, edges: EdgeList, nbr_idx: np.ndarray,
                     nbr_mask: np.ndarray, rows: np.ndarray | None = None,
                     device="cpu") -> FaultTabs:
    """The fabric's tables in ELL layout for the (R, d_max) neighbor-list
    rows ``nbr_idx``/``nbr_mask`` of devices ``rows`` (default all),
    looked up by canonical edge id."""
    m = edges.m
    if rows is None:
        rows = np.arange(m, dtype=np.int64)
    i = np.asarray(rows, np.int64)[:, None]
    j = np.asarray(nbr_idx, np.int64)
    eid = np.minimum(i, j) * m + np.maximum(i, j)
    pos = np.searchsorted(edges.eids(), eid)
    pos = np.clip(pos, 0, max(0, edges.n_edges - 1))
    mask = np.asarray(nbr_mask, bool)

    def take(table, fill, dtype):
        if edges.n_edges == 0:
            return np.full(mask.shape, fill, dtype)
        return np.where(mask, table[pos], fill).astype(dtype)

    return _tabs(fab.labels[np.asarray(rows)], take(fab.cross, False, bool),
                 take(fab.flap, False, bool), take(fab.phase, 0, np.int32), device)


def init_state(cfg: FaultConfig, fab: FaultFabric, key: torch.Tensor,
               rows: np.ndarray | None = None) -> FaultState:
    """Everything up, for key(s) ``key`` (..., 2): one state per key."""
    n = len(fab.labels) if rows is None else int(np.shape(rows)[0])
    lead = tuple(key.shape[:-1])
    dev = key.device
    return FaultState(
        crashed=torch.zeros(lead + (n,), dtype=torch.bool, device=dev),
        staleness=torch.zeros(lead + (n,), dtype=torch.int32, device=dev),
        cluster_down=torch.zeros(lead + (fab.n_clusters,), dtype=torch.bool,
                                 device=dev),
        key=key)


def evolve(cfg: FaultConfig, key: torch.Tensor, crashed: torch.Tensor,
           staleness: torch.Tensor, cluster_down: torch.Tensor, m: int,
           rows: torch.Tensor | None = None):
    """One step of the crash/rejoin and cluster-outage Markov chains.
    Per-device draws are (m,) per key, sliced by ``rows``; cluster draws
    are full.  Returns ``(crashed_new, rejoined, staleness_new,
    cluster_down_new)``."""
    ks = prng.split(key, 3)
    k_crash, k_rejoin, k_cluster = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]

    def take(a):
        return a if rows is None else a[..., rows]

    if cfg.crash_rate > 0.0:
        u_crash = take(prng.uniform(k_crash, (m,)))
        u_rejoin = take(prng.uniform(k_rejoin, (m,)))
        crashed_new = torch.where(crashed, u_rejoin >= cfg.rejoin_rate,
                                  u_crash < cfg.crash_rate)
    else:
        crashed_new = crashed
    rejoined = torch.logical_and(crashed, ~crashed_new)
    staleness_new = torch.where(
        crashed_new, torch.clamp(staleness + 1, max=STALE_CAP),
        torch.zeros_like(staleness))
    if cfg.cluster_fail_rate > 0.0:
        u_cl = prng.uniform(k_cluster, (cluster_down.shape[-1],))
        cluster_down_new = torch.where(cluster_down,
                                       u_cl >= cfg.cluster_recover_rate,
                                       u_cl < cfg.cluster_fail_rate)
    else:
        cluster_down_new = cluster_down
    return crashed_new, rejoined, staleness_new, cluster_down_new


def device_up(crashed: torch.Tensor, cluster_down: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Liveness under faults: not crashed and the cluster not out."""
    return torch.logical_and(~crashed, ~cluster_down[..., labels])


def edge_keep(cfg: FaultConfig, k, tabs: FaultTabs) -> torch.Tensor:
    """Edge survival mask for iteration ``k`` in ``tabs``' layout: a pure
    function of (k, edge), so every layout realizes the same schedule."""
    keep = None
    k = torch.as_tensor(k, device=tabs.cross.device)
    if cfg.partition_scripted:
        active = torch.logical_and(k >= cfg.partition_start,
                                   k < cfg.partition_start + cfg.partition_len)
        keep = ~torch.logical_and(tabs.cross, active)
    if cfg.flap_rate > 0.0:
        wave = torch.remainder(torch.div(k, cfg.flap_len, rounding_mode="floor")
                               + tabs.phase, 2)
        down = torch.logical_and(tabs.flap, wave == 1)
        keep = ~down if keep is None else torch.logical_and(keep, ~down)
    assert keep is not None, "edge_keep called without edge-level faults"
    return keep
