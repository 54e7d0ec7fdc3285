"""Time-varying communication graph processes (paper Sec. II-B), in torch.

Port of ``repro.core.topology``.  Staging is edge-list native and host
numpy, copied verbatim from the reference so every builder realizes the
same fabric from the same seed: the cell-list RGG, skip-sampled
Erdős–Rényi, ring, complete, scale-free and clustered builders, and the
padded (ELL) ``NeighborList``.

The per-iteration realization G^(k) runs on the device.  ``GraphProcess``
copies its edge list and neighbor list to the run's device once
(``staged``), and ``adjacency(k)`` / ``adjacency_ell(k, nl)`` then draw the
``edge_dropout`` stream there: the same random-access per-edge uniforms as
the reference (``_edge_uniforms_uv``), keyed on ``fold_in(PRNGKey(seed),
uint32(k))`` and the canonical edge id, so dense and ELL layouts realize
the identical graph with no host round trip.  ``k`` may be a device tensor.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng

# largest m whose canonical edge ids (u * m + v, u < v) fit in int32: at or
# below it the edge_dropout stream folds in the single word lo * m + hi (the
# stream every pinned artifact realized); above it the two-word
# fold_in(fold_in(key, lo), hi) stream
_EID_INT32_MAX_M = 46340


class EdgeList(NamedTuple):
    """Canonical staging representation of an undirected graph.

    ``u``/``v`` - (E,) int32 endpoint arrays with ``u < v`` (one entry per
    undirected edge, no self loops), lexsorted by ``(u, v)`` so the layout
    is deterministic (engine-cache keys hash the raw bytes).
    ``m``       - number of devices.

    Host numpy, setup-time only (like the old dense base adjacency); the
    arrays are copied to the run's device once, by ``GraphProcess.staged``.
    """

    u: np.ndarray
    v: np.ndarray
    m: int

    @property
    def n_edges(self) -> int:
        return int(self.u.shape[0])

    def eids(self) -> np.ndarray:
        """(E,) int64 canonical edge ids ``u * m + v``, ascending (the
        list is lexsorted), so ``np.searchsorted`` finds an edge's row."""
        return self.u.astype(np.int64) * self.m + self.v.astype(np.int64)


def _canonical_edges(u: np.ndarray, v: np.ndarray, m: int) -> EdgeList:
    """Normalize endpoint arrays into the EdgeList contract (u < v,
    lexsorted).  Assumes entries are distinct undirected pairs."""
    u = np.asarray(u).ravel()
    v = np.asarray(v).ravel()
    lo = np.minimum(u, v).astype(np.int32)
    hi = np.maximum(u, v).astype(np.int32)
    order = np.lexsort((hi, lo))
    return EdgeList(u=np.ascontiguousarray(lo[order]),
                    v=np.ascontiguousarray(hi[order]), m=int(m))


def dense_from_edges(edges: EdgeList) -> np.ndarray:
    """Canonical EdgeList -> dense (m, m) bool adjacency (small-m view)."""
    a = np.zeros((edges.m, edges.m), dtype=bool)
    a[edges.u, edges.v] = True
    a[edges.v, edges.u] = True
    return a


def edges_connected(edges: EdgeList) -> bool:
    """Connectivity straight off the edge list: vectorized union-find
    (min-label hooking + pointer jumping), O(E log m)-ish, never the
    (m, m) matrix or a per-node Python DFS."""
    m = edges.m
    if m <= 1:
        return True
    if edges.n_edges == 0:
        return False
    u = edges.u.astype(np.int64)
    v = edges.v.astype(np.int64)
    label = np.arange(m, dtype=np.int64)
    while True:
        prev = label.copy()
        lo = np.minimum(label[u], label[v])
        np.minimum.at(label, u, lo)
        np.minimum.at(label, v, lo)
        while True:  # pointer jumping: hop to the smallest label reached
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if np.array_equal(label, prev):
            break
    # converged: every node's label is the min index in its component
    return bool((label == 0).all())


class NeighborList(NamedTuple):
    """Padded (ELL-style) neighbor list of the static base graph.

    ``idx``  - (m, d_max) int32: row i holds the sorted neighbor indices of
               device i; unused slots are padded with i itself so gathers
               stay in bounds (pad gathers read the device's own row, and
               every consumer multiplies by ``mask`` so the value is inert).
    ``mask`` - (m, d_max) bool: True on real neighbor slots.

    Both arrays are host numpy (setup-time, like the base edge list); they
    are copied to the run's device once.  Every time-varying
    realization G^(k) is a subgraph of the base fabric, so a *static*
    neighbor list plus a per-iteration slot mask (``GraphProcess.
    adjacency_ell``) represents any G^(k) exactly.
    """

    idx: np.ndarray
    mask: np.ndarray

    @property
    def m(self) -> int:
        return int(self.idx.shape[0])

    @property
    def d_max(self) -> int:
        return int(self.idx.shape[1])


def neighbor_list_from_edges(edges: EdgeList) -> NeighborList:
    """Vectorized ELL construction from the canonical edge list: bucket both
    edge directions by source row (lexsort + bincount + one fancy-indexed
    scatter), O(E log E) with no per-row Python loop.  d_max is the base
    graph's maximum degree (>= 1 so the arrays are never zero-width even on
    an edgeless graph); rows list neighbors in ascending order, exactly the
    layout the old per-row ``np.nonzero`` loop produced."""
    m = edges.m
    src = np.concatenate([edges.u, edges.v]).astype(np.int64)
    dst = np.concatenate([edges.v, edges.u]).astype(np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=m).astype(np.int64)
    d_max = max(1, int(deg.max()) if deg.size else 1)
    idx = np.tile(np.arange(m, dtype=np.int32)[:, None], (1, d_max))
    mask = np.zeros((m, d_max), dtype=bool)
    if src.size:
        starts = np.cumsum(deg) - deg
        slot = np.arange(src.size, dtype=np.int64) - np.repeat(starts, deg)
        idx[src, slot] = dst.astype(np.int32)
        mask[src, slot] = True
    return NeighborList(idx=idx, mask=mask)


# ---------------------------------------------------------------------------
# Edge-list-native builders, the reference's own: every builtin kind stages
# through these, and each realizes the reference's fabric from the same seed.
# ---------------------------------------------------------------------------

def ring_edges(m: int) -> EdgeList:
    """Static ring: always connected (B1 = 1).  O(m)."""
    if m <= 1:
        e = np.empty(0, np.int32)
        return EdgeList(u=e, v=e.copy(), m=m)
    if m == 2:
        return EdgeList(u=np.array([0], np.int32), v=np.array([1], np.int32), m=2)
    u = np.arange(m - 1, dtype=np.int32)
    v = u + 1
    return _canonical_edges(np.concatenate([u, [0]]), np.concatenate([v, [m - 1]]), m)


def complete_edges(m: int) -> EdgeList:
    """All m(m-1)/2 pairs in canonical row-major order, built without the
    (m, m) matrix np.triu_indices would allocate."""
    if m <= 1:
        e = np.empty(0, np.int32)
        return EdgeList(u=e, v=e.copy(), m=m)
    counts = np.arange(m - 1, 0, -1, dtype=np.int64)  # row u has m-1-u pairs
    u = np.repeat(np.arange(m - 1, dtype=np.int64), counts)
    starts = np.cumsum(counts) - counts
    v = np.arange(u.size, dtype=np.int64) - starts[u] + u + 1
    return EdgeList(u=u.astype(np.int32), v=v.astype(np.int32), m=m)


def _rgg_edges_at_radius(pts: np.ndarray, r: float) -> EdgeList:
    """All pairs with ||p_i - p_j||^2 <= r^2 via a spatial-hash cell list.

    Candidates come from each point's 3x3 cell neighborhood (cell side
    >= r), then the exact same float64 expression the dense constructor
    evaluates -- ``((p_i - p_j) ** 2).sum(-1) <= r * r`` -- filters them, so
    the kept edge set is bit-identical to the dense realization at
    O(m + E) expected cost instead of O(m^2).

    The grid is capped at ~sqrt(m) cells per side: correctness only needs
    the cell side >= r (a coarser grid just widens the candidate set), and
    an uncapped 1/r grid would allocate O(1/r^2) cell bookkeeping -- GBs
    for a tiny user-supplied radius on a small fleet."""
    m = pts.shape[0]
    ncell = max(1, min(int(np.floor(1.0 / r)) if r > 0 else 1,
                       int(np.sqrt(m)) + 1))
    cx = (pts[:, 0] * ncell).astype(np.int64)  # uniform draws live in [0, 1)
    cy = (pts[:, 1] * ncell).astype(np.int64)
    cell = cx * ncell + cy
    order = np.argsort(cell, kind="stable")
    starts = np.searchsorted(cell[order], np.arange(ncell * ncell + 1))
    ar = np.arange(m, dtype=np.int64)
    ii_parts: list[np.ndarray] = []
    jj_parts: list[np.ndarray] = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tx, ty = cx + dx, cy + dy
            valid = (tx >= 0) & (tx < ncell) & (ty >= 0) & (ty < ncell)
            tcell = np.where(valid, tx * ncell + ty, 0)
            n = np.where(valid, starts[tcell + 1] - starts[tcell], 0)
            if not n.any():
                continue
            ii = np.repeat(ar, n)
            off = np.arange(ii.size, dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
            jj = order[np.repeat(np.where(valid, starts[tcell], 0), n) + off]
            keep = ii < jj  # each unordered pair surfaces once per direction
            ii_parts.append(ii[keep])
            jj_parts.append(jj[keep])
    if not ii_parts:
        e = np.empty(0, np.int32)
        return EdgeList(u=e, v=e.copy(), m=m)
    ii = np.concatenate(ii_parts)
    jj = np.concatenate(jj_parts)
    d2 = ((pts[ii] - pts[jj]) ** 2).sum(-1)
    sel = d2 <= r * r
    return _canonical_edges(ii[sel], jj[sel], m)


def random_geometric_graph(m: int, radius: float, seed: int) -> tuple[EdgeList, np.ndarray]:
    """Random geometric graph on the unit square (paper Sec. IV-A uses RGG
    with connectivity 0.4), staged as an edge list via the cell-list sweep.
    Retries with a growing radius until connected so Assumption 8-(a) holds
    with B1 = 1 for the base graph.  Same point draw, radius ladder and
    per-pair float comparison as the legacy dense constructor, so the
    realization is bit-for-bit identical -- only the staging cost changes.

    Returns ``(edges, points)``: the (m, 2) device positions are what the
    sharded fleet engine's spatial partitioner keys on (``shard_plan``) --
    they carry no randomness beyond the edge draw itself."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(m, 2))
    r = radius
    for _ in range(64):
        edges = _rgg_edges_at_radius(pts, r)
        if edges_connected(edges):
            return edges, pts
        r *= 1.15
    raise RuntimeError("could not build a connected RGG")


def _bernoulli_indices(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    """Indices in [0, n) kept independently with probability p, drawn via
    geometric gap (skip) sampling: O(n p) draws and memory, never an
    n-vector of uniforms."""
    if n <= 0 or p <= 0.0:
        return np.empty(0, np.int64)
    if p >= 1.0:
        return np.arange(n, dtype=np.int64)
    est = int(n * p + 6.0 * np.sqrt(n * p) + 16.0)
    chunks: list[np.ndarray] = []
    pos = -1
    while pos < n:
        idx = pos + np.cumsum(rng.geometric(p, size=est))
        chunks.append(idx)
        pos = int(idx[-1])
    idx = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    return idx[idx < n]


def _decode_pair_index(lin: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major upper-triangle linear index -> (u, v) endpoint arrays."""
    counts = np.arange(m - 1, -1, -1, dtype=np.int64)  # pairs in row u
    row_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    u = np.searchsorted(row_start, lin, side="right") - 1
    v = lin - row_start[u] + u + 1
    return u.astype(np.int32), v.astype(np.int32)


def erdos_renyi_edges(m: int, p: float, seed: int) -> EdgeList:
    """Edge-sampled G(m, p): each of the m(m-1)/2 pairs is present
    independently with probability p, drawn by skip sampling over the pair
    indices -- O(E) cost, no (m, m) uniform field.  The distribution matches
    the old dense constructor; the realization stream changed when staging
    went edge-native (nothing in the repo pins ER realizations -- the golden
    trajectory and benchmarks run on RGG, which *is* bit-preserved)."""
    rng = np.random.default_rng(seed)
    n_pairs = m * (m - 1) // 2
    for _ in range(64):
        lin = _bernoulli_indices(rng, n_pairs, min(1.0, p))
        u, v = _decode_pair_index(lin, m)
        edges = EdgeList(u=u, v=v, m=m)  # lin ascending => already canonical
        if edges_connected(edges):
            return edges
        p = min(1.0, p * 1.2)
    raise RuntimeError("could not build a connected ER graph")


def _dedup_canonical(u: np.ndarray, v: np.ndarray, m: int) -> EdgeList:
    """Endpoint arrays (possibly with duplicates / self loops from composed
    construction rules) -> canonical EdgeList.  np.unique on the linear pair
    id both dedups and yields the lexsorted (u, v) order."""
    u = np.asarray(u, np.int64).ravel()
    v = np.asarray(v, np.int64).ravel()
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi
    lin = np.unique(lo[keep] * m + hi[keep])
    return EdgeList(u=(lin // m).astype(np.int32),
                    v=(lin % m).astype(np.int32), m=int(m))


def scale_free_edges(m: int, m_attach: int = 2, seed: int = 0) -> EdgeList:
    """Scale-free fabric via Barabási–Albert preferential attachment: start
    from a clique on ``m_attach + 1`` seed nodes, then each new node attaches
    to ``m_attach`` *distinct* existing nodes drawn degree-proportionally
    (uniform sampling from the repeated-endpoints pool -- every edge
    contributes both endpoints, so pool frequency == degree).  Hub-heavy
    degree distributions are the complex-network regime of Valerio et al.
    (arXiv:2312.04504).  Connected by construction (every node has a path to
    the seed clique), O(E) staging."""
    if m <= 1:
        e = np.empty(0, np.int32)
        return EdgeList(u=e, v=e.copy(), m=m)
    rng = np.random.default_rng(seed)
    m_attach = max(1, min(int(m_attach), m - 1))
    m0 = m_attach + 1
    if m <= m0:
        return complete_edges(m)
    seed_edges = complete_edges(m0)
    n_new = (m - m0) * m_attach
    pool = np.empty(2 * (seed_edges.n_edges + n_new), np.int64)
    n_pool = 2 * seed_edges.n_edges
    pool[0:n_pool:2] = seed_edges.u
    pool[1:n_pool:2] = seed_edges.v
    new_u = np.repeat(np.arange(m0, m, dtype=np.int64), m_attach)
    new_v = np.empty(n_new, np.int64)
    e = 0
    for node in range(m0, m):
        targets: set[int] = set()
        while len(targets) < m_attach:  # resample until distinct
            targets.add(int(pool[int(rng.integers(n_pool))]))
        for t in sorted(targets):
            new_v[e] = t
            pool[n_pool] = node
            pool[n_pool + 1] = t
            n_pool += 2
            e += 1
    u = np.concatenate([seed_edges.u.astype(np.int64), new_u])
    v = np.concatenate([seed_edges.v.astype(np.int64), new_v])
    return _canonical_edges(u, v, m)


def clustered_edges(m: int, n_clusters: int = 0,
                    seed: int = 0) -> tuple[EdgeList, np.ndarray, np.ndarray]:
    """Location-clustered hierarchical D2D fabric: devices drawn uniformly on
    the unit square are k-means clustered (a few vectorized Lloyd rounds);
    inside each cluster every device links to the cluster head (the member
    nearest the centroid) plus its nearest same-cluster neighbor (the D2D
    short link); cluster heads form the backhaul -- a ring over heads plus a
    nearest-other-head bridge each.  ``n_clusters <= 0`` picks ~sqrt(m)/2.
    Connected by construction (member -> head star, heads ringed).  Returns
    ``(edges, points, labels)``; the positions feed the sharded engine's
    Morton partitioner (like the RGG builder) and the (m,) int32 cluster
    labels feed the correlated fault process (``core.faults``: cluster
    outages and bridge partitions are keyed off this very assignment)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(m, 2))
    if m <= 2:
        return ring_edges(m), pts, np.zeros(m, np.int32)
    k = int(n_clusters) if n_clusters > 0 else max(2, int(round(np.sqrt(m) / 2.0)))
    k = min(k, m)
    centers = pts[rng.choice(m, size=k, replace=False)].copy()
    for _ in range(8):
        d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = d2.argmin(axis=1)
        for c in range(k):
            sel = labels == c
            if sel.any():
                centers[c] = pts[sel].mean(axis=0)
    d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    labels = d2.argmin(axis=1)

    us: list[np.ndarray] = []
    vs: list[np.ndarray] = []
    heads: list[int] = []
    for c in range(k):
        members = np.nonzero(labels == c)[0]
        if members.size == 0:
            continue
        head = int(members[d2[members, c].argmin()])
        heads.append(head)
        others = members[members != head]
        if others.size:
            us.append(others)  # star to the cluster head
            vs.append(np.full(others.size, head, np.int64))
        if members.size >= 2:  # nearest same-cluster neighbor (D2D link)
            local = ((pts[members][:, None, :]
                      - pts[members][None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(local, np.inf)
            us.append(members)
            vs.append(members[local.argmin(axis=1)])
    heads_arr = np.asarray(heads, np.int64)
    if heads_arr.size >= 2:
        us.append(heads_arr)  # backhaul ring over heads
        vs.append(np.roll(heads_arr, -1))
        hd = ((pts[heads_arr][:, None, :]
               - pts[heads_arr][None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(hd, np.inf)
        us.append(heads_arr)  # nearest-other-head bridges
        vs.append(heads_arr[hd.argmin(axis=1)])
    return (_dedup_canonical(np.concatenate(us), np.concatenate(vs), m), pts,
            labels.astype(np.int32))


def _morton_codes(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) codes of (m, 2) unit-square points: the quantized
    coordinate bits interleaved, so equal-count splits of the order are
    spatially compact groups."""
    q = np.clip((np.asarray(coords) * (1 << bits)).astype(np.uint64),
                0, (1 << bits) - 1)
    code = np.zeros(len(q), dtype=np.uint64)
    for b in range(bits):
        code |= ((q[:, 0] >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        code |= ((q[:, 1] >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
    return code


def scatter_ell(nbr_idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(..., m, d_max) ELL slot values over one (m, d_max) table -> dense
    (..., m, m) with zero diagonal.

    Padded slots point at the row's own index and carry zero/False values
    (the ``NeighborList`` contract), and no real slot repeats a column, so
    a plain indexed write gives the reference's max/add scatter."""
    m = nbr_idx.shape[0]
    rows = torch.arange(m, device=nbr_idx.device)[:, None].expand_as(nbr_idx)
    out = torch.zeros(vals.shape[:-2] + (m, m), dtype=vals.dtype, device=vals.device)
    out[..., rows, nbr_idx] = vals
    return out


def _edge_uniforms(key: torch.Tensor, eids: torch.Tensor) -> torch.Tensor:
    """U[0,1) per canonical edge id, random-access: ``uniform(fold_in(key,
    eid))`` for every id at once (ids are folded in as uint32)."""
    return prng.uniform(prng.fold_in(key, eids))


def _edge_uniforms_uv(key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      m: int) -> torch.Tensor:
    """Per-edge uniforms keyed on the canonical endpoint pair ``(lo, hi)``:
    the single int32 word ``lo * m + hi`` for m <= 46340, the nested
    ``fold_in(fold_in(key, lo), hi)`` above that."""
    if m <= _EID_INT32_MAX_M:
        return _edge_uniforms(key, lo * m + hi)
    lo, hi = torch.broadcast_tensors(lo, hi)
    return prng.uniform(prng.fold_in(prng.fold_in(key, lo), hi))


class _Staged(NamedTuple):
    """A ``GraphProcess``'s constants on one device."""

    key: torch.Tensor  # (2,) PRNGKey(seed)
    u: torch.Tensor  # (E,) int64 canonical edge endpoints, u < v
    v: torch.Tensor
    base: torch.Tensor | None  # (m, m) bool dense fabric (static /
    # partition_cycle dense realizations only)


@dataclasses.dataclass(frozen=True)
class GraphProcess:
    """A seeded time-varying graph process over a canonical ``EdgeList``.

    ``kind``: 'static' (G^(k) = base), 'edge_dropout' (each base edge kept
    w.p. 1 - drop, redrawn every k) or 'partition_cycle' (edges with
    (i + j) % cycle_len == k % cycle_len)."""

    edges: EdgeList
    kind: str = "static"
    drop: float = 0.0
    cycle_len: int = 1
    seed: int = 0
    coords: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)
    labels: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.kind not in ("static", "edge_dropout", "partition_cycle"):
            raise ValueError(f"unknown graph process kind: {self.kind}")
        object.__setattr__(self, "_staged", {})

    @property
    def m(self) -> int:
        return int(self.edges.m)

    @property
    def base(self) -> np.ndarray:
        """Dense (m, m) bool host view of the fabric (small m only)."""
        return dense_from_edges(self.edges)

    def neighbors(self) -> NeighborList:
        return neighbor_list_from_edges(self.edges)

    def staged(self, device) -> _Staged:
        """The process's constants on ``device``, copied once and cached."""
        dev = torch.device(device)
        hit = self._staged.get(str(dev))
        if hit is None:
            dense = self.kind != "edge_dropout"
            hit = _Staged(
                key=prng.PRNGKey(self.seed, dev),
                u=torch.as_tensor(self.edges.u, dtype=torch.int64).to(dev),
                v=torch.as_tensor(self.edges.v, dtype=torch.int64).to(dev),
                base=(torch.as_tensor(self.base).to(dev) if dense else None))
            self._staged[str(dev)] = hit
        return hit

    def adjacency(self, k, device) -> torch.Tensor:
        """Dense (m, m) bool G^(k) on ``device``."""
        st = self.staged(device)
        if self.kind == "static":
            return st.base
        m = self.m
        if self.kind == "edge_dropout":
            keep = _edge_uniforms_uv(prng.fold_in(st.key, k), st.u, st.v, m) >= self.drop
            a = torch.zeros((m, m), dtype=torch.bool, device=st.u.device)
            a[st.u, st.v] = keep
            a[st.v, st.u] = keep
            return a
        i = torch.arange(m, device=st.u.device)
        keep = (i[:, None] + i[None, :]) % self.cycle_len == torch.remainder(
            torch.as_tensor(k, device=st.u.device), self.cycle_len)
        return torch.logical_and(st.base, keep)

    def adjacency_ell(self, k, nl: "StagedNeighbors") -> torch.Tensor:
        """G^(k) as a (m, d_max) bool slot mask over the static neighbor
        list, realization-exact vs ``adjacency``: the all-rows call of
        ``adjacency_ell_rows``."""
        return self.adjacency_ell_rows(
            k, nl.idx, nl.mask, torch.arange(self.m, device=nl.idx.device))

    def adjacency_ell_rows(self, k, idx: torch.Tensor, mask: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
        """``adjacency_ell`` for an arbitrary row subset: ``idx``/``mask``
        are the (R, d_max) neighbor-list rows of the global devices
        ``rows`` (R,), and the slot mask equals those rows of the full
        ``adjacency_ell``.  The per-edge draw is keyed on the canonical
        global edge id, never on array position, so a shard that realizes
        only its own rows draws the single-device engine's G^(k)."""
        if self.kind == "static":
            return mask
        i = rows.to(idx.dtype)[:, None]
        if self.kind == "partition_cycle":
            phase = torch.remainder(torch.as_tensor(k, device=idx.device),
                                    self.cycle_len)
            return torch.logical_and(mask, (i + idx) % self.cycle_len == phase)
        st = self.staged(idx.device)
        keep = _edge_uniforms_uv(prng.fold_in(st.key, k), torch.minimum(i, idx),
                                 torch.maximum(i, idx), self.m) >= self.drop
        return torch.logical_and(mask, keep)


class StagedNeighbors(NamedTuple):
    """A ``NeighborList`` on the run's device: idx (m, d_max) int64 and
    mask (m, d_max) bool."""

    idx: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_host(cls, nl: NeighborList, device) -> "StagedNeighbors":
        return cls(idx=torch.as_tensor(nl.idx, dtype=torch.int64).to(device),
                   mask=torch.as_tensor(nl.mask).to(device))

    @property
    def d_max(self) -> int:
        return int(self.idx.shape[1])


# ---------------------------------------------------------------------------
# Sharded-fleet partition: the m devices split into equal shards, and the
# halo-exchange tables of the sharded engine.  Host numpy, set-up time,
# O(E log E); the reference's tables entry for entry.
# ---------------------------------------------------------------------------

class ShardPlan(NamedTuple):
    """Static fleet partition and halo-exchange tables for ``n_shards``
    shards.

    Shard ``s`` owns the ``ms = m / n_shards`` devices ``owned[s]`` (global
    ids: Morton order when the graph has coordinates, contiguous id blocks
    otherwise).  Each owned row's slots are remapped into the shard's
    buffer ``[own rows ; halo rows]`` (``nbr_loc``), so one gather serves
    local and cross-shard neighbors.  The halo comes from one all-gather of
    each shard's boundary rows (rows with a cross-shard edge): shard ``s``
    sends ``payload[send_idx[s]]`` (padded to ``B_max``) and reads its halo
    out of the gathered (S, B_max) rows at the flat positions
    ``recv_src[s]`` (padded to ``H_max``).  Pads point at local row 0 /
    flat position 0; every consumer masks or zero-weights them."""

    n_shards: int
    ms: int  # devices per shard (m = n_shards * ms)
    d_max: int
    owned: np.ndarray  # (S, ms) int32 global ids owned by each shard
    inv_perm: np.ndarray  # (m,) int32 global id -> row in shard-major order
    nbr_gid: np.ndarray  # (S, ms, d_max) int32 global neighbor ids
    nbr_loc: np.ndarray  # (S, ms, d_max) int32 index into [own; halo]
    mask: np.ndarray  # (S, ms, d_max) bool real-neighbor slots
    send_idx: np.ndarray  # (S, B_max) int32 local rows sent to the exchange
    recv_src: np.ndarray  # (S, H_max) int32 flat (S * B_max) positions
    n_send: np.ndarray  # (S,) int32 real boundary rows
    n_halo: np.ndarray  # (S,) int32 real halo rows

    @property
    def m(self) -> int:
        return self.n_shards * self.ms

    @property
    def b_max(self) -> int:
        return int(self.send_idx.shape[1])

    @property
    def h_max(self) -> int:
        return int(self.recv_src.shape[1])

    @property
    def boundary_frac(self) -> float:
        """The share of the fleet exchanged each iteration: the halo
        exchange's volume against a whole-fleet all-gather."""
        return float(self.n_send.sum()) / max(1, self.m)


def shard_plan(edges: EdgeList, n_shards: int, *,
               coords: np.ndarray | None = None) -> ShardPlan:
    """Partitions the fleet into ``n_shards`` equal shards and builds the
    halo-exchange tables: Morton-order blocks with ``coords`` (spatially
    compact, so a thin boundary crosses shards), contiguous id blocks
    without (a ring's best, a fallback elsewhere).  Nothing densifies an
    (m, m) matrix."""
    m = edges.m
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1; got {n_shards}")
    if m % n_shards:
        raise ValueError(
            f"sharded fleet needs m divisible by n_shards; got m={m}, "
            f"n_shards={n_shards}")
    ms = m // n_shards
    if coords is not None and n_shards > 1:
        perm = np.argsort(_morton_codes(coords), kind="stable").astype(np.int32)
    else:
        perm = np.arange(m, dtype=np.int32)
    owned = perm.reshape(n_shards, ms)
    inv_perm = np.empty(m, np.int32)
    inv_perm[perm] = np.arange(m, dtype=np.int32)
    shard_of = inv_perm // ms  # global id -> owning shard
    loc_of = inv_perm % ms  # global id -> local row in its shard

    nl = neighbor_list_from_edges(edges)
    nbr_gid = nl.idx[owned]  # (S, ms, d_max)
    mask = nl.mask[owned]

    # each shard's halo: the sorted remote endpoints of its real slots
    halos: list[np.ndarray] = []
    for s in range(n_shards):
        j = nbr_gid[s][mask[s]]
        halos.append(np.unique(j[shard_of[j] != s]).astype(np.int32))
    # each shard's sends: every owned row another shard needs, sorted by
    # global id so receivers find their positions by binary search
    all_halo = (np.concatenate(halos) if any(h.size for h in halos)
                else np.empty(0, np.int32))
    sends = [np.unique(all_halo[shard_of[all_halo] == t]).astype(np.int32)
             for t in range(n_shards)]

    b_max = max(1, max((s.size for s in sends), default=0))
    h_max = max(1, max((h.size for h in halos), default=0))
    send_idx = np.zeros((n_shards, b_max), np.int32)
    recv_src = np.zeros((n_shards, h_max), np.int32)
    nbr_loc = np.empty_like(nbr_gid)
    for s in range(n_shards):
        send_idx[s, : sends[s].size] = loc_of[sends[s]]
        # halo row h sits at flat position t * b_max + (rank of h in send_t)
        t = shard_of[halos[s]]
        pos = np.empty(halos[s].size, np.int64)
        for tt in np.unique(t):
            sel = t == tt
            pos[sel] = np.searchsorted(sends[tt], halos[s][sel])
        recv_src[s, : halos[s].size] = (t.astype(np.int64) * b_max + pos).astype(np.int32)
        # slots: own rows -> local index, remote rows -> ms + halo rank
        j = nbr_gid[s]
        local = shard_of[j] == s
        nbr_loc[s] = np.where(
            local, loc_of[j],
            ms + np.searchsorted(halos[s], j).astype(np.int32)).astype(np.int32)

    return ShardPlan(
        n_shards=n_shards, ms=ms, d_max=nl.d_max, owned=owned.astype(np.int32),
        inv_perm=inv_perm, nbr_gid=nbr_gid, nbr_loc=nbr_loc, mask=mask,
        send_idx=send_idx, recv_src=recv_src,
        n_send=np.asarray([s.size for s in sends], np.int32),
        n_halo=np.asarray([h.size for h in halos], np.int32),
    )


def fleet_radius(m: int) -> float:
    """RGG radius ladder shared by the fleet benchmark and examples: the
    paper's 0.4 for small fleets, 0.15 mid-scale, then degree-targeted
    (expected degree m*pi*r^2 pinned at ~24, i.e. a fixed radio range) so
    large fleets stay physically sparse instead of growing degree linearly
    with m -- the regime where neighbor-list mixing pays."""
    if m <= 64:
        return 0.4
    if m <= 256:
        return 0.15
    return float(np.sqrt(24.0 / (np.pi * m)))



def make_process(
    m: int,
    topology: str = "rgg",
    *,
    time_varying: str = "static",
    radius: float = 0.4,
    er_p: float = 0.4,
    drop: float = 0.3,
    cycle_len: int = 2,
    m_attach: int = 2,
    n_clusters: int = 0,
    seed: int = 0,
) -> GraphProcess:
    """Same factory, same seeds as the reference: the fabric from the
    edge-list builder, the process seeded with ``seed + 1``."""
    coords = None
    labels = None
    if topology == "rgg":
        edges, coords = random_geometric_graph(m, radius, seed)
    elif topology == "er":
        edges = erdos_renyi_edges(m, er_p, seed)
    elif topology == "ring":
        edges = ring_edges(m)
    elif topology == "complete":
        edges = complete_edges(m)
    elif topology == "scale_free":
        edges = scale_free_edges(m, m_attach=m_attach, seed=seed)
    elif topology == "clustered":
        edges, coords, labels = clustered_edges(m, n_clusters=n_clusters,
                                                seed=seed)
    else:
        raise ValueError(f"unknown topology: {topology}")
    return GraphProcess(edges=edges, kind=time_varying, drop=drop,
                        cycle_len=cycle_len, seed=seed + 1, coords=coords,
                        labels=labels)
