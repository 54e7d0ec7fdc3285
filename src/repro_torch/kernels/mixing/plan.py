"""Row-group plan of the gather-mix kernels (``csrc/mix_sparse.cu``).

A staged kernel takes, for one group of rows and one column chunk of
``w``, every row the group reads (its own rows and every slot's
``nbr_idx``, pads included) into shared memory, then mixes the group's
rows from there.  The plan says which rows form each group and where each
slot's row sits in its group's staged union.  It depends on the static
neighbor list alone, so a run builds it once, on the host, in numpy.

A table takes one of two staged tiers, by its d_max:

- ``mix_sparse_kernel`` (``CHUNK`` = 128 columns): the block keeps its
  rows' slot lists in shared memory beside the slab, so its row cap falls
  as d_max grows (``limits``).  Tables where it still admits groups of at
  least ``ROWS_MAX // 2`` rows (d_max <= 109; the fleet fabrics) take it.
- ``mix_sparse_wide_kernel`` (64 columns, two a lane, or 32, one a
  lane): the slot lists stay in device memory, so a group holds up to
  ``WIDE_ROWS_MAX`` rows and its union up to ``wide_union_cap(chunk)``
  rows (800 or 1600) whatever d_max is.  Every other table takes it.  The
  plan cuts it at both widths and keeps 64 columns unless their groups
  stage more than twice the rows per output row of 32's.  At 64 columns
  each slot's weight and position are read once for twice the columns;
  at 32 a union holds twice the rows, so groups split less.  On the H100
  (PERF.md) 64 columns win on rgg r=0.4 at m=1024 (1.6x the staged rows
  of 32) and at m=4096 (1.3x, and 2.9x the direct rows), 32 on rgg r=0.2
  at m=4096 (6x).

Groups are grown as balls of the neighbor graph: seeds in BFS order (from
the least-connected row), and from each seed a BFS over unassigned rows
that admits a row while the group's union stays within the tier's union
cap.  On a spatial fabric (rgg) neighbouring rows share most of their
neighbours, so a group reads a union of a few rows per output row; on a
fabric with no locality groups shrink towards one row.  A row whose own
reads exceed the cap is listed apart (``direct``): the third kernel of the
file, ``mix_sparse_direct_kernel``, mixes those rows straight from device
memory.  Only the wide tier has such rows (a row reads at most d_max + 1
rows, which the 128-column tier's cap exceeds wherever it is chosen).

A table may read more rows than it has (a shard's table over its ``[own;
halo]`` buffer, ``n_src`` source rows): row i's self term is source row i,
groups grow over the output rows only, and unions hold any source rows.
A square table's plan is the same as before.
"""
from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

# the kernels' constants (csrc/mix_sparse.cu).  128-column tier: columns
# of w per block, shared memory per block (two blocks per SM), rows of a
# group.  Wide tier: columns per block (preferred first), shared memory
# for the slab (one block per SM), rows of a group.
CHUNK = 128
SMEM_BUDGET = 110 * 1024
ROWS_MAX = 64
WIDE_CHUNKS = (64, 32)
WIDE_BUDGET = 200 * 1024
WIDE_ROWS_MAX = 256


class MixSparsePlan(NamedTuple):
    """Row groups of one neighbor list, on the run's device.

    ``chunk`` names the staged tier the groups were cut for (``CHUNK``:
    ``mix_sparse_kernel``, one of ``WIDE_CHUNKS``:
    ``mix_sparse_wide_kernel`` at that width).
    ``rows`` int32 lists the staged rows group by group (``row_ptr``
    (G+1,) int32 cuts it); ``union`` int32 lists each group's staged rows,
    sorted (``union_ptr`` (G+1,) int32 cuts it); ``slot_pos`` (m, d_max)
    int32 and ``self_pos`` (m,) int32 give, for a row of a group, the
    position of ``nbr_idx[i, s]`` and of ``i`` in that group's union.
    ``direct`` int32 lists the rows that fit no group.  ``nbr_idx`` is the
    tensor the plan was built for and ``version`` its version counter then
    (an in-place change of the table makes the plan stale); ``n_src`` the
    source rows it reads (m, or more for a table over a halo buffer)."""

    nbr_idx: torch.Tensor
    version: int
    chunk: int
    rows: torch.Tensor
    row_ptr: torch.Tensor
    union: torch.Tensor
    union_ptr: torch.Tensor
    slot_pos: torch.Tensor
    self_pos: torch.Tensor
    direct: torch.Tensor
    max_union: int  # rows of the largest union
    max_rows: int  # rows of the largest group
    n_src: int  # max(m, largest index read + 1)
    build_ms: float  # host time of the build, the copy to the device included

    @property
    def wide(self) -> bool:
        """Whether the groups are the wide tier's."""
        return self.chunk != CHUNK

    @property
    def n_groups(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def n_direct(self) -> int:
        return int(self.direct.shape[0])

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block of the staged tier."""
        if self.wide:
            return 4 * self.chunk * self.max_union
        return smem_bytes(self.max_union, self.max_rows, int(self.nbr_idx.shape[1]))

    @property
    def mean_union(self) -> float:
        """Mean staged rows per group."""
        return int(self.union.shape[0]) / self.n_groups if self.n_groups else 0.0

    @property
    def staged_per_row(self) -> float:
        """Staged rows per output row of the groups: how many times the
        staged kernel reads each row of a column chunk from L2."""
        return int(self.union.shape[0]) / max(1, int(self.rows.shape[0]))


def smem_bytes(max_union: int, max_rows: int, d_max: int) -> int:
    """Dynamic shared memory of one block of the 128-column tier: the
    staged slab (fp32; before the first chunk it holds the rows' full slot
    lists), then the rows' compacted lists (8 bytes a slot: fp32 weight,
    int32 position) and their lengths (int32)."""
    lists = max_rows * d_max
    return 4 * (max(max_union * CHUNK, 2 * lists) + 2 * lists + max_rows)


def limits(d_max: int) -> tuple[int, int]:
    """(rows, union rows) a group of the 128-column tier may hold at this
    d_max: the compacted slot lists take at most a quarter of the budget,
    the slab the rest."""
    rows = max(1, min(ROWS_MAX, SMEM_BUDGET // 4 // (8 * d_max + 4)))
    union = (SMEM_BUDGET - (8 * d_max + 4) * rows) // (4 * CHUNK)
    return rows, union


def wide_tier(d_max: int) -> bool:
    """Whether a table of this d_max takes the wide tier: the 128-column
    tier's groups would hold fewer than half of ``ROWS_MAX`` rows."""
    return limits(d_max)[0] < ROWS_MAX // 2


def wide_union_cap(chunk: int) -> int:
    """Union rows a wide group may hold at this chunk width."""
    return WIDE_BUDGET // (4 * chunk)


def _bfs_order(nbrs: list[list[int]]) -> list[int]:
    """BFS order over every component, each started at its first row in
    (degree, index) order."""
    m = len(nbrs)
    seen = [False] * m
    order: list[int] = []
    for start in sorted(range(m), key=lambda i: (len(nbrs[i]), i)):
        if seen[start]:
            continue
        seen[start] = True
        queue = deque([start])
        while queue:
            i = queue.popleft()
            order.append(i)
            for j in nbrs[i]:
                if not seen[j]:
                    seen[j] = True
                    queue.append(j)
    return order


def _neighbours(idx: np.ndarray) -> list[list[int]]:
    """The sorted distinct rows other than itself that each row of a (m,
    d_max) table reads."""
    m = idx.shape[0]
    s = np.sort(idx, axis=1)
    keep = s != np.arange(m)[:, None]
    keep[:, 1:] &= s[:, 1:] != s[:, :-1]
    return [r.tolist() for r in np.split(s[keep], np.cumsum(keep.sum(1))[:-1])]


def _n_src(idx: np.ndarray) -> int:
    """Source rows a (m, d_max) table reads: m, or more over a halo
    buffer."""
    return max(idx.shape[0], int(idx.max()) + 1 if idx.size else 0)


def _read_bits(idx: np.ndarray, n_src: int, block: int = 256) -> list[int]:
    """The rows each row of a (m, d_max) table reads, itself included, as a
    Python int used as a bit set (bit j: source row j), built ``block``
    rows at a time (n_src / 8 bytes a row)."""
    m = idx.shape[0]
    sets: list[int] = []
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        mask = np.zeros((hi - lo, n_src), bool)
        mask[np.arange(hi - lo)[:, None], idx[lo:hi]] = True
        mask[np.arange(hi - lo), np.arange(lo, hi)] = True
        sets.extend(int.from_bytes(row.tobytes(), "little")
                    for row in np.packbits(mask, axis=1, bitorder="little"))
    return sets


def group_rows(idx: np.ndarray, rows_cap: int, union_cap: int
               ) -> tuple[list[list[int]], list[list[int]], list[int]]:
    """Host part of the plan: (rows of each group, sorted union of each
    group, rows that fit no group) of a (m, d_max) table, with groups of
    at most ``rows_cap`` rows and unions of at most ``union_cap``.  Row
    sets are bit sets (``_read_bits``), so a candidate's new rows cost a
    few machine words per 64 rows of the table.  Groups grow over the
    table's own rows; a table over a halo buffer reads source rows past
    them, which count in the unions only."""
    m = idx.shape[0]
    n_src = _n_src(idx)
    nbrs = _neighbours(idx)
    sets = _read_bits(idx, n_src)
    sizes = [len(r) + 1 for r in nbrs]
    if n_src > m:  # grow over output rows only
        nbrs = [[j for j in r if j < m] for r in nbrs]
    direct = [n > union_cap for n in sizes]
    assigned = list(direct)
    groups: list[list[int]] = []
    unions: list[list[int]] = []
    for seed in _bfs_order(nbrs):
        if assigned[seed]:
            continue
        grp, uni, n_uni = [seed], sets[seed], sizes[seed]
        assigned[seed] = True
        queue = deque([seed])
        while queue and len(grp) < rows_cap:
            for j in nbrs[queue.popleft()]:
                if assigned[j]:
                    continue
                n_new = (sets[j] & ~uni).bit_count()
                if n_uni + n_new > union_cap:
                    continue
                assigned[j] = True
                grp.append(j)
                n_uni += n_new
                uni |= sets[j]
                queue.append(j)
                if len(grp) == rows_cap:
                    break
        groups.append(grp)
        raw = np.frombuffer(uni.to_bytes((n_src + 7) // 8, "little"), np.uint8)
        unions.append(np.flatnonzero(np.unpackbits(raw, bitorder="little")[:n_src]).tolist())
    return groups, unions, [i for i in range(m) if direct[i]]


def _staged_per_row(cut) -> float:
    groups, unions, _ = cut
    return sum(map(len, unions)) / max(1, sum(map(len, groups)))


def build_plan(nbr_idx: torch.Tensor) -> MixSparsePlan:
    """The plan of ``nbr_idx`` (m, d_max) int64, on its device, its tier
    and chunk width chosen as the module's docstring says.  Copies the
    table to the host (a device sync when it lies on the card)."""
    t0 = time.perf_counter()
    idx = nbr_idx.detach().cpu().numpy()
    d_max = idx.shape[1]
    if not wide_tier(d_max):
        return plan_of(nbr_idx, CHUNK, group_rows(idx, *limits(d_max)), t0)
    wide, narrow = (group_rows(idx, WIDE_ROWS_MAX, wide_union_cap(ch)) for ch in WIDE_CHUNKS)
    if _staged_per_row(wide) > 2 * _staged_per_row(narrow):
        return plan_of(nbr_idx, WIDE_CHUNKS[1], narrow, t0)
    return plan_of(nbr_idx, WIDE_CHUNKS[0], wide, t0)


def plan_of(nbr_idx: torch.Tensor, chunk: int, cut, t0: float | None = None
            ) -> MixSparsePlan:
    """The plan's tables, on ``nbr_idx``'s device, for a ``group_rows`` cut
    of the table made for ``chunk`` columns; ``build_ms`` counts from
    ``t0`` (``time.perf_counter()``), or from this call."""
    t0 = time.perf_counter() if t0 is None else t0
    groups, unions, direct = cut
    idx = nbr_idx.detach().cpu().numpy()
    m, d_max = idx.shape
    slot_pos = np.zeros((m, d_max), np.int32)
    self_pos = np.zeros(m, np.int32)
    for grp, uni in zip(groups, unions):
        u = np.asarray(uni, np.int64)
        g = np.asarray(grp, np.int64)
        slot_pos[g] = np.searchsorted(u, idx[g])
        self_pos[g] = np.searchsorted(u, g)
    sizes = np.asarray([len(u) for u in unions], np.int64)
    dev = nbr_idx.device

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    cat = (lambda parts: np.concatenate([np.asarray(p, np.int64) for p in parts])
           if parts else np.zeros(0, np.int64))
    plan = dict(
        rows=put(cat(groups), torch.int32),
        row_ptr=put(np.cumsum([0] + [len(g) for g in groups]), torch.int32),
        union=put(cat(unions), torch.int32),
        union_ptr=put(np.cumsum(np.concatenate([[0], sizes])), torch.int32),
        slot_pos=put(slot_pos, torch.int32), self_pos=put(self_pos, torch.int32),
        direct=put(np.asarray(direct, np.int64), torch.int32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return MixSparsePlan(
        nbr_idx=nbr_idx, version=nbr_idx._version, chunk=chunk, **plan,
        max_union=int(sizes.max()) if sizes.size else 0,
        max_rows=max([len(g) for g in groups], default=0), n_src=_n_src(idx),
        build_ms=(time.perf_counter() - t0) * 1e3)
