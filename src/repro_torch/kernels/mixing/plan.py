"""Row-group plan of the gather-mix kernel (``csrc/mix_sparse.cu``).

The kernel stages, for one group of rows and one ``CHUNK``-column slice
of ``w``, every row the group reads (its own rows and every slot's
``nbr_idx``, pads included) in shared memory, then mixes the group's rows
from there.  The plan says which rows form each group and where each
slot's row sits in its group's staged union.  It depends on the static
neighbor list alone, so a run builds it once, on the host, in numpy.

Groups are grown as balls of the neighbor graph: seeds in BFS order (from
the least-connected row), and from each seed a BFS over unassigned rows
that admits a row while the group's union stays within the shared-memory
budget.  On a spatial fabric (rgg) neighbouring rows share most of their
neighbours, so a group of up to 64 rows reads a union of a few rows per
output row; on a fabric with no locality groups shrink towards one row.
A row whose own neighbourhood exceeds the budget is listed apart
(``direct``): the second kernel of the file, ``mix_sparse_direct_kernel``,
mixes those rows straight from device memory.
"""
from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

# the kernel's constants (csrc/mix_sparse.cu): columns of w per block,
# shared memory per block (two blocks per SM) and rows of a group
CHUNK = 128
SMEM_BUDGET = 110 * 1024
ROWS_MAX = 64


class MixSparsePlan(NamedTuple):
    """Row groups of one neighbor list, on the run's device.

    ``rows`` int32 lists the staged rows group by group (``row_ptr``
    (G+1,) int32 cuts it); ``union`` int32 lists each group's staged rows,
    sorted (``union_ptr`` (G+1,) int32 cuts it); ``slot_pos`` (m, d_max)
    int32 and ``self_pos`` (m,) int32 give, for a row of a group, the
    position of ``nbr_idx[i, s]`` and of ``i`` in that group's union.
    ``direct`` int32 lists the rows that fit no group.  ``nbr_idx`` is the
    tensor the plan was built for and ``version`` its version counter then
    (an in-place change of the table makes the plan stale)."""

    nbr_idx: torch.Tensor
    version: int
    rows: torch.Tensor
    row_ptr: torch.Tensor
    union: torch.Tensor
    union_ptr: torch.Tensor
    slot_pos: torch.Tensor
    self_pos: torch.Tensor
    direct: torch.Tensor
    max_union: int  # rows of the largest union
    max_rows: int  # rows of the largest group
    build_ms: float  # host time of the build, the copy to the device included

    @property
    def n_groups(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def n_direct(self) -> int:
        return int(self.direct.shape[0])

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.max_union, self.max_rows, int(self.nbr_idx.shape[1]))

    @property
    def mean_union(self) -> float:
        """Mean staged rows per group."""
        return int(self.union.shape[0]) / self.n_groups if self.n_groups else 0.0


def smem_bytes(max_union: int, max_rows: int, d_max: int) -> int:
    """Dynamic shared memory of one block: the staged slab (fp32; before
    the first chunk it holds the rows' full slot lists), then the rows'
    compacted lists (8 bytes a slot: fp32 weight, int32 position) and
    their lengths (int32)."""
    lists = max_rows * d_max
    return 4 * (max(max_union * CHUNK, 2 * lists) + 2 * lists + max_rows)


def limits(d_max: int) -> tuple[int, int]:
    """(rows, union rows) a staged group may hold at this d_max: the
    compacted slot lists take at most a quarter of the budget, the slab
    the rest."""
    rows = max(1, min(ROWS_MAX, SMEM_BUDGET // 4 // (8 * d_max + 4)))
    union = (SMEM_BUDGET - (8 * d_max + 4) * rows) // (4 * CHUNK)
    return rows, union


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


def group_rows(idx: np.ndarray) -> tuple[list[list[int]], list[list[int]], list[int]]:
    """Host part of the plan: (rows of each group, sorted union of each
    group, rows that fit no group) for a (m, d_max) neighbor table."""
    m, d_max = idx.shape
    rows_cap, union_cap = limits(d_max)
    # the distinct rows each row reads, itself included
    reads = [sorted(set(r)) for r in np.concatenate(
        [np.arange(m, dtype=np.int64)[:, None], idx.astype(np.int64)], 1).tolist()]
    nbrs = [[j for j in r if j != i] for i, r in enumerate(reads)]
    direct = [len(r) > union_cap for r in reads]
    assigned = list(direct)
    mark = [-1] * m  # mark[j] == g: row j is in group g's union
    groups: list[list[int]] = []
    unions: list[list[int]] = []
    order = _bfs_order(nbrs)
    for seed in order:
        if assigned[seed]:
            continue
        g = len(groups)
        grp, uni = [seed], list(reads[seed])
        assigned[seed] = True
        for j in uni:
            mark[j] = g
        queue = deque([seed])
        while queue and len(grp) < rows_cap:
            for j in nbrs[queue.popleft()]:
                if assigned[j]:
                    continue
                new = [x for x in reads[j] if mark[x] != g]
                if len(uni) + len(new) > union_cap:
                    continue
                assigned[j] = True
                grp.append(j)
                uni.extend(new)
                for x in new:
                    mark[x] = g
                queue.append(j)
                if len(grp) == rows_cap:
                    break
        groups.append(grp)
        unions.append(sorted(uni))
    return groups, unions, [i for i in range(m) if direct[i]]


def build_plan(nbr_idx: torch.Tensor) -> MixSparsePlan:
    """The plan of ``nbr_idx`` (m, d_max) int64, on its device.  Copies the
    table to the host (a device sync when it lies on the card)."""
    t0 = time.perf_counter()
    idx = nbr_idx.detach().cpu().numpy()
    m, d_max = idx.shape
    groups, unions, direct = group_rows(idx)
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
        nbr_idx=nbr_idx, version=nbr_idx._version, **plan,
        max_union=int(sizes.max()) if sizes.size else 0,
        max_rows=max([len(g) for g in groups], default=0),
        build_ms=(time.perf_counter() - t0) * 1e3)
