"""Wrappers of the mixing kernels (``csrc/mix.cu``, ``csrc/mix_sparse.cu``).

A CUDA tensor launches the kernel of W's dtype (contiguous; ELL indices
int64, P and its ELL weights fp32) or raises; a CPU tensor runs the plain
version in ``ref.py``.  fp32 rows (the simulator's flat rows) take the
fp32 kernels, which take a leading cell axis, C cells in one launch:
``mix`` with P (C, m, m) and W (C, m, D), ``mix_sparse`` with one shared
neighbor table and per-cell weights and rows; unbatched inputs are one
cell.  bf16 rows (the train step's parameter leaves) take the bf16
entries, one cell, W's dtype out; any other dtype raises.  The
gather-mix's row-group plans live here (``prepare_plan``), a few, each for
the neighbor table it was built from, whatever the number of cells; the
bf16 entry needs none.  ``mix_tree`` and ``mix_sparse_tree`` apply them
leaf by leaf over a stacked parameter tree, each leaf as (m, -1) rows,
an fp32 leaf wider than the fp32 kernels' grids in column slabs."""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.mixing.plan import CHUNK, MixSparsePlan, build_plan
from repro_torch.kernels.mixing.ref import mix_ordered_ref, mix_ref, mix_sparse_ref
from repro_torch.tree import tree_map

# launches of the CUDA kernels, counted where they are launched and
# nowhere else
LAUNCHES = {"mix": 0, "mix_sparse": 0, "mix_sparse_wide": 0, "mix_sparse_direct": 0,
            "mix_bf16": 0, "mix_sparse_bf16": 0}
# builds of a gather-mix plan (each a host sync), counted where they happen
PLAN_BUILDS = 0

_MAX_GRID_Y = 65535
# columns of an fp32 leaf that ``mix_tree`` / ``mix_sparse_tree`` hand one
# launch at most: the fp32 kernels' grids cover 65535 x 128 columns
FP32_SLAB = 1 << 22
_MAX_CELLS = 65535  # the kernels' cell axis is a grid axis

# the gather-mix's plans of the last few tables, least recently used first,
# keyed by the table's identity and version; each entry holds its table (in
# ``plan.nbr_idx``), so a recycled id cannot alias another table
_PLANS: "OrderedDict[tuple[int, int], MixSparsePlan]" = OrderedDict()
PLAN_CACHE_SIZE = 8
# the least and largest index of the last few tables the bf16 gather-mix
# took, keyed and held as the plans are
_RANGES: "OrderedDict[tuple[int, int], tuple[torch.Tensor, int, int]]" = OrderedDict()


def _cells(w: torch.Tensor) -> int:
    """The number of cells of an (m, D) or (C, m, D) w."""
    cells = w.shape[0] if w.dim() == 3 else 1
    if cells > _MAX_CELLS:
        raise ValueError(f"the mixing kernels take at most {_MAX_CELLS} cells; got {cells}")
    return cells


def mix(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense consensus mixing, per cell: p (C, m, m), w (C, m, D) -> P @ W
    (C, m, D), or p (m, m), w (m, D) as one cell, to fp32 accuracy (split
    TF32 on the card's tensor cores; ``mix_ref_3xtf32`` emulates the
    split).  One launch for all cells.  bf16 rows, one cell: the bf16
    entry, bf16 out (``_mix_bf16``)."""
    if w.dim() not in (2, 3) or tuple(p.shape) != tuple(w.shape[:-1]) + (w.shape[-2],):
        raise ValueError(f"mix takes p (m, m) and w (m, D), or p (C, m, m) and "
                         f"w (C, m, D); got {tuple(p.shape)} and {tuple(w.shape)}")
    if on_cpu(p, w):
        return mix_ordered_ref(p, w) if w.dtype == torch.bfloat16 else mix_ref(p, w)
    if w.dtype == torch.bfloat16:
        return _mix_bf16(p, w)
    cells = _cells(w)
    m, n = w.shape[-2:]
    check_cuda_input("p", p, torch.float32, tuple(p.shape))
    check_cuda_input("w", w, torch.float32, tuple(w.shape))
    if -(-n // 128) > _MAX_GRID_Y:
        raise ValueError(f"mix kernel takes D <= {_MAX_GRID_Y * 128}; got {n}")
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    if m == 0 or n == 0 or out.numel() == 0:
        return out
    err = build.library().repro_mix_f32(
        p.data_ptr(), w.data_ptr(), out.data_ptr(), cells, m, n,
        stream_handle(w.device))
    build.check(err, "mix")
    LAUNCHES["mix"] += 1
    return out


def _one_cell(name: str, w: torch.Tensor) -> None:
    if w.dim() != 2:
        raise ValueError(f"the bf16 {name} entry takes one cell, w (m, D); got "
                         f"{tuple(w.shape)}")


def _mix_bf16(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``mix`` of bf16 rows on the card: ``repro_mix_bf16``, bf16 out, the
    bits of ``mix_ordered_ref``."""
    _one_cell("mix", w)
    m, n = w.shape
    check_cuda_input("p", p, torch.float32, (m, m))
    check_cuda_input("w", w, torch.bfloat16, (m, n))
    out = torch.empty_like(w)
    if m == 0 or n == 0:
        return out
    err = build.library().repro_mix_bf16(p.data_ptr(), w.data_ptr(), out.data_ptr(),
                                         m, n, stream_handle(w.device))
    build.check(err, "mix_bf16")
    LAUNCHES["mix_bf16"] += 1
    return out


def _mix_sparse_bf16(nbr_idx, p_diag, p_off, w) -> torch.Tensor:
    """``mix_sparse`` of bf16 rows on the card: ``repro_mix_sparse_bf16``,
    every slot in order, the bits of ``mix_sparse_ref``."""
    _one_cell("mix_sparse", w)
    m, d_max = nbr_idx.shape
    n_src, n = w.shape
    check_cuda_input("nbr_idx", nbr_idx, torch.int64, (m, d_max))
    check_cuda_input("p_off", p_off, torch.float32, (m, d_max))
    p_diag = p_diag.reshape(m)
    check_cuda_input("p_diag", p_diag, torch.float32, (m,))
    check_cuda_input("w", w, torch.bfloat16, (n_src, n))
    if -(-m // 4) > _MAX_GRID_Y:
        raise ValueError(f"the bf16 mix_sparse entry takes m <= {4 * _MAX_GRID_Y}; got {m}")
    out = torch.empty((m, n), dtype=w.dtype, device=w.device)
    if m == 0 or n == 0:
        return out
    lo, hi = _table_range(nbr_idx)
    if lo < 0 or hi >= n_src:
        raise ValueError(f"mix_sparse: nbr_idx reads rows {lo} to {hi} of w, which has "
                         f"{n_src}")
    err = build.library().repro_mix_sparse_bf16(
        nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
        out.data_ptr(), m, n_src, d_max, n, stream_handle(w.device))
    build.check(err, "mix_sparse_bf16")
    LAUNCHES["mix_sparse_bf16"] += 1
    return out


def _table_range(nbr_idx: torch.Tensor) -> tuple[int, int]:
    """The least and largest index of ``nbr_idx``, read on the first call
    for this tensor at its current version (a host sync) and kept in an LRU
    of ``PLAN_CACHE_SIZE`` tables, as ``prepare_plan`` keeps its plans."""
    key = (id(nbr_idx), nbr_idx._version)
    hit = _RANGES.get(key)
    if hit is None or hit[0] is not nbr_idx:
        lo, hi = torch.aminmax(nbr_idx)
        hit = (nbr_idx, int(lo), int(hi))
        _RANGES[key] = hit
        while len(_RANGES) > PLAN_CACHE_SIZE:
            _RANGES.popitem(last=False)
    else:
        _RANGES.move_to_end(key)
    return hit[1], hit[2]


def slabs(rows: torch.Tensor) -> list[slice]:
    """The column slabs ``mix_tree`` / ``mix_sparse_tree`` mix (m, D) rows
    in, a launch each: all of D, or an fp32 D wider than ``FP32_SLAB`` in
    slabs of at most that (the bf16 entries take any width)."""
    n = rows.shape[-1]
    if rows.dtype != torch.float32 or n <= FP32_SLAB:
        return [slice(0, n)]
    return [slice(c, min(c + FP32_SLAB, n)) for c in range(0, n, FP32_SLAB)]


def _tree(mix_rows, tree, out):
    """``mix_rows`` over each leaf as (m, -1) rows, a slab of columns at a
    time (``slabs``); with ``out`` (a tree of the same structure, ``tree``
    itself allowed) each mixed leaf or slab is copied into its place as
    soon as it exists, so one leaf's result is live at a time, and ``out``
    is returned."""
    def one(leaf, *dst):
        rows = leaf.reshape(leaf.shape[0], -1)
        cols = slabs(rows)
        if len(cols) == 1:
            mixed = mix_rows(rows).reshape(leaf.shape)
            return dst[0].copy_(mixed) if dst else mixed
        # columns mix apart: each slab is read before it is overwritten
        target = dst[0] if dst else torch.empty_like(leaf)
        flat = target.view(target.shape[0], -1)
        for c in cols:
            flat[:, c].copy_(mix_rows(rows[:, c].contiguous()))
        return target

    return tree_map(one, tree) if out is None else tree_map(one, tree, out)


def mix_tree(p: torch.Tensor, tree, *, out=None):
    """Dense consensus mixing of a stacked parameter tree, leaves (m, ...):
    each leaf flattened to (m, -1), mixed by ``mix`` in its dtype and
    reshaped.  ``out``: see ``_tree``."""
    return _tree(lambda rows: mix(p, rows), tree, out)


def mix_sparse_tree(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
                    p_off: torch.Tensor, tree, *, out=None):
    """Leaf-wise ``mix_sparse`` over a stacked parameter tree.  ``out``:
    see ``_tree``."""
    return _tree(lambda rows: mix_sparse(nbr_idx, p_diag, p_off, rows), tree, out)


def prepare_plan(nbr_idx: torch.Tensor) -> MixSparsePlan | None:
    """The row-group plan of ``nbr_idx`` that ``mix_sparse`` launches with
    on the card (``plan.build_plan``), built on the first call for this
    tensor (at its current version: an in-place change asks for a new
    plan) and kept in a small LRU (``PLAN_CACHE_SIZE`` tables), so runs
    that alternate fabrics build each plan once.  A build copies the table
    to the host, a device sync and ~0.1 s at m=4096 (``plan.build_ms``),
    and counts in ``PLAN_BUILDS``: a run calls this once, before its loop.
    None for a CPU tensor, whose path needs no plan."""
    global PLAN_BUILDS
    if nbr_idx.device.type == "cpu":
        return None
    key = (id(nbr_idx), nbr_idx._version)
    plan = _PLANS.get(key)
    if plan is None or plan.nbr_idx is not nbr_idx:
        plan = build_plan(nbr_idx)
        PLAN_BUILDS += 1
        _PLANS[key] = plan
        while len(_PLANS) > PLAN_CACHE_SIZE:
            _PLANS.popitem(last=False)
    else:
        _PLANS.move_to_end(key)
    return plan


def mix_sparse(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
               p_off: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ELL gather-mix, per cell: nbr_idx (m, d_max) shared by the cells,
    p_off (C, m, d_max), p_diag (C, m), w (C, m, D) -> p_diag * w +
    sum_s p_off[..., s] * w[..., nbr_idx[:, s], :] (C, m, D); unbatched
    p_off (m, d_max), p_diag (m,) or (m, 1) and w (m, D) are one cell.
    ``w`` may hold n_src > m rows (C, n_src, D), a shard's ``[own rows ;
    halo rows]`` buffer: output row i takes its self term from source row
    i, ``nbr_idx`` indexes [0, n_src), and the output has m rows.

    On the card the rows follow ``prepare_plan(nbr_idx)`` (built on the
    first call for a table, a host sync; one plan serves any number of
    cells), three routes:

    - a table of d_max <= 109 (``not plan.wide``) has its rows grouped for
      ``mix_sparse_kernel``, 128 columns of the group's rows staged in
      shared memory beside the compacted slot lists;
    - a denser table has them grouped for ``mix_sparse_wide_kernel``, 64
      (or 32) columns of up to 800 (1600) rows staged, each row's
      nonzero slots compacted once a call into device memory (per cell);
    - a row that reads more distinct rows than that slab holds is mixed
      by ``mix_sparse_direct_kernel`` from device memory, after a pass
      that flags W's finite rows (per cell).

    Each route launches once for all cells when the plan gives it rows and
    counts under its own key.  All give the plain version's bits, cell by
    cell; the CPU path runs that directly.  bf16 rows, one cell, take the
    bf16 entry instead, which needs no plan (``_mix_sparse_bf16``)."""
    lead = tuple(w.shape[:-2])
    if w.dim() not in (2, 3) or nbr_idx.dim() != 2 or nbr_idx.shape[0] > w.shape[-2] \
            or tuple(p_off.shape) != lead + tuple(nbr_idx.shape) \
            or p_diag.numel() != p_off.shape[:-1].numel():
        raise ValueError(
            f"mix_sparse takes nbr_idx (m, d_max) and p_off (m, d_max), p_diag "
            f"(m,), w (n_src >= m, D), or p_off (C, m, d_max), p_diag (C, m), w "
            f"(C, n_src, D); got {tuple(nbr_idx.shape)}, {tuple(p_off.shape)}, "
            f"{tuple(p_diag.shape)}, {tuple(w.shape)}")
    if on_cpu(nbr_idx, p_diag, p_off, w):
        return mix_sparse_ref(nbr_idx, p_diag, p_off, w)
    if w.dtype == torch.bfloat16:
        return _mix_sparse_bf16(nbr_idx, p_diag, p_off, w)
    cells = _cells(w)
    m, d_max = nbr_idx.shape
    n_src, n = w.shape[-2:]
    check_cuda_input("nbr_idx", nbr_idx, torch.int64, (m, d_max))
    check_cuda_input("p_off", p_off, torch.float32, lead + (m, d_max))
    p_diag = p_diag.reshape(lead + (m,))
    check_cuda_input("p_diag", p_diag, torch.float32, lead + (m,))
    check_cuda_input("w", w, torch.float32, lead + (n_src, n))
    if -(-n // CHUNK) > _MAX_GRID_Y:
        raise ValueError(f"mix_sparse kernel takes D <= {_MAX_GRID_Y * CHUNK}; got {n}")
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0 or out.numel() == 0:
        return out
    plan = prepare_plan(nbr_idx)
    if plan.n_src > n_src:
        raise ValueError(f"mix_sparse: nbr_idx reads {plan.n_src} rows of w, which "
                         f"has {n_src}")
    lib, stream = build.library(), stream_handle(w.device)
    if plan.n_groups and plan.wide:
        # scratch: each staged row's nonzero slots, compacted once a call,
        # per cell
        n_rows, stride = plan.rows.numel(), d_max + d_max % 2
        kept = torch.empty((cells, n_rows, stride, 2), dtype=torch.int32, device=w.device)
        n_kept = torch.empty((cells, n_rows), dtype=torch.int32, device=w.device)
        err = lib.repro_mix_sparse_wide_f32(
            p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(), out.data_ptr(),
            plan.rows.data_ptr(), plan.row_ptr.data_ptr(), plan.union.data_ptr(),
            plan.union_ptr.data_ptr(), plan.slot_pos.data_ptr(),
            plan.self_pos.data_ptr(), kept.data_ptr(), n_kept.data_ptr(), cells, m, n_src,
            plan.n_groups, n_rows, d_max, stride, n, plan.max_union, plan.chunk, stream)
        build.check(err, "mix_sparse_wide")
        LAUNCHES["mix_sparse_wide"] += 1
    elif plan.n_groups:
        err = lib.repro_mix_sparse_f32(
            nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
            out.data_ptr(), plan.rows.data_ptr(), plan.row_ptr.data_ptr(),
            plan.union.data_ptr(), plan.union_ptr.data_ptr(), plan.slot_pos.data_ptr(),
            plan.self_pos.data_ptr(), cells, m, n_src, plan.n_groups, d_max, n,
            plan.max_union, plan.max_rows, stream)
        build.check(err, "mix_sparse")
        LAUNCHES["mix_sparse"] += 1
    if plan.n_direct:
        finite = torch.empty((cells, n_src), dtype=torch.uint8, device=w.device)
        err = lib.repro_mix_sparse_direct_f32(
            nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
            out.data_ptr(), plan.direct.data_ptr(), finite.data_ptr(), cells,
            plan.n_direct, m, n_src, d_max, n, stream)
        build.check(err, "mix_sparse_direct")
        LAUNCHES["mix_sparse_direct"] += 1
    return out
