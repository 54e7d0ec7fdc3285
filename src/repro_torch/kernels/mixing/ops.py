"""Wrappers of the mixing kernels (``csrc/mix.cu``, ``csrc/mix_sparse.cu``).

A CUDA tensor launches the kernel (fp32, contiguous; ELL indices int64)
or raises; a CPU tensor runs the plain version in ``ref.py``.  The
gather-mix's row-group plan lives here (``prepare_plan``), one at a time,
for the neighbor table it was built from."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.mixing.plan import CHUNK, MixSparsePlan, build_plan
from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref

# launches of the CUDA kernels, counted where they are launched and
# nowhere else
LAUNCHES = {"mix": 0, "mix_sparse": 0, "mix_sparse_wide": 0, "mix_sparse_direct": 0}

_MAX_GRID_Y = 65535

_plan: MixSparsePlan | None = None  # the gather-mix's plan of the last table


def mix(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense consensus mixing: p (m, m), w (m, D) -> P @ W (m, D), to fp32
    accuracy (split TF32 on the card's tensor cores; ``mix_ref_3xtf32``
    emulates the split)."""
    if w.dim() != 2 or tuple(p.shape) != (w.shape[0], w.shape[0]):
        raise ValueError(f"mix takes p (m, m) and w (m, D); got "
                         f"{tuple(p.shape)} and {tuple(w.shape)}")
    if on_cpu(p, w):
        return mix_ref(p, w)
    m, n = w.shape
    check_cuda_input("p", p, torch.float32, (m, m))
    check_cuda_input("w", w, torch.float32, (m, n))
    if -(-n // 128) > _MAX_GRID_Y:
        raise ValueError(f"mix kernel takes D <= {_MAX_GRID_Y * 128}; got {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out
    err = build.library().repro_mix_f32(
        p.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
        stream_handle(w.device))
    build.check(err, "mix")
    LAUNCHES["mix"] += 1
    return out


def prepare_plan(nbr_idx: torch.Tensor) -> MixSparsePlan | None:
    """The row-group plan of ``nbr_idx`` that ``mix_sparse`` launches with
    on the card (``plan.build_plan``), built on the first call for this
    tensor and kept until another table (or an in-place change of this
    one) asks for a new plan.  The build copies the table to the host, a
    device sync and ~0.1 s at m=4096 (``plan.build_ms``): a run calls this
    once, before its loop.  None for a CPU tensor, whose path needs no
    plan."""
    global _plan
    if nbr_idx.device.type == "cpu":
        return None
    if _plan is None or _plan.nbr_idx is not nbr_idx \
            or _plan.version != nbr_idx._version:
        _plan = build_plan(nbr_idx)
    return _plan


def mix_sparse(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
               p_off: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ELL gather-mix: nbr_idx/p_off (m, d_max), p_diag (m,) or (m, 1),
    w (m, D) -> p_diag * w + sum_s p_off[:, s] * w[nbr_idx[:, s]].

    On the card the rows follow ``prepare_plan(nbr_idx)`` (built on the
    first call for a table, a host sync), three routes:

    - a table of d_max <= 109 (``not plan.wide``) has its rows grouped for
      ``mix_sparse_kernel``, 128 columns of the group's rows staged in
      shared memory beside the compacted slot lists;
    - a denser table has them grouped for ``mix_sparse_wide_kernel``, 64
      (or 32) columns of up to 800 (1600) rows staged, each row's
      nonzero slots compacted once a call into device memory;
    - a row that reads more distinct rows than that slab holds is mixed
      by ``mix_sparse_direct_kernel`` from device memory, after a pass
      that flags W's finite rows.

    Each route launches when the plan gives it rows and counts under its
    own key.  All give the plain version's bits; the CPU path runs that
    directly."""
    if w.dim() != 2 or nbr_idx.dim() != 2 or nbr_idx.shape[0] != w.shape[0] \
            or p_off.shape != nbr_idx.shape or p_diag.numel() != w.shape[0]:
        raise ValueError(
            f"mix_sparse takes nbr_idx/p_off (m, d_max), p_diag (m,), w (m, D);"
            f" got {tuple(nbr_idx.shape)}, {tuple(p_off.shape)}, "
            f"{tuple(p_diag.shape)}, {tuple(w.shape)}")
    if on_cpu(nbr_idx, p_diag, p_off, w):
        return mix_sparse_ref(nbr_idx, p_diag, p_off, w)
    m, n = w.shape
    d_max = nbr_idx.shape[1]
    check_cuda_input("nbr_idx", nbr_idx, torch.int64, (m, d_max))
    check_cuda_input("p_off", p_off, torch.float32, (m, d_max))
    check_cuda_input("p_diag", p_diag.reshape(m), torch.float32, (m,))
    check_cuda_input("w", w, torch.float32, (m, n))
    if -(-n // CHUNK) > _MAX_GRID_Y:
        raise ValueError(f"mix_sparse kernel takes D <= {_MAX_GRID_Y * CHUNK}; got {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out
    plan = prepare_plan(nbr_idx)
    lib, stream = build.library(), stream_handle(w.device)
    if plan.n_groups and plan.wide:
        # scratch: each staged row's nonzero slots, compacted once a call
        n_rows, stride = plan.rows.numel(), d_max + d_max % 2
        kept = torch.empty((n_rows, stride, 2), dtype=torch.int32, device=w.device)
        n_kept = torch.empty(n_rows, dtype=torch.int32, device=w.device)
        err = lib.repro_mix_sparse_wide_f32(
            p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(), out.data_ptr(),
            plan.rows.data_ptr(), plan.row_ptr.data_ptr(), plan.union.data_ptr(),
            plan.union_ptr.data_ptr(), plan.slot_pos.data_ptr(),
            plan.self_pos.data_ptr(), kept.data_ptr(), n_kept.data_ptr(),
            plan.n_groups, n_rows, d_max, stride, n, plan.max_union, plan.chunk, stream)
        build.check(err, "mix_sparse_wide")
        LAUNCHES["mix_sparse_wide"] += 1
    elif plan.n_groups:
        err = lib.repro_mix_sparse_f32(
            nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
            out.data_ptr(), plan.rows.data_ptr(), plan.row_ptr.data_ptr(),
            plan.union.data_ptr(), plan.union_ptr.data_ptr(), plan.slot_pos.data_ptr(),
            plan.self_pos.data_ptr(), plan.n_groups, d_max, n, plan.max_union,
            plan.max_rows, stream)
        build.check(err, "mix_sparse")
        LAUNCHES["mix_sparse"] += 1
    if plan.n_direct:
        finite = torch.empty(m, dtype=torch.uint8, device=w.device)
        err = lib.repro_mix_sparse_direct_f32(
            nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
            out.data_ptr(), plan.direct.data_ptr(), finite.data_ptr(), plan.n_direct,
            m, d_max, n, stream)
        build.check(err, "mix_sparse_direct")
        LAUNCHES["mix_sparse_direct"] += 1
    return out
