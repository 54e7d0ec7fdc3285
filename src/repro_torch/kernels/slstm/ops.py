"""Wrapper of the sLSTM recurrence kernel (``csrc/slstm.cu``), the time loop
of an xLSTM sLSTM block:

    slstm_scan(pre_x, r_gates, b_gates, (c, n, h, m)) -> hs, (c, n, h, m)

pre_x is (B, S, 4, H, dh) (the input projection of every step, gates i, f,
z, o), r_gates (4, H, dh, dh) and b_gates (4, H, dh), all of one dtype,
fp32 or bf16; the state's four tensors are fp32 (B, H, dh).  hs (B, S, H,
dh) holds each step's fp32 h; the final state comes back as four new
tensors.  The arithmetic is ``ref.slstm_step``'s (the reference's
``_slstm_cell``), rounded where it rounds.

A CUDA tensor launches the kernel (contiguous inputs, dh in SUPPORTED_DH)
and counts it in ``LAUNCHES["slstm"]``, once a call; a failed build or
launch raises, and nothing falls back.  CPU tensors run the plain per-step
loop in ``ref.py``.

Under autograd (grad enabled and an input that requires grad) the call goes
through ``SLSTMScan``, a ``torch.autograd.Function``.  On the card its
forward launches the saving variant of the kernel (the same hs, bit for
bit, and each step's fp32 gate pre-activations and state before it, (B, S,
7, H, dh) fp32, also counted in ``LAUNCHES["slstm"]``) and its backward
the reverse walk of ``csrc/slstm_bwd.cu`` (``LAUNCHES["slstm_bwd"]``, once
a call): d pre_x in the inputs' dtype and the initial state's gradient,
then dR and db as one fp32 product and sum over (b, t) of its rows
(``ref.weight_grads``).  The walk takes the forward's cluster and warps
(below), and a step's serial path holds only what depends on dh_t:
``dh_t = d pre_{t+1} . R^T``, the derivatives and the send.  Lane L of a
warp keeps R[g, k, j] of every gate for the warp's 4 units k and the units
j = L, L + 32, ..., sums its part for each k in that order, and the warp's
32 lanes add theirs in a tree of shuffles (xor 16, 8, 4, 2, 1) that leaves
unit k's sum in its 8 lanes; each CTA receives every unit's four rounded
gate gradients a step, 16 bytes by one st.async from lane part <
CLUSTER[dh] of the unit, double-buffered.  A producer warp stages each
step's 8 rows (the saved 7 and d hs) in TILE-step tiles from the last,
then computes from them, a lane a unit, everything of the step that dh_t
does not feed (the gates and state recomputed with the forward's code, h,
the max's shares, the activations' derivatives, 1 / N: BWD_TERMS values)
into one of two buffers the consumer warps read ahead of each step's wait.
On the CPU the same Function runs ``ref.slstm_scan_save_ref`` and
``ref.slstm_bwd_walk_ref``.

The kernel runs one thread block cluster of CLUSTER[dh] CTAs a (batch row,
head), each CTA owning dh / CLUSTER[dh] units of the four gates, in
``consumer_warps(dh)`` warps of UNITS_A_WARP whole units each and one
producer warp, which stages pre_x in TILE-step tiles through a ring of
STAGES stages of shared memory.  Lane part + PARTS unit of a warp keeps R
of every gate for its part of k (the 16-byte chunks part, part + PARTS, ...
of h) and sums them in a fixed order (two partial sums a gate); the PARTS
lanes of a unit then reduce and scatter the four sums by shuffles (xor 4,
2, 1), so lane part ends with gate (part / 2) % 4 and a unit's gates meet
in its warp, where its 8 lanes combine them with the state alike.  Lane
part sends the unit's rounded h into a double buffer of CTA part by
st.async, and a warp starts the next step when its CTA's mbarrier has seen
all dh values arrive.  Two buffers suffice: h_{t+2} reaches a buffer only
from a sender that received all of h_{t+1}, which every warp sent after
reading h_t there."""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.slstm.ref import (SAVE_ROWS, slstm_bwd_walk_ref,
                                           slstm_scan_ref, slstm_scan_save_ref,
                                           weight_grads)

# launches of the CUDA kernels, counted where they are launched and nowhere
# else: the forward (either variant) and the backward walk
LAUNCHES = {"slstm": 0, "slstm_bwd": 0}

# head widths the kernel is built for (csrc/slstm.cu's instantiations)
SUPPORTED_DH = (32, 64, 128, 192)
# The kernel's layout, mirrored from csrc/slstm.cu for the host (the CPU
# model of its protocol, chip_smoke.py's floors); ``built_layout`` reads
# the library's own, and the card's tests and chip_smoke.py hold the two
# equal.  CTAs that share one (batch row, head): a thread block cluster,
# each CTA owning dh / CLUSTER[dh] units of the four gates (Plan)
CLUSTER = {32: 2, 64: 4, 128: 8, 192: 8}
PARTS = 8  # lanes a unit, each summing 1 / PARTS of k for the four gates (kParts)
UNITS_A_WARP = 32 // PARTS
TILE, STAGES = 32, 4  # the pre_x ring: steps a stage, stages (kTile, kStages)
KERNEL = "slstm_kernel"  # the kernel functions' names, as the profiler shows them
BWD_KERNEL = "slstm_bwd_kernel"
BWD_ROWS = SAVE_ROWS + 1  # rows the backward stages a step: the saved 7 and d hs (kBwdRows)
BWD_TERMS = 17  # values the backward's producer computes a step and unit (kTerms)
_MAX_GRID_Y = 65535


def consumer_warps(dh: int) -> int:
    """Consumer warps a CTA (one producer warp beside them)."""
    return dh // CLUSTER[dh] // UNITS_A_WARP


def layout(dh: int) -> tuple[int, ...]:
    """(cluster, consumer warps, lanes a unit, steps a ring stage, stages) at
    head width ``dh``, as this module mirrors them."""
    return CLUSTER[dh], consumer_warps(dh), PARTS, TILE, STAGES


def built_layout(dh: int) -> tuple[int, ...]:
    """``layout(dh)`` as the built kernel has it (``repro_slstm_layout``;
    builds the library on first call, so on a machine with the CUDA
    toolkit)."""
    out = (ctypes.c_int64 * 5)()
    build.check(build.library().repro_slstm_layout(dh, out), "slstm layout")
    return tuple(out)


def bwd_smem_bytes(dh: int) -> int:
    """Shared memory of one backward CTA (csrc/slstm_bwd.cu's BwdShape): two
    buffers of a step's 4 dh fp32 gate gradients, the mbarriers, the ring of
    STAGES stages of TILE steps x BWD_ROWS rows of the CTA's units, and two
    buffers of a tile's BWD_TERMS terms a step and unit."""
    units = dh // CLUSTER[dh]
    ring = (2 * 4 * dh * 4 + 8 * (2 + STAGES + 2 + 2) + 127) & ~127
    return ring + (STAGES * BWD_ROWS + 2 * BWD_TERMS) * TILE * units * 4


def bwd_layout(dh: int) -> tuple[int, ...]:
    """(cluster, consumer warps, lanes a unit, steps a ring stage, stages,
    rows a step, shared memory bytes) of the backward kernel at head width
    ``dh``, as this module mirrors them."""
    return (CLUSTER[dh], consumer_warps(dh), PARTS, TILE, STAGES, BWD_ROWS,
            bwd_smem_bytes(dh))


def built_bwd_layout(dh: int) -> tuple[int, ...]:
    """``bwd_layout(dh)`` as the built kernel has it
    (``repro_slstm_bwd_layout``; builds the library on first call)."""
    out = (ctypes.c_int64 * 7)()
    build.check(build.library().repro_slstm_bwd_layout(dh, out), "slstm_bwd layout")
    return tuple(out)


def _check_shapes(pre_x, r_gates, b_gates, state) -> None:
    if pre_x.dim() != 5 or pre_x.shape[2] != 4 or len(state) != 4:
        raise ValueError(f"slstm_scan takes pre_x (B,S,4,H,dh) and a state (c, n, h, m); "
                         f"got pre_x {tuple(pre_x.shape)} and {len(state)} state tensors")
    bsz, _, _, heads, dh = pre_x.shape
    want = {"r_gates": (r_gates, (4, heads, dh, dh)), "b_gates": (b_gates, (4, heads, dh)),
            **{name: (t, (bsz, heads, dh)) for name, t in zip("cnhm", state)}}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"slstm_scan: {name} must have shape {shape} for pre_x "
                             f"{tuple(pre_x.shape)}; got {tuple(t.shape)}")


def slstm_scan(pre_x: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               state) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """pre_x (B,S,4,H,dh), r_gates (4,H,dh,dh), b_gates (4,H,dh), state (c, n,
    h, m) fp32 (B,H,dh) -> hs (B,S,H,dh) fp32 and the final (c, n, h, m)."""
    _check_shapes(pre_x, r_gates, b_gates, state)
    dtype = pre_x.dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or r_gates.dtype != dtype or b_gates.dtype != dtype \
            or any(t.dtype != torch.float32 for t in state):
        raise TypeError(f"slstm_scan takes pre_x, r_gates and b_gates of one dtype, float32 "
                        f"or bfloat16, and a float32 state; got "
                        f"{[str(t.dtype) for t in (pre_x, r_gates, b_gates, *state)]}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (pre_x, r_gates, b_gates, *state)):
        hs, *out = SLSTMScan.apply(pre_x, r_gates, b_gates, *state)
        return hs, tuple(out)
    if on_cpu(pre_x, r_gates, b_gates, *state):
        return slstm_scan_ref(pre_x, r_gates, b_gates, tuple(state))
    return _launch(pre_x, r_gates, b_gates, state, save=False)[:2]


def _launch(pre_x, r_gates, b_gates, state, *, save: bool):
    """The forward kernel on the card -> (hs, the final state, the saved
    rows (B, S, SAVE_ROWS, H, dh) fp32 or None)."""
    dtype = pre_x.dtype
    bsz, s, _, heads, dh = pre_x.shape
    if dh not in SUPPORTED_DH:
        raise ValueError(f"the sLSTM kernel takes dh in {SUPPORTED_DH}; got {dh}")
    if bsz * heads > _MAX_GRID_Y:
        raise ValueError(f"the sLSTM kernel takes B * H <= {_MAX_GRID_Y}; got {bsz * heads}")
    check_cuda_input("pre_x", pre_x, dtype, (bsz, s, 4, heads, dh))
    check_cuda_input("r_gates", r_gates, dtype, (4, heads, dh, dh))
    check_cuda_input("b_gates", b_gates, dtype, (4, heads, dh))
    for name, t in zip("cnhm", state):
        check_cuda_input(name, t, torch.float32, (bsz, heads, dh))
    hs = torch.empty((bsz, s, heads, dh), dtype=torch.float32, device=pre_x.device)
    out = tuple(torch.empty_like(t) for t in state)
    saved = torch.empty((bsz, s, SAVE_ROWS, heads, dh), dtype=torch.float32,
                        device=pre_x.device) if save else None
    if s == 0 or bsz * heads == 0:
        for o, t in zip(out, state):
            o.copy_(t)
        return hs, out, saved
    if pre_x.data_ptr() % 16:  # its rows arrive by 16-byte bulk copies
        pre_x = pre_x.clone()
    lib = build.library()
    fn = lib.repro_slstm_bf16 if dtype == torch.bfloat16 else lib.repro_slstm_f32
    err = fn(pre_x.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
             *(t.data_ptr() for t in state), hs.data_ptr(), *(t.data_ptr() for t in out),
             saved.data_ptr() if save else None, bsz, s, heads, dh,
             stream_handle(pre_x.device))
    build.check(err, "slstm")
    LAUNCHES["slstm"] += 1
    return hs, out, saved


def _launch_bwd(r_gates, saved, dhs, dfinal, dtype):
    """The backward kernel on the card -> (d pre_x (B, S, 4, H, dh) in
    ``dtype``, the initial state's gradient (dc, dn, dh, dm) fp32)."""
    bsz, s, _, heads, dh = saved.shape
    dpx = torch.empty((bsz, s, 4, heads, dh), dtype=dtype, device=saved.device)
    d0 = tuple(torch.empty((bsz, heads, dh), dtype=torch.float32, device=saved.device)
               for _ in range(4))
    dfinal = tuple(t.to(torch.float32).contiguous() for t in dfinal)
    if s == 0 or bsz * heads == 0:
        for o, t in zip(d0, dfinal):
            o.copy_(t)
        return dpx, d0
    dhs = dhs.to(torch.float32).contiguous()
    if dhs.data_ptr() % 16:  # its rows arrive by 16-byte bulk copies
        dhs = dhs.clone()
    check_cuda_input("dhs", dhs, torch.float32, (bsz, s, heads, dh))
    check_cuda_input("r_gates", r_gates, dtype, (4, heads, dh, dh))
    for name, t in zip(("dc", "dn", "dh", "dm"), dfinal):
        check_cuda_input(name, t, torch.float32, (bsz, heads, dh))
    lib = build.library()
    fn = lib.repro_slstm_bwd_bf16 if dtype == torch.bfloat16 else lib.repro_slstm_bwd_f32
    err = fn(saved.data_ptr(), dhs.data_ptr(), r_gates.data_ptr(),
             *(t.data_ptr() for t in dfinal), dpx.data_ptr(), *(t.data_ptr() for t in d0),
             bsz, s, heads, dh, stream_handle(saved.device))
    build.check(err, "slstm_bwd")
    LAUNCHES["slstm_bwd"] += 1
    return dpx, d0


class SLSTMScan(torch.autograd.Function):
    """The recurrence with its gradient: on the card the saving forward
    kernel and the backward kernel, on the CPU the plain versions of both.
    Inputs pre_x, r_gates, b_gates, c, n, h, m; outputs hs, c, n, h, m."""

    @staticmethod
    def forward(ctx, pre_x, r_gates, b_gates, c, n, h, m):
        state = (c, n, h, m)
        if on_cpu(pre_x, r_gates, b_gates, *state):
            hs, out, saved = slstm_scan_save_ref(pre_x, r_gates, b_gates, state)
            if pre_x.shape[1] == 0:  # no step: the state itself, as new tensors
                out = tuple(t.clone() for t in state)
        else:
            hs, out, saved = _launch(pre_x, r_gates, b_gates, state, save=True)
        ctx.save_for_backward(r_gates, h, hs, saved)
        ctx.dtype = pre_x.dtype
        return (hs, *out)

    @staticmethod
    @once_differentiable
    def backward(ctx, dhs, dc, dn, dh, dm):
        r_gates, h0, hs, saved = ctx.saved_tensors
        if saved.device.type == "cpu":
            dpx, dr, db, d0 = slstm_bwd_walk_ref(r_gates, h0, saved, hs, dhs,
                                                 (dc, dn, dh, dm), ctx.dtype)
        else:
            dpx, d0 = _launch_bwd(r_gates, saved, dhs, (dc, dn, dh, dm), ctx.dtype)
            dr, db = weight_grads(h0, hs, dpx, ctx.dtype)
        grads = (dpx, dr, db, *d0)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
