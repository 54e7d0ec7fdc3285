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
launch raises, and nothing falls back.  The kernel has no backward pass:
under autograd on the card the wrapper raises.  CPU tensors run the plain
per-step loop in ``ref.py``, which autograd can differentiate.

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

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.slstm.ref import slstm_scan_ref

# launches of the CUDA kernel, counted where it is launched and nowhere else
LAUNCHES = {"slstm": 0}

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
KERNEL = "slstm_kernel"  # the kernel function's name, as the profiler shows it
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
    if on_cpu(pre_x, r_gates, b_gates, *state):
        return slstm_scan_ref(pre_x, r_gates, b_gates, tuple(state))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (pre_x, r_gates, b_gates, *state)):
        raise NotImplementedError(
            "the sLSTM kernel has no backward pass: train an xLSTM model on the CPU "
            "(the plain version); a backward sLSTM kernel for xlstm training on the "
            "card is ROADMAP Queue 2 item K4")
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
    if s == 0 or bsz * heads == 0:
        for o, t in zip(out, state):
            o.copy_(t)
        return hs, out
    if pre_x.data_ptr() % 16:  # its rows arrive by 16-byte bulk copies
        pre_x = pre_x.clone()
    lib = build.library()
    fn = lib.repro_slstm_bf16 if dtype == torch.bfloat16 else lib.repro_slstm_f32
    err = fn(pre_x.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
             *(t.data_ptr() for t in state), hs.data_ptr(), *(t.data_ptr() for t in out),
             bsz, s, heads, dh, stream_handle(pre_x.device))
    build.check(err, "slstm")
    LAUNCHES["slstm"] += 1
    return hs, out

