"""Wrapper of the selective-scan kernel (``csrc/selective_scan.cu``), the
recurrence of a Mamba head:

    selective_scan(x, dt, b, c, a_log) -> y

x and dt are (B, S, di), b and c (B, S, n), a_log (di, n), all of one
dtype, fp32 or bf16 (any other raises); y is (B, S, di) fp32 with
``y[t, d] = sum_j h[t, d, j] c[t, j]`` and ``h[t, d, j] = exp(dt[t, d]
a[d, j]) h[t-1, d, j] + round(dt[t, d] x[t, d]) b[t, j]``, h starting at 0,
``a = -exp(fp32(a_log))``, ``round`` the inputs' dtype.

A CUDA tensor launches the kernel (contiguous inputs, n <= 16) and counts
it in ``LAUNCHES["selective_scan"]``: one launch walks time once and takes
each exp once.  A channel's states are split over LANES lanes of a warp,
MAX_STATE // LANES = 2 consecutive states a lane; the decay is 2^(dt a2)
in one ``ex2.approx.ftz`` with ``a2 = a log2(e)`` rounded once a (channel,
state), and ``h = fma(decay, h, (dt x) b)``.  Decays below 2^-126 flush to
0, so an output is non-finite where the plain loop's is, but an inf there
may read NaN (0 x inf).  y sums in a fixed order: each lane's states in
order, ``fma(c, h, .)`` after the first product, then the 8 lanes' parts
pairwise in lane order, ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)).
``scan_plan`` sizes the grid within the card's shared memory a block.  x
and dt arrive by TMA, which takes rows on 16-byte bounds: where di x
itemsize is not a multiple of 16, or a base is not 16-byte aligned, the
wrapper first copies them into a buffer whose rows are.  A failed build or
launch raises, and nothing falls back.

Under autograd (grad enabled and an input that requires grad) the call goes
through ``SelectiveScan``, a ``torch.autograd.Function``.  On the card its
forward launches the saving variant of the kernel
(``selective_scan_save_kernel``: the same y, bit for bit, and each 32-step
tile's starting state kept, (B, ceil(S / 32), di, n) fp32) and its
backward launches ``csrc/selective_scan_bwd.cu`` (counted in
``LAUNCHES["selective_scan_bwd"]``): one reverse walk over time that
recomputes each tile's states from its checkpoint, then a second launch
that sums the blocks' partials of db and dc in block order; the gradients
come back in the inputs' dtypes, the same bits from run to run.  On the CPU
the same Function runs the plain forward and the plain backward
(``ref.selective_scan_bwd_ref``)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.scan.ref import selective_scan_bwd_ref, selective_scan_ref

# launches of the CUDA kernels, counted where they are launched and nowhere
# else: the forward (either variant) and the backward (its walk and its sum)
LAUNCHES = {"selective_scan": 0, "selective_scan_bwd": 0}

MAX_STATE = 16  # the kernel keeps a channel's n states in registers
LANES = 8  # lanes of a channel (csrc/selective_scan.cu kLanes)
CHANNELS = 32 // LANES  # channels a warp: the unit of a block's range
MAX_WARPS = 8  # consumer warps a block (kMaxWarps), beside one producer warp
TILE = 32  # time steps a tile (kTile): the step loop's unrolled body
STAGES = 8  # the ring's tiles (kStages)
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100 (227 KiB)
KERNEL = "selective_scan_kernel"  # the kernel function (the name the profiler shows)
SAVE_KERNEL = "selective_scan_save_kernel"  # the forward that keeps the checkpoints
BWD_KERNEL = "selective_scan_bwd_kernel"  # the backward's reverse walk
BWD_SUM_KERNEL = "selective_scan_bwd_sum_kernel"  # and its sums of the partials
BWD_STAGES = 4  # the backward ring's tiles (selective_scan_bwd.cu kStages)
BWD_MAX_WARPS = 7  # the backward's consumer warps a block (kBwdWarps)
_MAX_GRID_Y = 65535


class ScanPlan(NamedTuple):
    """A batch row's channels in U = ceil(di / CHANNELS) units of CHANNELS;
    block g of the row holds the units [g U // groups, (g + 1) U // groups),
    one consumer warp a unit, of ``warps`` (and one producer warp)."""
    groups: int
    warps: int


def smem_bytes(warps: int, itemsize: int) -> int:
    """The dynamic shared memory of a block of ``warps`` consumer warps at
    n = MAX_STATE, laid out as ``smem_layout`` in csrc/selective_scan.cu
    lays it: 256 bytes of mbarriers; STAGES stages, each a tile's dt and x
    row slots (128-byte aligned), its b and c and its (b, c) pairs; each
    warp's (dt, dt x) and y parts, double-buffered."""
    def align(v: int) -> int:
        return -(-v // 128) * 128
    row = -(-warps * CHANNELS * itemsize // 16) * 16 + 16
    tile = -(-TILE * MAX_STATE * itemsize // 16) * 16 + 16
    pair_row = MAX_STATE * (8 if itemsize == 4 else 4) + 16  # float2 or two bf16
    stage = align(align(align(TILE * row) + TILE * row) + 2 * tile + TILE * pair_row)
    return 256 + STAGES * stage + warps * 2 * (CHANNELS * (2 * TILE + 4) + 32 * (TILE + 4)) * 4


def bwd_smem_bytes(warps: int, itemsize: int) -> int:
    """The backward kernel's dynamic shared memory a block of ``warps``
    consumer warps at n = MAX_STATE, laid out as ``bwd_layout`` in
    csrc/selective_scan_bwd.cu lays it (the library exports its total,
    ``built_bwd_layout``, and a card test holds the two equal): 256 bytes of mbarriers; BWD_STAGES
    stages, each a tile's dt, x and dy (fp32) row slots (128-byte aligned)
    and its b and c; the db and dc parts of a tile, a channel's floats
    padded 16 banks off; each warp's (du, ddt part) of its channels' steps."""
    def align(v: int) -> int:
        return -(-v // 128) * 128
    row = -(-warps * CHANNELS * itemsize // 16) * 16 + 16
    rowf = -(-warps * CHANNELS * 4 // 16) * 16 + 16
    tile = -(-TILE * MAX_STATE * itemsize // 16) * 16 + 16
    stage = align(align(align(align(TILE * row) + TILE * row) + TILE * rowf) + 2 * tile)
    chan = -(-TILE * MAX_STATE // 32) * 32 + 16
    return (256 + BWD_STAGES * stage + 2 * warps * CHANNELS * chan * 4
            + warps * TILE * CHANNELS * 2 * 4)


def bwd_layout(warps: int, itemsize: int) -> tuple[int, int, int]:
    """(a block's shared memory, ring stages, most consumer warps) of the
    backward kernel at ``warps`` warps, n = MAX_STATE and ``itemsize``-byte
    inputs, as this module mirrors them."""
    return bwd_smem_bytes(warps, itemsize), BWD_STAGES, BWD_MAX_WARPS


def built_bwd_layout(warps: int, itemsize: int) -> tuple[int, int, int]:
    """``bwd_layout`` as the built kernel has it
    (``repro_selective_scan_bwd_layout``; builds the library on first call,
    so on a machine with the CUDA toolkit)."""
    out = (ctypes.c_int64 * 3)()
    lib = build.library()
    build.check(lib.repro_selective_scan_bwd_layout(warps, MAX_STATE, itemsize, out),
                "selective_scan_bwd layout")
    return tuple(out)


def scan_plan(b: int, di: int, itemsize: int, sms: int, smem=smem_bytes,
              max_warps: int = MAX_WARPS) -> ScanPlan:
    """The launch of a (b, S, di, n) scan of ``itemsize``-byte inputs on
    ``sms`` SMs: each batch row's units cut into ``groups`` contiguous
    ranges, one block each, so that b x groups blocks are a whole number of
    blocks an SM (one at b = 1, where every SM gets U / sms units, give or
    take one: hymba's 800 units of 4 channels as 6 or 7 a block), with at
    most as many units a block as warps fit SMEM_LIMIT (8 in bf16, 7 in
    fp32) and MAX_WARPS.  A unit is one warp, 32 lanes x 2 exps a step; an
    SM's four sub-partitions take its warps in turn, so blocks of 6 and 7
    units both put 2 warps on the busiest one.  ``smem`` and ``max_warps``
    are the kernel's shared memory a block and its most consumer warps (for
    the backward ``bwd_smem_bytes`` and BWD_MAX_WARPS: its blocks of 7 fit
    in either dtype)."""
    widest = max(w for w in range(1, max_warps + 1) if smem(w, itemsize) <= SMEM_LIMIT)
    units = -(-di // CHANNELS)
    least = -(-units // widest)  # groups of the widest blocks
    per_sm = -(-b * least // sms)
    groups = max(least, min(units, per_sm * sms // b))
    return ScanPlan(groups, -(-units // groups))


@functools.lru_cache(maxsize=64)
def device_plan(b: int, di: int, itemsize: int, device: torch.device,
                backward: bool = False) -> ScanPlan:
    """``scan_plan`` on ``device``'s SM count, kept per shape, for the
    forward kernels or, with ``backward``, the backward's."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if backward:
        return scan_plan(b, di, itemsize, sms, bwd_smem_bytes, BWD_MAX_WARPS)
    return scan_plan(b, di, itemsize, sms)


def _rows_on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous (B, S, di) tensor, or a copy of it whose rows start on
    16-byte bounds (di padded with zeros), as the TMA takes them."""
    di, size = t.shape[2], t.element_size()
    if (di * size) % 16 == 0 and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:2], -(-di * size // 16) * 16 // size))
    out[..., :di] = t
    return out


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """x, dt (B, S, di), b, c (B, S, n), a_log (di, n) -> y (B, S, di) fp32."""
    if x.dim() != 3 or dt.shape != x.shape or b.dim() != 3 or c.shape != b.shape \
            or b.shape[:2] != x.shape[:2] or a_log.shape != (x.shape[2], b.shape[2]):
        raise ValueError(f"selective_scan takes x, dt (B,S,di), b, c (B,S,n) and a_log "
                         f"(di,n); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, {tuple(a_log.shape)}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in (dt, b, c, a_log)):
        raise TypeError(f"selective_scan takes inputs of one dtype, float32 or bfloat16; "
                        f"got {[str(t.dtype) for t in (x, dt, b, c, a_log)]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, b, c, a_log)):
        return SelectiveScan.apply(x, dt, b, c, a_log)
    if on_cpu(x, dt, b, c, a_log):
        return selective_scan_ref(x, dt, b, c, a_log)
    return _launch(x, dt, b, c, a_log, save=False)[0]


def _launch(x, dt, b, c, a_log, *, save: bool):
    """The forward kernel on the card -> (y, the checkpoints or None)."""
    bsz, s, di = x.shape
    n = b.shape[2]
    dtype = x.dtype
    if n > MAX_STATE:
        raise ValueError(f"the selective-scan kernel takes n <= {MAX_STATE}; got {n}")
    if bsz > _MAX_GRID_Y:
        raise ValueError(f"the selective-scan kernel takes B <= {_MAX_GRID_Y}; got {bsz}")
    for name, t, shape in (("x", x, (bsz, s, di)), ("dt", dt, (bsz, s, di)),
                           ("b", b, (bsz, s, n)), ("c", c, (bsz, s, n)),
                           ("a_log", a_log, (di, n))):
        check_cuda_input(name, t, dtype, shape)
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    ckpt = torch.empty((bsz, -(-s // TILE), di, n), dtype=torch.float32,
                       device=x.device) if save else None
    if y.numel() == 0 or n == 0:
        return y.zero_(), ckpt
    plan = device_plan(bsz, di, x.element_size(), x.device)
    x, dt = _rows_on_16_bytes(x), _rows_on_16_bytes(dt)
    lib = build.library()
    bf16 = dtype == torch.bfloat16
    fn = lib.repro_selective_scan_bf16 if bf16 else lib.repro_selective_scan_f32
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
             y.data_ptr(), ckpt.data_ptr() if save else None, bsz, s, di, x.shape[2], n,
             plan.groups, plan.warps, stream_handle(x.device))
    build.check(err, "selective_scan")
    LAUNCHES["selective_scan"] += 1
    return y, ckpt


def _launch_bwd(x, dt, b, c, a_log, dy, ckpt):
    """The backward kernel on the card -> (dx, ddt, db, dc, da_log)."""
    bsz, s, di = x.shape
    n = b.shape[2]
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (x, dt, b, c, a_log))
    if x.numel() == 0 or n == 0:
        return tuple(g.zero_() for g in grads)
    dy = dy.to(torch.float32).contiguous()
    check_cuda_input("dy", dy, torch.float32, (bsz, s, di))
    plan = device_plan(bsz, di, x.element_size(), x.device, backward=True)
    part = torch.empty((2, plan.groups, bsz, s, n), dtype=torch.float32, device=x.device)
    da_part = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    x, dt, dy = _rows_on_16_bytes(x), _rows_on_16_bytes(dt), _rows_on_16_bytes(dy)
    lib = build.library()
    fn = lib.repro_selective_scan_bwd_bf16 if x.dtype == torch.bfloat16 \
        else lib.repro_selective_scan_bwd_f32
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
             dy.data_ptr(), ckpt.data_ptr(), part.data_ptr(), da_part.data_ptr(),
             *(g.data_ptr() for g in grads), bsz, s, di, x.shape[2], dy.shape[2], n,
             plan.groups, plan.warps, stream_handle(x.device))
    build.check(err, "selective_scan_bwd")
    LAUNCHES["selective_scan_bwd"] += 1
    return grads


class SelectiveScan(torch.autograd.Function):
    """The scan with its gradient: on the card the saving forward kernel and
    the backward kernel, on the CPU the plain versions of both."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a_log):
        if on_cpu(x, dt, b, c, a_log):
            y, ckpt = selective_scan_ref(x, dt, b, c, a_log), None
        else:
            y, ckpt = _launch(x, dt, b, c, a_log, save=True)
        ctx.save_for_backward(x, dt, b, c, a_log, ckpt)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, dt, b, c, a_log, ckpt = ctx.saved_tensors
        if ckpt is None:
            grads = selective_scan_bwd_ref(x, dt, b, c, a_log, dy)
        else:
            grads = _launch_bwd(x, dt, b, c, a_log, dy, ckpt)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
