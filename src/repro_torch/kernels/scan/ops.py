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
``LAUNCHES["selective_scan_bwd"]``): one reverse walk over time, two blocks
an SM (``BWD_BLOCKS_PER_SM``), that runs each tile forward from its
checkpoint to the starts of its four 8-step groups and walks the groups
back, each recomputed into registers; du and the decay's part of ddt sum
over a channel's 8 lanes pairwise in lane order, db and dc over a warp's 4
channels and then the block's warps pairwise in channel order (shuffles,
then shared memory), and dx and ddt leave a tile as rows; then a second
launch sums the blocks' partials of db and dc in block order.  The
gradients come back in the inputs' dtypes, the same bits from run to run.
On the CPU the same Function runs the plain forward and the plain backward
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
GROUP = 8  # steps of the backward's groups (selective_scan_bwd.cu kGroup)
KERNEL = "selective_scan_kernel"  # the kernel function (the name the profiler shows)
SAVE_KERNEL = "selective_scan_save_kernel"  # the forward that keeps the checkpoints
BWD_KERNEL = "selective_scan_bwd_kernel"  # the backward's reverse walk
BWD_SUM_KERNEL = "selective_scan_bwd_sum_kernel"  # and its sums of the partials
BWD_STAGES = 2  # the backward ring's tiles (selective_scan_bwd.cu kStages)
BWD_MAX_WARPS = 7  # the backward's warps a block (kBwdWarps)
BWD_BLOCKS_PER_SM = 2  # the backward's blocks an SM (kBlocksPerSm)
SM_SMEM = 233472  # shared memory an SM gives its blocks on the H100 (228 KiB)
BLOCK_RESERVED = 1024  # of it, reserved for each resident block
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
    ``built_bwd_layout``, and a card test holds the two equal): 256 bytes of
    mbarriers; BWD_STAGES stages, each a tile's dt, x and dy (fp32) row
    slots (128-byte aligned; dt's and x's padded by 16 bytes) and its b and
    c; each warp's (dt, u) pairs of its channels' steps, a channel's padded
    by two; then, double-buffered, the warps' 2 MAX_STATE db and dc sums of
    each step and the tile's dx and ddt rows of the block's channels in the
    inputs' dtype; and each lane's da and its compensation."""
    def align(v: int) -> int:
        return -(-v // 128) * 128
    row = -(-warps * CHANNELS * itemsize // 16) * 16 + 16
    rowf = -(-warps * CHANNELS * 4 // 16) * 16
    tile = -(-TILE * MAX_STATE * itemsize // 16) * 16 + 16
    stage = align(align(align(align(TILE * row) + TILE * row) + TILE * rowf) + 2 * tile)
    pairs = warps * CHANNELS * (TILE + 2) * 8
    sums = 2 * warps * TILE * 2 * MAX_STATE * 4
    rows = 2 * 2 * TILE * warps * CHANNELS * itemsize
    kahan = warps * 32 * 2 * (MAX_STATE // LANES) * 4
    return 256 + BWD_STAGES * stage + pairs + sums + rows + kahan


def bwd_layout(warps: int, itemsize: int) -> tuple[int, int, int, int]:
    """(a block's shared memory, ring stages, most consumer warps, blocks an
    SM) of the backward kernel at ``warps`` warps, n = MAX_STATE and
    ``itemsize``-byte inputs, as this module mirrors them."""
    return bwd_smem_bytes(warps, itemsize), BWD_STAGES, BWD_MAX_WARPS, BWD_BLOCKS_PER_SM


def built_bwd_layout(warps: int, itemsize: int) -> tuple[int, int, int, int]:
    """``bwd_layout`` as the built kernel has it
    (``repro_selective_scan_bwd_layout``; builds the library on first call,
    so on a machine with the CUDA toolkit)."""
    out = (ctypes.c_int64 * 4)()
    lib = build.library()
    build.check(lib.repro_selective_scan_bwd_layout(warps, MAX_STATE, itemsize, out),
                "selective_scan_bwd layout")
    return tuple(out)


def bwd_blocks_per_sm(warps: int, itemsize: int) -> int:
    """The backward walk's resident blocks an SM on the current card at
    ``warps`` warps and n = MAX_STATE (the CUDA occupancy API, through
    ``repro_selective_scan_bwd_occupancy``; builds the library on first
    call)."""
    out = (ctypes.c_int64 * 1)()
    build.check(build.library().repro_selective_scan_bwd_occupancy(warps, itemsize, out),
                "selective_scan_bwd occupancy")
    return int(out[0])


def scan_plan(b: int, di: int, itemsize: int, sms: int, smem=smem_bytes,
              max_warps: int = MAX_WARPS, per_sm: int = 1) -> ScanPlan:
    """The launch of a (b, S, di, n) scan of ``itemsize``-byte inputs on
    ``sms`` SMs that hold up to ``per_sm`` blocks each: each batch row's
    units cut into ``groups`` contiguous ranges, one block each, so that b x
    groups blocks fill whole waves of sms x k blocks for some k <= per_sm
    (the forward, one block an SM: at b = 1 every SM gets U / sms units,
    give or take one, hymba's 800 units of 4 channels as 6 or 7 a block),
    with at most as many units a block as warps fit the SM's shared memory
    shared by ``per_sm`` blocks (SM_SMEM / per_sm less BLOCK_RESERVED:
    SMEM_LIMIT at one block; the forward 8 warps in bf16, 7 in fp32) and
    ``max_warps``.  A unit is one warp, 32 lanes x 2 exps a step; an SM's
    four sub-partitions take its warps in turn.  Of the k, the plan takes
    the one whose busiest SM holds the fewest units (its blocks, b x groups
    spread over the SMs, times a block's units), the more blocks on a tie:
    the SMs run side by side, and the busiest one sets the time.
    ``smem``, ``max_warps`` and ``per_sm`` are the kernel's shared memory a
    block, its most consumer warps and its blocks an SM (for the backward
    ``bwd_smem_bytes``, BWD_MAX_WARPS and BWD_BLOCKS_PER_SM: at hymba's
    train shape (2, S, 3200) 132 blocks a row of 6-7 warps, two an SM, 14
    units on the busiest; at b = 1 132 of 6-7, one an SM: two an SM would
    be 264 blocks of 3-4, 8 units on the busiest SMs in place of 7)."""
    limit = SM_SMEM // per_sm - BLOCK_RESERVED
    widest = max(w for w in range(1, max_warps + 1) if smem(w, itemsize) <= limit)
    units = -(-di // CHANNELS)
    least = -(-units // widest)  # groups of the widest blocks

    def groups_at(slots: int) -> int:
        waves = -(-b * least // slots)
        return max(least, min(units, waves * slots // b))

    def busiest(groups: int) -> tuple[int, int]:
        return -(-b * groups // sms) * -(-units // groups), -groups

    groups = min((groups_at(sms * k) for k in range(1, per_sm + 1)), key=busiest)
    return ScanPlan(groups, -(-units // groups))


@functools.lru_cache(maxsize=64)
def device_plan(b: int, di: int, itemsize: int, device: torch.device,
                backward: bool = False) -> ScanPlan:
    """``scan_plan`` on ``device``'s SM count, kept per shape, for the
    forward kernels or, with ``backward``, the backward's."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if backward:
        return scan_plan(b, di, itemsize, sms, bwd_smem_bytes, BWD_MAX_WARPS, BWD_BLOCKS_PER_SM)
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
