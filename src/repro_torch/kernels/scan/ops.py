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
launch raises, and nothing falls back.  The kernel has no backward pass:
under autograd on the card the wrapper raises.  A CPU tensor runs the
plain version in ``ref.py``, which autograd can differentiate."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.scan.ref import selective_scan_ref

# launches of the CUDA kernel, counted where it is launched and nowhere else
LAUNCHES = {"selective_scan": 0}

MAX_STATE = 16  # the kernel keeps a channel's n states in registers
LANES = 8  # lanes of a channel (csrc/selective_scan.cu kLanes)
CHANNELS = 32 // LANES  # channels a warp: the unit of a block's range
MAX_WARPS = 8  # consumer warps a block (kMaxWarps), beside one producer warp
TILE = 32  # time steps a tile (kTile): the step loop's unrolled body
STAGES = 8  # the ring's tiles (kStages)
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on the H100 (227 KiB)
KERNEL = "selective_scan_kernel"  # the kernel function (the name the profiler shows)
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


def scan_plan(b: int, di: int, itemsize: int, sms: int) -> ScanPlan:
    """The launch of a (b, S, di, n) scan of ``itemsize``-byte inputs on
    ``sms`` SMs: each batch row's units cut into ``groups`` contiguous
    ranges, one block each, so that b x groups blocks are a whole number of
    blocks an SM (one at b = 1, where every SM gets U / sms units, give or
    take one: hymba's 800 units of 4 channels as 6 or 7 a block), with at
    most as many units a block as warps fit SMEM_LIMIT (8 in bf16, 7 in
    fp32) and MAX_WARPS.  A unit is one warp, 32 lanes x 2 exps a step; an
    SM's four sub-partitions take its warps in turn, so blocks of 6 and 7
    units both put 2 warps on the busiest one."""
    widest = max(w for w in range(1, MAX_WARPS + 1) if smem_bytes(w, itemsize) <= SMEM_LIMIT)
    units = -(-di // CHANNELS)
    least = -(-units // widest)  # groups of the widest blocks
    per_sm = -(-b * least // sms)
    groups = max(least, min(units, per_sm * sms // b))
    return ScanPlan(groups, -(-units // groups))


@functools.lru_cache(maxsize=64)
def device_plan(b: int, di: int, itemsize: int, device: torch.device) -> ScanPlan:
    """``scan_plan`` on ``device``'s SM count, kept per shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
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
    if on_cpu(x, dt, b, c, a_log):
        return selective_scan_ref(x, dt, b, c, a_log)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, b, c, a_log)):
        raise NotImplementedError(
            "the selective-scan kernel has no backward pass: train a hybrid model on "
            "the CPU (the plain version); a backward scan kernel for hymba training on "
            "the card is ROADMAP Queue 2 item K3")
    bsz, s, di = x.shape
    n = b.shape[2]
    if n > MAX_STATE:
        raise ValueError(f"the selective-scan kernel takes n <= {MAX_STATE}; got {n}")
    if bsz > _MAX_GRID_Y:
        raise ValueError(f"the selective-scan kernel takes B <= {_MAX_GRID_Y}; got {bsz}")
    for name, t, shape in (("x", x, (bsz, s, di)), ("dt", dt, (bsz, s, di)),
                           ("b", b, (bsz, s, n)), ("c", c, (bsz, s, n)),
                           ("a_log", a_log, (di, n))):
        check_cuda_input(name, t, dtype, shape)
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or n == 0:
        return y.zero_()
    plan = device_plan(bsz, di, x.element_size(), x.device)
    x, dt = _rows_on_16_bytes(x), _rows_on_16_bytes(dt)
    lib = build.library()
    fn = lib.repro_selective_scan_bf16 if dtype == torch.bfloat16 \
        else lib.repro_selective_scan_f32
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
             y.data_ptr(), bsz, s, di, x.shape[2], n, plan.groups, plan.warps,
             stream_handle(x.device))
    build.check(err, "selective_scan")
    LAUNCHES["selective_scan"] += 1
    return y
