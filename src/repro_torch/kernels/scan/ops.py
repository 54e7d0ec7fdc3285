"""Wrapper of the selective-scan kernel (``csrc/selective_scan.cu``), the
recurrence of a Mamba head:

    selective_scan(x, dt, b, c, a_log) -> y

x and dt are (B, S, di), b and c (B, S, n), a_log (di, n), all of one
dtype, fp32 or bf16 (any other raises); y is (B, S, di) fp32 with
``y[t, d] = sum_j h[t, d, j] c[t, j]`` (j in order) and ``h[t, d, j] =
exp(dt[t, d] a[d, j]) h[t-1, d, j] + round(dt[t, d] x[t, d]) b[t, j]``, h
starting at 0, ``a = -exp(fp32(a_log))``, ``round`` the inputs' dtype.

A CUDA tensor launches the kernel (contiguous inputs, n <= 16) and counts
it in ``LAUNCHES["selective_scan"]``, once a call for its passes; a failed
build or launch raises, and nothing falls back.  The kernel has no backward
pass: under autograd on the card the wrapper raises.  A CPU tensor runs the
plain version in ``ref.py``, which autograd can differentiate."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.scan.ref import selective_scan_ref

# launches of the CUDA kernel, counted where it is launched and nowhere else
# (one a wrapper call, all its passes included)
LAUNCHES = {"selective_scan": 0}

MAX_STATE = 16  # the kernel keeps a channel's n states in registers
THREADS = 128  # channels a block (csrc/selective_scan.cu kThreads)
BLOCKS_PER_SM = 8  # blocks of THREADS resident on an SM, about
WAVES = 2  # waves of resident blocks that the chunks fill
MIN_CHUNK = 64  # steps: shorter chunks spend more on the carry than they gain
_MAX_GRID_YZ = 65535
# the kernel functions, in launch order (the names the profiler shows)
KERNELS = ("selective_scan_state_kernel", "selective_scan_carry_kernel",
           "selective_scan_out_kernel")


def chunk_plan(b: int, s: int, di: int, sms: int) -> tuple[int, int]:
    """(chunk, n_chunks): the kernel cuts S steps into n_chunks chunks of
    ``chunk`` steps (the last non-empty and perhaps shorter), so that b x
    ceil(di / THREADS) blocks of channels times n_chunks fill WAVES waves of
    resident blocks on ``sms`` SMs, with chunks of at least MIN_CHUNK
    steps."""
    blocks = b * -(-di // THREADS)
    want = -(-WAVES * sms * BLOCKS_PER_SM // blocks)
    n_chunks = max(1, min(want, s // MIN_CHUNK, _MAX_GRID_YZ))
    chunk = -(-s // n_chunks)
    return chunk, -(-s // chunk)


@functools.lru_cache(maxsize=64)
def device_plan(b: int, s: int, di: int, device: torch.device) -> tuple[int, int]:
    """``chunk_plan`` on ``device``'s SM count, kept per shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return chunk_plan(b, s, di, sms)


def kernel_names(n_chunks: int) -> tuple[str, ...]:
    """The kernel functions one call launches (all three passes, or only
    the last with one chunk)."""
    return KERNELS if n_chunks > 1 else KERNELS[2:]


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
    if bsz > _MAX_GRID_YZ:
        raise ValueError(f"the selective-scan kernel takes B <= {_MAX_GRID_YZ}; got {bsz}")
    for name, t, shape in (("x", x, (bsz, s, di)), ("dt", dt, (bsz, s, di)),
                           ("b", b, (bsz, s, n)), ("c", c, (bsz, s, n)),
                           ("a_log", a_log, (di, n))):
        check_cuda_input(name, t, dtype, shape)
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or n == 0:
        return y.zero_()
    chunk, n_chunks = device_plan(bsz, s, di, x.device)
    scratch = torch.empty(2 * bsz * (n_chunks - 1) * n * di, dtype=torch.float32,
                          device=x.device)
    lib = build.library()
    fn = lib.repro_selective_scan_bf16 if dtype == torch.bfloat16 \
        else lib.repro_selective_scan_f32
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
             y.data_ptr(), scratch.data_ptr(), bsz, s, di, n, chunk, n_chunks,
             stream_handle(x.device))
    build.check(err, "selective_scan")
    LAUNCHES["selective_scan"] += 1
    return y
