"""Wrappers of the trigger kernel (``csrc/trigger_sq.cu``).

Inputs are (m, D) rows: the canonical flat rows ``efhc.flatten_stack``
builds (fp32), or a stacked parameter leaf flattened to (m, -1) in its own
dtype (``trigger_sq_tree``: fp32 or bf16).  A CUDA tensor launches the
kernel of its dtype (contiguous; fp32 or bf16, any other dtype raises); a
CPU tensor runs the plain version in ``ref.py``, which reads the dtype and
sums in fp32 as the kernels do.  ``events`` keeps ``dev = sqrt(sq / D)``
and the strict threshold compare of the reference's wrapper; the
simulator's step does the same itself (``core.efhc.step``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.trigger.ref import trigger_sq_ref
from repro_torch.prng import sqrt_f32
from repro_torch.tree import tree_leaves

# launches of the CUDA kernels, counted where they are launched and
# nowhere else (one a wrapper call, both passes included): "trigger_sq"
# the fp32 entry, "trigger_sq_bf16" the bf16 one
LAUNCHES = {"trigger_sq": 0, "trigger_sq_bf16": 0}

# the slab plan (csrc/trigger_sq.cu): a block of 512 threads keeps 4
# 16-byte loads of each operand in flight a thread
BLOCKS_PER_SM = 4  # such blocks resident on an SM (2048 threads)
WAVES = 2  # waves of resident blocks that few long rows are cut into
MIN_SLAB_BYTES = 512 * 4 * 16  # of each operand: one round of loads a thread
MAX_SLAB_BYTES = 8 * MIN_SLAB_BYTES


def slab_plan(m: int, n: int, itemsize: int, sms: int) -> tuple[int, int]:
    """(cols, n_slab): the kernel cuts each of m rows of n elements of
    ``itemsize`` bytes into n_slab column slabs.  Slab k > 0 starts at
    head + k cols, where head < 16 / itemsize is the row's run before its
    first 16-byte boundary; slab 0 takes the head, the last slab runs to
    n.  cols is a multiple of 16 bytes, and n_slab leaves the last slab
    non-empty whatever the head.  Rows that fill the card's ``sms`` SMs
    with resident blocks keep one slab; fewer rows are cut into at least
    WAVES x the resident blocks, each slab MIN_SLAB_BYTES to
    MAX_SLAB_BYTES of each operand (short blocks, or long ones that leave
    a ragged last wave, lose bandwidth)."""
    vec = 16 // itemsize
    resident = sms * BLOCKS_PER_SM
    if m >= resident:
        return -(-n // vec) * vec, 1
    cols = -(-n // -(-WAVES * resident // m))
    cols = min(max(cols, MIN_SLAB_BYTES // itemsize), MAX_SLAB_BYTES // itemsize)
    cols = -(-cols // vec) * vec
    return cols, max(1, (n - vec) // cols + 1)


@functools.lru_cache(maxsize=64)
def device_plan(m: int, n: int, itemsize: int, device: torch.device) -> tuple[int, int]:
    """``slab_plan`` on ``device``'s SM count, kept per shape: the
    wrapper's host time before the launch is part of a short call's time."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return slab_plan(m, n, itemsize, sms)


def trigger_sq(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """(m, D) x2 -> (m,) fp32 squared deviation sum_n (w - w_hat)^2."""
    if w.dim() != 2 or w.shape != w_hat.shape:
        raise ValueError(f"trigger_sq takes two (m, D) arrays of one shape; "
                         f"got {tuple(w.shape)} and {tuple(w_hat.shape)}")
    if on_cpu(w, w_hat):
        return trigger_sq_ref(w, w_hat)
    m, n = w.shape
    bf16 = w.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    check_cuda_input("w", w, dtype, (m, n))
    check_cuda_input("w_hat", w_hat, dtype, (m, n))
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.float32, device=w.device)
    cols, n_slab = device_plan(m, n, w.element_size(), w.device)
    # out and, with several slabs, the (m, n_slab) slab sums: one allocation
    buf = torch.empty(m * (1 + (n_slab if n_slab > 1 else 0)), dtype=torch.float32,
                      device=w.device)
    entry = build.library().repro_trigger_sq_bf16 if bf16 else build.library().repro_trigger_sq_f32
    err = entry(w.data_ptr(), w_hat.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * m,
                m, n, cols, n_slab, stream_handle(w.device))
    name = "trigger_sq_bf16" if bf16 else "trigger_sq"
    build.check(err, name)
    LAUNCHES[name] += 1
    return buf[:m]


def trigger_sq_tree(w_tree, h_tree) -> torch.Tensor:
    """Pytree form: each pair of leaves (m, ...) flattened to (m, -1) and
    reduced in its own dtype, the (m,) fp32 sums added leaf by leaf in
    ``tree_leaves`` order."""
    tot = None
    for w, h in zip(tree_leaves(w_tree), tree_leaves(h_tree), strict=True):
        m = w.shape[0]
        s = trigger_sq(w.reshape(m, -1), h.reshape(m, -1))
        tot = s if tot is None else tot + s
    return tot


def events(w: torch.Tensor, w_hat: torch.Tensor, *, n_model: int, r: float,
           rho: torch.Tensor, gamma_k) -> torch.Tensor:
    """The Event-2 decisions of (m, D) rows: ``sqrt(sq / n_model) > r * rho
    * gamma_k``, strict (a zero threshold with w == w_hat must not fire)."""
    dev = sqrt_f32(trigger_sq(w, w_hat) / n_model)
    return dev > r * rho * gamma_k
