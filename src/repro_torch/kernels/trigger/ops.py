"""Wrappers of the trigger kernel (``csrc/trigger_sq.cu``).

Inputs are the canonical (m, D) flat rows ``efhc.flatten_stack`` builds.
A CUDA tensor launches the kernel (fp32, contiguous) or raises; a CPU
tensor runs the plain version in ``ref.py``.  The caller keeps
``dev = sqrt(sq / D)`` and the strict threshold compare, as
``core.efhc.step`` does."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.trigger.ref import trigger_sq_ref

# launches of the CUDA kernel, counted where it is launched and nowhere else
LAUNCHES = {"trigger_sq": 0}


def trigger_sq(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """(m, D) x2 -> (m,) fp32 squared deviation sum_n (w - w_hat)^2."""
    if w.dim() != 2 or w.shape != w_hat.shape:
        raise ValueError(f"trigger_sq takes two (m, D) arrays of one shape; "
                         f"got {tuple(w.shape)} and {tuple(w_hat.shape)}")
    if on_cpu(w, w_hat):
        return trigger_sq_ref(w, w_hat)
    m, n = w.shape
    check_cuda_input("w", w, torch.float32, (m, n))
    check_cuda_input("w_hat", w_hat, torch.float32, (m, n))
    out = torch.empty(m, dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out.zero_()
    err = build.library().repro_trigger_sq_f32(
        w.data_ptr(), w_hat.data_ptr(), out.data_ptr(), m, n,
        stream_handle(w.device))
    build.check(err, "trigger_sq")
    LAUNCHES["trigger_sq"] += 1
    return out
