"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
the JAX package:

  trigger/ - per-device ||w - w_hat||^2 row reduction   (paper Event 2)
  mixing/  - dense P @ W and the ELL gather-mix          (paper Event 3)
  swa/     - sliding-window causal attention with GQA    (model prefill):
             tensor cores for bf16 (wgmma + TMA) and for fp32 (split TF32)

and two that replace no TPU kernel:

  scan/    - the Mamba selective scan of hybrid blocks    (model prefill,
             and its gradient for training), where the reference runs
             an XLA associative scan and its transpose
  slstm/   - the sLSTM recurrence of xLSTM blocks         (model prefill
             and decode), where the reference runs a lax.scan over time

Each ``ops`` wrapper launches its kernel for CUDA tensors (built on first
use by ``build.py`` from ``csrc/``) and counts the launch in its module's
``LAUNCHES``; for CPU tensors, and only then, it runs the plain PyTorch
version in ``ref.py``.
"""
from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a device mix or a
    device the kernels do not serve."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on one "
                     f"CUDA device; got {sorted(types)}")


def check_cuda_input(name: str, t: torch.Tensor, dtype: torch.dtype,
                     shape: tuple[int, ...]) -> None:
    """Raises unless ``t`` has the dtype, shape and contiguity the kernel
    takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on the card; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, for a launch: read by
    the raw getter that torch's own generated launchers use, without
    building a ``torch.cuda.Stream`` object (microseconds of host time a
    launch, which event-timed kernels pay)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
