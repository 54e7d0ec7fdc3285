"""repro_torch: the EF-HC decentralized-FL simulator and the architecture
models' serving path in PyTorch and CUDA.

A port of the JAX package ``repro`` for NVIDIA Hopper GPUs.  It keeps
``repro``'s layout and names (``repro_torch/core/efhc.py`` is the
counterpart of ``repro/core/efhc.py``, and so on).  The simulator
reproduces ``repro``'s random streams, so a run realizes the same graphs,
triggers and trajectories from the same seed.  ``models``, ``configs``
and ``launch.steps`` serve starcoder2-15b (prefill and one-token decode).
Every TPU kernel of ``repro`` is a hand-written CUDA kernel here
(``repro_torch/kernels``).

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; they never move to the CPU on their own.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The ``torch.device`` a run uses; raises when CUDA is asked for and
    the machine has none (no quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for CUDA, but torch finds no GPU; "
            f"pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu'; got {device!r}")
    return dev
