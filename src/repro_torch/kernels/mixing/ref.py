"""Plain PyTorch versions of the mixing kernels (the CPU path and the
card's yardstick).  ``mix_sparse_ref`` runs the slot loop in the kernel's
order and arithmetic, so the two agree bit for bit."""
import torch

from repro_torch.core.consensus import mix_sparse


def mix_ref(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (p.float() @ w.float()).to(w.dtype)


def mix_sparse_ref(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
                   p_off: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mix_sparse(nbr_idx, p_diag, p_off, w).to(w.dtype)
