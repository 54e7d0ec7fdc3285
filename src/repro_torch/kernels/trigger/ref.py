"""Plain PyTorch version of the trigger kernel (the CPU path and the
card's yardstick)."""
import torch


def trigger_sq_ref(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    d = w.float() - w_hat.float()
    return (d * d).sum(dim=1)
