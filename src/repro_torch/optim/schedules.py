"""Step-size policies (paper Assumption 7), in torch.

* constant:          alpha^(k) = alpha                       (Thm 1)
* paper_diminishing: alpha^(k) = alpha0 / (1 + k/gamma)^theta (Thm 2; the
                     paper's Sec. IV runs alpha^(k) = 0.1/sqrt(1+k))
"""
from __future__ import annotations

import torch


def constant(alpha: float):
    def sched(k: torch.Tensor) -> torch.Tensor:
        k = torch.as_tensor(k)
        return torch.full(k.shape, alpha, dtype=torch.float32, device=k.device)

    return sched


def paper_diminishing(alpha0: float = 0.1, gamma: float = 1.0, theta: float = 0.5):
    if not 0.5 <= theta <= 1.0:
        raise ValueError(f"theta must be in [0.5, 1], got {theta}")

    def sched(k: torch.Tensor) -> torch.Tensor:
        # XLA rewrites the division into alpha0 * base ** -theta; the power
        # is taken in float64 and rounded once, the closest torch gets to
        # XLA's float32 pow (1-ulp differences in well under 0.1% of k)
        base = 1.0 + torch.as_tensor(k).float() / gamma
        return alpha0 * torch.pow(base.double(), -theta).float()

    return sched
