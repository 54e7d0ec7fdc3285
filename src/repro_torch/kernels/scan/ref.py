"""Plain PyTorch version of the selective-scan kernel: a sequential loop
over time on a (B, di, n) fp32 state, with the kernel's arithmetic (the
reference's ``repro/models/ssm.py:77-88`` computes the same recurrence as an
associative scan, in another order).  Time runs in blocks of TIME_BLOCK
steps: a block's decays and inputs are computed at once, the loop over its
steps is two ops a step, and its outputs are one product and sum, which
gives the same values as computing each step alone with a bounded
(B, TIME_BLOCK, di, n) working set."""
from __future__ import annotations

import torch

TIME_BLOCK = 256


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """x, dt (B, S, di), b, c (B, S, n), a_log (di, n), one dtype -> y (B, S,
    di) fp32: ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t``, ``y_t = h_t .
    c_t`` with ``a = -exp(a_log)`` and h_0 = 0; ``dt_t x_t`` is rounded to
    the inputs' dtype, everything else is fp32."""
    a = -torch.exp(a_log.float())
    dtx = (dt * x).float()
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t0 in range(0, x.shape[1], TIME_BLOCK):
        sl = slice(t0, t0 + TIME_BLOCK)
        decay = torch.exp(dt[:, sl, :, None].float() * a)
        inp = dtx[:, sl, :, None] * b[:, sl, None, :].float()
        hs = []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inp[:, t]
            hs.append(h)
        ys.append((torch.stack(hs, 1) * c[:, sl, None, :].float()).sum(-1))
    if not ys:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return torch.cat(ys, 1)
