"""Plain PyTorch versions of the SWA kernels (the CPU path and the card's
yardstick): dense masked sliding-window causal attention with GQA, in
fp32, output cast to q's dtype.  They build the (S, S) scores, so they are
for sequences whose H * S^2 fp32 scores fit in memory."""
import math

import torch


def _masked_scores(q: torch.Tensor, k: torch.Tensor, window: int) -> torch.Tensor:
    """(B, G, H/G, S, S) fp32 scores, -1e30 outside the causal window."""
    b, h, s, dh = q.shape
    g = k.shape[1]
    qg = q.reshape(b, g, h // g, s, dh)
    scores = torch.einsum("bgrsk,bgtk->bgrst", qg.float(),
                          k.float()) / math.sqrt(dh)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return scores.masked_fill_(~mask, -1e30)


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: int) -> torch.Tensor:
    """q (B,H,S,dh), k/v (B,G,S,dh) -> (B,H,S,dh)."""
    p = torch.softmax(_masked_scores(q, k, window), dim=-1)
    out = torch.einsum("bgrst,bgtk->bgrsk", p, v.float())
    return out.reshape(q.shape).to(q.dtype)


def swa_ref_bf16_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int) -> torch.Tensor:
    """The tensor-core kernel's rounding, for the tests: as ``swa_ref``, but
    the unnormalised P = exp(s - rowmax) enters P V rounded to bf16 and l is
    summed from the fp32 P (clamped at 1e-30).  q (B,H,S,dh), k/v (B,G,S,dh)
    -> (B,H,S,dh)."""
    scores = _masked_scores(q, k, window)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrst,bgtk->bgrsk", p.bfloat16().float(), v.float()) / l
    return out.reshape(q.shape).to(q.dtype)
