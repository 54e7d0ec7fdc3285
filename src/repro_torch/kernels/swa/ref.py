"""Plain PyTorch version of the SWA kernel (the CPU path and the card's
yardstick): dense masked sliding-window causal attention with GQA, in
fp32, output cast to q's dtype.  It builds the (S, S) scores, so it is
for sequences whose H * S^2 fp32 scores fit in memory."""
import math

import torch


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: int) -> torch.Tensor:
    """q (B,H,S,dh), k/v (B,G,S,dh) -> (B,H,S,dh)."""
    b, h, s, dh = q.shape
    g = k.shape[1]
    qg = q.reshape(b, g, h // g, s, dh)
    scores = torch.einsum("bgrsk,bgtk->bgrst", qg.float(),
                          k.float()) / math.sqrt(dh)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    scores.masked_fill_(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,bgtk->bgrsk", p, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)
