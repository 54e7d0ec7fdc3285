"""Plain PyTorch versions of the SWA kernels (the CPU path and the card's
yardstick): dense masked sliding-window causal attention with GQA, in
fp32, output cast to q's dtype.  They build the (S, S) scores, so they are
for sequences whose H * S^2 fp32 scores fit in memory.  ``swa_ref_bf16_p``
and ``swa_ref_3xtf32`` emulate the two tensor-core kernels' arithmetic
(tests only; ``swa_ref`` stays the yardstick)."""
import math

import torch

from repro_torch.kernels.mixing.ref import tf32_rna


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


# V^T's key order within each 8-key k-step in the split-TF32 kernel: the
# key at position i of the group is KEY_PERM[i] (keys 2i at i, 2i + 1 at
# i + 4), so that P's accumulator fragment is wgmma's TF32 A fragment
KEY_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo as the split-TF32 kernel splits it: hi = rna_tf32(x), lo
    = x - hi (exact) as the tensor cores read it, with the 13 bits below
    TF32's mantissa dropped."""
    hi = tf32_rna(x)
    lo = (x.float() - hi).view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _split_product(a: torch.Tensor, b: torch.Tensor, eq: str, k_dim: int) -> torch.Tensor:
    """einsum ``eq`` of a and b over their shared k axis (``k_dim`` of b,
    the last of a) in split TF32, k-step by k-step: each step's
    lo*hi + hi*lo + hi*hi over 8 values of k, added to the fp32 result."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    out = None
    for k0 in range(0, a.shape[-1], 8):
        sa = (Ellipsis, slice(k0, k0 + 8))
        sb = (slice(None),) * k_dim + (slice(k0, k0 + 8),)
        part = (torch.einsum(eq, a_lo[sa], b_hi[sb]) + torch.einsum(eq, a_hi[sa], b_lo[sb])
                + torch.einsum(eq, a_hi[sa], b_hi[sb]))
        out = part if out is None else out + part
    return out


def swa_ref_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int) -> torch.Tensor:
    """The split-TF32 kernel's arithmetic, for the tests: as ``swa_ref``, but
    S = Q K^T and P V each sum, k-step by k-step (8 values of k: dh for S,
    keys in ``KEY_PERM`` order for P V), lo*hi + hi*lo + hi*hi over the
    TF32 halves of ``_split`` into an fp32 result (products of TF32 values
    are exact in fp32; the dropped lo*lo term is what it leaves out), P =
    exp(s - rowmax) unnormalised with l summed from it (clamped at 1e-30),
    and ``swa_ref``'s value wherever that leaves NaN (the kernel's epilogue
    recomputes such outputs in fp32).  The online softmax's rescaling and
    the tensor cores' truncating sums within a k-step are not emulated.
    q (B,H,S,dh), k/v (B,G,S,dh) -> (B,H,S,dh)."""
    b, h, s, dh = q.shape
    g = k.shape[1]
    qg = q.float().reshape(b, g, h // g, s, dh)
    scores = _split_product(qg, k.float(), "bgrsk,bgtk->bgrst", 3) / math.sqrt(dh)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    scores = scores.masked_fill_(~mask, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pad = -s % 8  # zero keys up to a whole k-step
    p = torch.nn.functional.pad(p, (0, pad))
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    perm = (torch.arange(0, s + pad, 8)[:, None] + torch.tensor(KEY_PERM)).reshape(-1)
    out = _split_product(p[..., perm], vv[:, :, perm], "bgrst,bgtk->bgrsk", 2) / l
    out = out.reshape(q.shape)
    return torch.where(torch.isnan(out), swa_ref(q, k, v, window=window).float(),
                       out).to(q.dtype)
