"""Plain PyTorch versions of the mixing kernels (the CPU path and the
card's yardstick), with the kernels' optional leading cell axis.
``mix_sparse_ref`` runs the slot loop in the kernel's order and
arithmetic, so the two agree bit for bit.  ``mix_ref_3xtf32``
emulates the dense kernel's split-TF32 arithmetic (tests only; ``mix_ref``
stays the yardstick)."""
import torch

from repro_torch.core.consensus import mix_sparse


def mix_ref(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (p.float() @ w.float()).to(w.dtype)


def mix_sparse_ref(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
                   p_off: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mix_sparse(nbr_idx, p_diag, p_off, w).to(w.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: PTX ``cvt.rna.tf32.f32`` (values past FLT_MAX round to inf,
    NaN stays NaN)."""
    bits = x.float().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x.float(), out)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo (up to lo's rounding), both TF32, as the kernel splits."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def mix_ref_3xtf32(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P @ W in the split arithmetic of ``csrc/mix.cu``: lo*hi + hi*lo +
    hi*hi over the TF32 halves (products of TF32 values are exact in fp32;
    the dropped lo*lo term is what it leaves out), summed in fp32 rounded
    to nearest, and the fp32 product wherever that leaves NaN (the
    kernel's epilogue: a non-finite input, or one rounded past FLT_MAX,
    makes every output it takes part in NaN).  The tensor cores'
    truncating sums within a k-step are not emulated."""
    p_hi, p_lo = split_tf32(p)
    w_hi, w_lo = split_tf32(w)
    out = (p_lo @ w_hi + p_hi @ w_lo + p_hi @ w_hi).to(w.dtype)
    return torch.where(torch.isnan(out), mix_ref(p, w), out)
