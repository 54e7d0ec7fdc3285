"""Wrappers of the trigger kernel (``csrc/trigger_sq.cu``).

Inputs are (m, D) rows: the canonical flat rows ``efhc.flatten_stack``
builds (fp32), or a stacked parameter leaf flattened to (m, -1) in its own
dtype (``trigger_sq_tree``: fp32 or bf16).  A CUDA tensor launches the
kernel of its dtype (contiguous; fp32 or bf16, any other dtype raises); a
CPU tensor runs the plain version in ``ref.py``, which reads the dtype and
sums in fp32 as the kernels do.  ``events`` keeps ``dev = sqrt(sq / D)``
and the strict threshold compare of the reference's wrapper; the
simulator's step does the same itself (``core.efhc.step``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.trigger.ref import trigger_sq_ref
from repro_torch.prng import sqrt_f32
from repro_torch.tree import tree_leaves

# launches of the CUDA kernels, counted where they are launched and
# nowhere else: "trigger_sq" the fp32 kernel, "trigger_sq_bf16" the bf16
# entry's two passes (one launch)
LAUNCHES = {"trigger_sq": 0, "trigger_sq_bf16": 0}

BF16_COLS = 32768  # columns a block of the bf16 entry's first pass sums


def trigger_sq(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """(m, D) x2 -> (m,) fp32 squared deviation sum_n (w - w_hat)^2."""
    if w.dim() != 2 or w.shape != w_hat.shape:
        raise ValueError(f"trigger_sq takes two (m, D) arrays of one shape; "
                         f"got {tuple(w.shape)} and {tuple(w_hat.shape)}")
    if on_cpu(w, w_hat):
        return trigger_sq_ref(w, w_hat)
    m, n = w.shape
    bf16 = w.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    check_cuda_input("w", w, dtype, (m, n))
    check_cuda_input("w_hat", w_hat, dtype, (m, n))
    out = torch.empty(m, dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out.zero_()
    if bf16:
        if m > 65535:
            raise ValueError(f"the bf16 trigger kernel takes m <= 65535; got {m}")
        n_slab = -(-n // BF16_COLS)
        part = torch.empty((m, n_slab), dtype=torch.float32, device=w.device)
        err = build.library().repro_trigger_sq_bf16(
            w.data_ptr(), w_hat.data_ptr(), out.data_ptr(), part.data_ptr(), m, n,
            n_slab, stream_handle(w.device))
        build.check(err, "trigger_sq_bf16")
        LAUNCHES["trigger_sq_bf16"] += 1
        return out
    err = build.library().repro_trigger_sq_f32(
        w.data_ptr(), w_hat.data_ptr(), out.data_ptr(), m, n,
        stream_handle(w.device))
    build.check(err, "trigger_sq")
    LAUNCHES["trigger_sq"] += 1
    return out


def trigger_sq_tree(w_tree, h_tree) -> torch.Tensor:
    """Pytree form: each pair of leaves (m, ...) flattened to (m, -1) and
    reduced in its own dtype, the (m,) fp32 sums added leaf by leaf in
    ``tree_leaves`` order."""
    tot = None
    for w, h in zip(tree_leaves(w_tree), tree_leaves(h_tree), strict=True):
        m = w.shape[0]
        s = trigger_sq(w.reshape(m, -1), h.reshape(m, -1))
        tot = s if tot is None else tot + s
    return tot


def events(w: torch.Tensor, w_hat: torch.Tensor, *, n_model: int, r: float,
           rho: torch.Tensor, gamma_k) -> torch.Tensor:
    """The Event-2 decisions of (m, D) rows: ``sqrt(sq / n_model) > r * rho
    * gamma_k``, strict (a zero threshold with w == w_hat must not fire)."""
    dev = sqrt_f32(trigger_sq(w, w_hat) / n_model)
    return dev > r * rho * gamma_k
