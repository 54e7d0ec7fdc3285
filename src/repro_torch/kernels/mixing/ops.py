"""Wrappers of the mixing kernels (``csrc/mix.cu``, ``csrc/mix_sparse.cu``).

A CUDA tensor launches the kernel (fp32, contiguous; ELL indices int64)
or raises; a CPU tensor runs the plain version in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref

# launches of the CUDA kernels, counted where they are launched and
# nowhere else
LAUNCHES = {"mix": 0, "mix_sparse": 0}

_MAX_GRID_Y = 65535


def mix(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense consensus mixing: p (m, m), w (m, D) -> P @ W (m, D)."""
    if w.dim() != 2 or tuple(p.shape) != (w.shape[0], w.shape[0]):
        raise ValueError(f"mix takes p (m, m) and w (m, D); got "
                         f"{tuple(p.shape)} and {tuple(w.shape)}")
    if on_cpu(p, w):
        return mix_ref(p, w)
    m, n = w.shape
    check_cuda_input("p", p, torch.float32, (m, m))
    check_cuda_input("w", w, torch.float32, (m, n))
    if -(-m // 128) > _MAX_GRID_Y:
        raise ValueError(f"mix kernel takes m <= {_MAX_GRID_Y * 128}; got {m}")
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out
    err = build.library().repro_mix_f32(
        p.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
        stream_handle(w.device))
    build.check(err, "mix")
    LAUNCHES["mix"] += 1
    return out


def mix_sparse(nbr_idx: torch.Tensor, p_diag: torch.Tensor,
               p_off: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ELL gather-mix: nbr_idx/p_off (m, d_max), p_diag (m,) or (m, 1),
    w (m, D) -> p_diag * w + sum_s p_off[:, s] * w[nbr_idx[:, s]]."""
    if w.dim() != 2 or nbr_idx.dim() != 2 or nbr_idx.shape[0] != w.shape[0] \
            or p_off.shape != nbr_idx.shape or p_diag.numel() != w.shape[0]:
        raise ValueError(
            f"mix_sparse takes nbr_idx/p_off (m, d_max), p_diag (m,), w (m, D);"
            f" got {tuple(nbr_idx.shape)}, {tuple(p_off.shape)}, "
            f"{tuple(p_diag.shape)}, {tuple(w.shape)}")
    if on_cpu(nbr_idx, p_diag, p_off, w):
        return mix_sparse_ref(nbr_idx, p_diag, p_off, w)
    m, n = w.shape
    d_max = nbr_idx.shape[1]
    check_cuda_input("nbr_idx", nbr_idx, torch.int64, (m, d_max))
    check_cuda_input("p_off", p_off, torch.float32, (m, d_max))
    check_cuda_input("p_diag", p_diag.reshape(m), torch.float32, (m,))
    check_cuda_input("w", w, torch.float32, (m, n))
    if -(-n // 1024) > _MAX_GRID_Y:
        raise ValueError(f"mix_sparse kernel takes D <= {_MAX_GRID_Y * 1024}; got {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out
    err = build.library().repro_mix_sparse_f32(
        nbr_idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
        out.data_ptr(), m, d_max, n, stream_handle(w.device))
    build.check(err, "mix_sparse")
    LAUNCHES["mix_sparse"] += 1
    return out
