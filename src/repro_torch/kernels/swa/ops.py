"""Wrapper of the sliding-window attention kernel (``csrc/swa_attention.cu``)
in the model's (B, S, H, dh) layout.

A CUDA tensor launches the kernel (fp32 or bf16, contiguous, dh in {32,
64, 128}) or raises; a CPU tensor runs the plain version in ``ref.py``.
The kernel reads the (B, S, ., dh) rows with their strides, so the card
path needs none of the transposes the plain version takes."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.swa.ref import swa_ref

# launches of the CUDA kernel, counted where it is launched and nowhere else
LAUNCHES = {"swa_attention": 0}

_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_YZ = 65535


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, causal: bool = True) -> torch.Tensor:
    """q (B,S,H,dh), k/v (B,S,G,dh) -> (B,S,H,dh) in q's dtype."""
    if not causal:
        raise ValueError("the SWA kernel is causal-only")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"swa_attention takes q (B,S,H,dh) and k/v (B,S,G,dh) "
                         f"with H % G == 0; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window < 1:
        raise ValueError(f"window must be >= 1; got {window}")
    if on_cpu(q, k, v):
        out = swa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      window=window)
        return out.transpose(1, 2)
    b, s, h, dh = q.shape
    g = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the SWA kernel takes float32 or bfloat16; got {q.dtype}")
    check_cuda_input("q", q, q.dtype, (b, s, h, dh))
    check_cuda_input("k", k, q.dtype, (b, s, g, dh))
    check_cuda_input("v", v, q.dtype, (b, s, g, dh))
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the SWA kernel takes dh in {_HEAD_DIMS}; got {dh}")
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ or s >= 2 ** 31:
        raise ValueError(f"the SWA kernel takes H, B <= {_MAX_GRID_YZ} and "
                         f"S < 2^31; got H={h}, B={b}, S={s}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = (build.library().repro_swa_attention_f32 if q.dtype == torch.float32
          else build.library().repro_swa_attention_bf16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, g, dh, int(window), stream_handle(q.device))
    build.check(err, "swa_attention")
    LAUNCHES["swa_attention"] += 1
    return out
