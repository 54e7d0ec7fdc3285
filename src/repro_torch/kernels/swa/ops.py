"""Wrapper of the sliding-window attention kernels in the model's
(B, S, H, dh) layout.

Routes by dtype alone.  A bf16 CUDA tensor launches the tensor-core kernel
(``csrc/swa_attention_tc.cu``: wgmma + TMA, B * S < 2^31); an fp32 CUDA
tensor launches the split-TF32 tensor-core kernel
(``csrc/swa_attention_tf32.cu``: wgmma + cp.async).  Either takes
contiguous, 16-byte aligned inputs with dh in {32, 64, 128} and raises on
what it cannot take; no route falls back to another kernel or to the plain
version.  A CPU tensor runs the plain version in ``ref.py``.  The kernels
read the (B, S, ., dh) rows in place, so the card path needs none of the
transposes the plain version takes.  The SIMT kernel of
``csrc/swa_attention.cu``, the earlier design of both paths, stays in the
library for comparison; no route reaches it."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_cuda_input, on_cpu, stream_handle
from repro_torch.kernels.swa.ref import swa_ref

# launches of each CUDA kernel, counted where it is launched and nowhere
# else: "swa_attention_tc" the bf16 tensor-core kernel, "swa_attention_tf32"
# the fp32 split-TF32 one
LAUNCHES = {"swa_attention_tc": 0, "swa_attention_tf32": 0}

_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_YZ = 65535
_ALIGN = 16  # bytes: a tensor map's base address (bf16), 16-byte copies (fp32)


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
        raise TypeError(f"the SWA kernels take float32 or bfloat16; got {q.dtype}")
    check_cuda_input("q", q, q.dtype, (b, s, h, dh))
    check_cuda_input("k", k, q.dtype, (b, s, g, dh))
    check_cuda_input("v", v, q.dtype, (b, s, g, dh))
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the SWA kernels take dh in {_HEAD_DIMS}; got {dh}")
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ or s >= 2 ** 31:
        raise ValueError(f"the SWA kernels take H, B <= {_MAX_GRID_YZ} and "
                         f"S < 2^31; got H={h}, B={b}, S={s}")
    tc = q.dtype == torch.bfloat16
    if tc and b * s >= 2 ** 31:
        raise ValueError(f"the tensor-core SWA kernel takes B * S < 2^31; "
                         f"got {b * s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"the SWA kernels take {name} at a {_ALIGN}-byte "
                             f"aligned address")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.library()
    fn = lib.repro_swa_attention_tc_bf16 if tc else lib.repro_swa_attention_tf32_f32
    name = "swa_attention_tc" if tc else "swa_attention_tf32"
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, g, dh, int(window), stream_handle(q.device))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
