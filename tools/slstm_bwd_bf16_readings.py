#!/usr/bin/env python3
"""The sLSTM backward kernel's bf16 distances from the fp32 backward, beside
the plain bf16 path's, on one GPU.

    PYTHONPATH=src python3 tools/slstm_bwd_bf16_readings.py

For each bf16 case of ``tests/test_torch_cuda_kernels.py::
test_slstm_bwd_kernel_matches_plain`` (its inputs, built by its own
helpers) and at chip_smoke.py's phase-2 shapes (two seeds each), every
gradient's largest error and relative L2 distance from the fp32 backward
on the same values, for the kernel (the saving forward then the backward,
through the wrapper's Function) and for the plain path (``ref.
slstm_scan_bwd_ref`` in bf16), and their ratio kernel / plain.  The last
line gives the largest ratio of each measure and where it fell.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]

import torch  # noqa: E402


def _distances(got, plain, exact):
    """Per gradient: (largest kernel, largest plain, L2 kernel, L2 plain)."""
    out = []
    for k, p, e in zip(got, plain, exact):
        k, p, e = k.double(), p.double(), e.double()
        norm = e.norm().clamp(min=1e-300)
        out.append((float((k - e).abs().max()), float((p - e).abs().max()),
                    float((k - e).norm() / norm), float((p - e).norm() / norm)))
    return out


def _ratio(kernel: float, plain: float) -> float:
    """kernel / plain; 1 where both are 0, inf where only plain is."""
    if plain > 0:
        return kernel / plain
    return 1.0 if kernel == 0 else float("inf")


def main() -> int:
    if not torch.cuda.is_available():
        print("slstm_bwd_bf16_readings: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    import test_torch_cuda_kernels as K
    from repro_torch.kernels.slstm import ops as tslstm
    from repro_torch.kernels.slstm.ref import slstm_scan_bwd_ref

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for dh in tslstm.SUPPORTED_DH:  # the test's bf16 cases, its seeds
        for b, s in [(1, 1), (2, 40), (4, tslstm.STAGES * tslstm.TILE + 1), (2, 300)]:
            h = 3
            (pre, r, bias), st = K._slstm_inputs(cuda, b, s, h, dh, torch.bfloat16, dh + b + s)
            g = torch.Generator(device=cuda).manual_seed(s)
            dhs = torch.randn((b, s, h, dh), generator=g, device=cuda)
            dfinal = tuple(0.3 * torch.randn((b, h, dh), generator=g, device=cuda)
                           for _ in range(4))
            cases.append((f"test ({b}, {s}, {h}, {dh})", (pre, r, bias), st, dhs, dfinal))
    for shape in (C.SLSTM_BWD_SHAPE, C.SLSTM_SHAPE):  # phase 2's shapes, two seeds each
        for seed in (0, 1):
            gen = torch.Generator(device=cuda).manual_seed(seed)
            pre, r, bias, st = C._slstm_inputs(torch, cuda, gen, shape, torch.bfloat16)
            dhs = torch.randn((shape[0], shape[1], *shape[2:]), generator=gen, device=cuda)
            zeros = tuple(torch.zeros_like(st[0]) for _ in range(4))
            cases.append((f"phase-2 shape {shape} seed {seed}", (pre, r, bias), st, dhs, zeros))
    worst = {"largest": (0.0, ""), "L2": (0.0, "")}
    for label, ins, st, dhs, dfinal in cases:
        _, _, got = K._slstm_grads(ins, st, dhs, dfinal)
        plain = K._flat(slstm_scan_bwd_ref(*ins, st, dhs, dfinal))
        exact = K._flat(slstm_scan_bwd_ref(*(t.float() for t in ins), st, dhs, dfinal))
        parts = []
        for name, (mk, mp, lk, lp) in zip(K.SLSTM_BWD_NAMES, _distances(got, plain, exact)):
            rm, rl = _ratio(mk, mp), _ratio(lk, lp)
            parts.append(f"{name} largest {mk:.3g} / {mp:.3g} = {rm:.3f}, "
                         f"L2 {lk:.3g} / {lp:.3g} = {rl:.3f}")
            for key, ratio in (("largest", rm), ("L2", rl)):
                if ratio > worst[key][0]:
                    worst[key] = (ratio, f"{name} at {label}")
        print(f"{label} bf16, kernel / plain from the fp32 backward: " + "; ".join(parts),
              flush=True)
        del got, plain, exact
    print(f"largest ratio: largest error {worst['largest'][0]:.3f} ({worst['largest'][1]}); "
          f"L2 {worst['L2'][0]:.3f} ({worst['L2'][1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
