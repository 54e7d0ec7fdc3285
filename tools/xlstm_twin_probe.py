#!/usr/bin/env python3
"""Why the xlstm smoke twin's mLSTM pre-norm bias parts between the card and
the CPU in bf16, on one GPU.

    PYTHONPATH=src python3 tools/xlstm_twin_probe.py

At the weights and first batch of chip_smoke.py's phase-20 twin
(xlstm-125m's smoke configuration, TRAIN_M replicas, S=64), each replica's
loss gradient five ways: bf16 on the card (through the sLSTM kernels), bf16
on the card with the sLSTM kernels' plain versions, bf16 on the CPU, and
fp32 (the same weights widened) on the card and on the CPU.  For each leaf
it prints the relative L2 distance of each from the CPU's fp32 gradient;
for the two pre-norm biases, whose gradient is a sum over tokens of the
norm output's gradient (read by a hook), that sum's cancellation: per
channel, the sum over tokens of |a token's gradient| over |the sum|.
Then the twin itself (``chip_smoke._train_twin``), as phase 20 runs it.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

BIASES = ("stages/0/0_mlstm/norm1/bias", "stages/0/1_slstm/norm1/bias")


def _grads(cfg, params, batch, i: int, device):
    """Replica ``i``'s loss gradient on ``device`` (fp64 copies on the CPU,
    in leaf order) and the gradients of the blocks' norm outputs in call
    order (the mLSTM block's, then the sLSTM block's)."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    mine = tree_map(lambda t: t[i].detach().to(device, copy=True).requires_grad_(), params)
    outs, norm = [], blocks.apply_norm

    def hooked(*args, **kw):
        y = norm(*args, **kw)
        if y.requires_grad:
            slot = len(outs)
            outs.append(None)
            y.register_hook(lambda g: outs.__setitem__(slot, g.detach().double().cpu()))
        return y

    blocks.apply_norm = hooked
    try:
        with torch.enable_grad():
            loss, _ = M.loss_fn(cfg, mine, {k: v[i].to(device) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tree_leaves(mine))
    finally:
        blocks.apply_norm = norm
    return [g.detach().double().cpu() for g in grads], outs


def _l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_twin_probe: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config("xlstm-125m"), dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, _ = T.init_state(cfg, C.TRAIN_M, C.TRAIN_SEED, "cpu")
    params32 = tree_map(lambda t: t.float(), params)
    batch = next(T._batches(cfg, C.TRAIN_M, C.TRAIN_BATCH, 64, C.TRAIN_SEED, "cpu"))
    paths = C._leaf_paths(params)
    held = [paths.index(p) for p in BIASES]
    legs = ("card bf16", "plain card bf16", "cpu bf16", "card fp32")
    dist = {leg: [[] for _ in paths] for leg in legs}
    for i in range(C.TRAIN_M):
        ref, ref_outs = _grads(cfg32, params32, batch, i, "cpu")
        for j, o in zip(held, ref_outs):  # the hook reads the bias's per-token terms
            check = _l2(o.sum((0, 1)), ref[j])
            summed, spread = o.sum((0, 1)).abs(), o.abs().sum((0, 1))
            ratio = spread / summed.clamp(min=1e-300)
            print(f"replica {i} {paths[j]}: fp32 gradient = the sum over {o.shape[0]} x "
                  f"{o.shape[1]} tokens of the norm output's (relative L2 {check:.2e}); "
                  f"cancellation sum|g_t| / |sum g_t| per channel: median "
                  f"{float(ratio.median()):.1f}, largest {float(ratio.max()):.1f}, over the "
                  f"leaf (L2 norms) {float(spread.norm() / summed.norm()):.1f}", flush=True)
        for leg, (c, p, device, ctx) in {
                "card bf16": (cfg, params, dev, contextlib.nullcontext),
                "plain card bf16": (cfg, params, dev, C._plain_slstm),
                "cpu bf16": (cfg, params, "cpu", contextlib.nullcontext),
                "card fp32": (cfg32, params32, dev, contextlib.nullcontext)}.items():
            with ctx():
                got, _ = _grads(c, p, batch, i, device)
            for j, (g, r) in enumerate(zip(got, ref)):
                dist[leg][j].append(_l2(g, r))
    every = {leg: sorted(x for d in dist[leg] for x in d) for leg in legs}
    print("every leaf and replica, relative L2 from the CPU's fp32 gradient (median, largest): "
          + "; ".join(f"{leg} {v[len(v) // 2]:.2e}, {v[-1]:.2e}" for leg, v in every.items()))
    others = [j for j in range(len(paths)) if j not in held]
    for j in held + sorted(others, key=lambda j: -max(dist["cpu bf16"][j]))[:4]:
        print(f"{paths[j]} (leaf {j}): each replica's gradient, relative L2 from the CPU's fp32 "
              "one: " + "; ".join(f"{leg} " + ", ".join(f"{x:.2e}" for x in dist[leg][j])
                                  for leg in legs), flush=True)
    C._train_twin(torch, dev, "xlstm-125m", plain_card=C._plain_slstm, held=C.TWIN_HELD_LEAF)
    return 0


if __name__ == "__main__":
    sys.exit(main())
