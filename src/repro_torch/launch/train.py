"""End-to-end decentralized training entry point (port of
``repro/launch/train.py``).

Runs EF-HC training of an architecture (smoke or full config) with m
model replicas on one card, e.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-15b \\
      --smoke --data 4 --steps 3 --device cpu

The flags and the printed lines are the reference's; with a MoE the step
line also carries ``loss_fn``'s ``ce`` and ``aux`` terms.  ``--data`` is the
number of replicas (FL devices) on the card; the reference's mesh axes
across cards (``--model > 1``, ``--devices``) are ROADMAP Queue 1 item
19 and raise.  ``--device`` defaults to ``cuda`` and raises without a
card.  On the card every architecture whose weights it holds trains
through the kernels: hymba's Mamba branches through the selective scan's
backward kernel, xlstm-125m's sLSTM blocks through the sLSTM recurrence's
saving forward and backward kernels.  Each replica trains on its own
contiguous shard of a synthetic token stream (non-iid); the run logs
loss, trigger rate and the EF-HC
consensus distance, and checkpoints through
``repro_torch.checkpoint.msgpack_ckpt`` (the reference's format, bf16
leaves included).  Unlike the reference, whose resume draws the batches
from the start of the stream again, a resumed run draws the batches the
uninterrupted run would have drawn, so it continues that run bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import msgpack_ckpt as checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.data.loader import lm_batches
from repro_torch.data.synthetic import token_dataset
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_leaves, tree_map

STREAM_TOKENS = 200_000  # the reference's synthetic stream length
CONSENSUS_COLS = 1 << 24  # columns a consensus-error pass takes at once


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--devices", type=int, default=0,
                    help="host device count (the reference's; not on one card)")
    ap.add_argument("--data", type=int, default=1, help="model replicas (FL devices)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--fl_m", type=int, default=0, help="override cfg.fl_m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mix", choices=["dense", "neighbor"], default="dense")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """A finished run: the state after its last step (on its device), one
    record per step (``k``, ``loss``, ``ce``, ``aux``, ``trigger_rate``,
    ``alpha``, ``v``, host values), each step's wall time (ms, after a device sync) and the
    tokens a step takes."""
    setup: steps_mod.TrainSetup
    params: Any
    w_hat: Any
    step: int
    records: list[dict]
    step_ms: list[float]
    tokens_per_step: int


def consensus_err(params) -> float:
    """sum over the leaves of ||w_i - mean_i w||^2 in fp32 (the reference
    concatenates every leaf first; here each leaf goes in column slabs)."""
    tot = 0.0
    for leaf in tree_leaves(params):
        flat = leaf.reshape(leaf.shape[0], -1)
        for c in range(0, flat.shape[1], CONSENSUS_COLS):
            x = flat[:, c:c + CONSENSUS_COLS].float()
            tot += float(((x - x.mean(0)) ** 2).sum())
    return tot


def init_state(cfg: ArchConfig, m: int, seed: int, device) -> tuple[Any, Any]:
    """m copies of one replica's seeded random weights, and w_hat = them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = M.init_params(cfg, gen, device)
    # the reference's jnp.stack([leaf] * m)
    params = tree_map(lambda t: t.unsqueeze(0).expand((m, *t.shape)).clone(), base)
    del base
    return params, tree_map(torch.clone, params)


def _batches(cfg: ArchConfig, m: int, batch: int, seq: int, seed: int, device):
    """The reference's batch stream: each replica's ``lm_batches`` over its
    contiguous shard of ``token_dataset``, stacked (m, batch // m, seq);
    with a modality frontend, fp32 zeros for its embeddings (m, batch // m,
    T, dim) (T the vision patches, or seq audio frames) and a ``loss_mask``
    of ones."""
    stream = token_dataset(STREAM_TOKENS, vocab=cfg.vocab, seed=seed)
    shards = np.array_split(stream, m)
    iters = [lm_batches(s, batch // m, seq, seed=seed + i) for i, s in enumerate(shards)]
    while True:
        per = [next(it) for it in iters]
        out = {k: torch.as_tensor(np.stack([p[k] for p in per]), dtype=torch.int64,
                                  device=device) for k in per[0]}
        if cfg.frontend is not None:
            b, s = out["tokens"].shape[1:]
            nt = cfg.frontend.tokens if cfg.frontend.kind == "vision" else s
            out["frontend"] = torch.zeros((m, b, nt, cfg.frontend.dim), dtype=torch.float32,
                                          device=device)
            out["loss_mask"] = torch.ones((m, b, s), dtype=torch.float32, device=device)
        yield out


def _restore(ckpt: str, device) -> tuple[Any, Any, int]:
    """The latest checkpoint's (params, w_hat, step), leaves on ``device``
    in the dtypes they were saved in."""
    state = checkpoint.restore(ckpt)

    def leaf(a):
        return (a if isinstance(a, torch.Tensor) else tensor_from_numpy(a)).to(device)

    return (tree_map(leaf, state["params"]), tree_map(leaf, state["w_hat"]),
            int(state["step"]))


def train(cfg: ArchConfig, *, m: int, steps: int, batch: int = 8, seq: int = 64,
          mix: str = "dense", pods: int = 1, seed: int = 0, ckpt: str = "",
          ckpt_every: int = 50, log_every: int = 5, device="cuda",
          state: tuple[Any, Any, int] | None = None,
          log: Callable[[str], None] = print) -> TrainRun:
    """``steps`` EF-HC steps of ``cfg`` with m replicas on ``device``.

    The run starts from ``state`` (params, w_hat, step) if given (the trees
    are updated in place), else from the latest checkpoint in ``ckpt`` if
    there is one, else from ``seed``'s random weights at step 0.  With
    ``ckpt`` it saves every ``ckpt_every`` steps and at the end."""
    device = resolve_device(device)
    setup = steps_mod.make_setup(cfg, m, mix=mix, pods=pods)
    if batch % m:
        raise ValueError(f"the global batch ({batch}) must divide by the replicas ({m})")
    n_par = cfg.n_params
    if setup.mix == "neighbor":
        step_fn = steps_mod.make_neighbor_train_step(setup, n_model_params=n_par)
    else:
        step_fn = steps_mod.make_train_step(setup, n_model_params=n_par)

    if state is not None:
        params, w_hat, start = state
    elif ckpt and checkpoint.latest_step(ckpt) is not None:
        params, w_hat, start = _restore(ckpt, device)
        log(f"restored step {start} from {ckpt}")
    else:
        (params, w_hat), start = init_state(cfg, m, seed, device), 0
    batches = _batches(cfg, m, batch, seq, seed, device)
    for _ in range(start):  # the batches the run before this one took
        next(batches)

    records, step_ms = [], []
    for k in range(start, start + steps):
        b = next(batches)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, w_hat, metrics = step_fn(params, w_hat, b, k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rec = {"k": k, **{name: float(metrics[name])
                          for name in ("loss", "ce", "aux", "trigger_rate", "alpha")},
               "v": metrics["v"].tolist()}
        records.append(rec)
        if k % log_every == 0 or k == start + steps - 1:
            moe = f" ce {rec['ce']:.4f} aux {rec['aux']:.4f}" if cfg.moe is not None else ""
            log(f"step {k:5d} loss {rec['loss']:.4f} "
                f"trigger_rate {rec['trigger_rate']:.2f} "
                f"consensus_err {consensus_err(params):.3e} alpha {rec['alpha']:.4f}{moe}")
        if ckpt and (k + 1) % ckpt_every == 0:
            checkpoint.save(ckpt, k + 1, {"params": params, "w_hat": w_hat, "step": k + 1})
    if ckpt:
        checkpoint.save(ckpt, start + steps,
                        {"params": params, "w_hat": w_hat, "step": start + steps})
    log("training done")
    return TrainRun(setup=setup, params=params, w_hat=w_hat, step=start + steps,
                    records=records, step_ms=step_ms, tokens_per_step=batch * seq)


def main(argv=None) -> int:
    args = _parse(argv)
    if args.devices or args.model > 1:
        raise NotImplementedError(
            "--devices and --model > 1 lay the replicas over several devices: "
            "ROADMAP Queue 1 item 19 (sharding of the architecture models)")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.fl_m:
        cfg = dataclasses.replace(cfg, fl_m=args.fl_m)
    train(cfg, m=args.data, steps=args.steps, batch=args.batch, seq=args.seq,
          mix=args.mix, seed=args.seed, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
          log_every=args.log_every, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
