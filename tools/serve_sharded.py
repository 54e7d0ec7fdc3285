"""Serve a dense attention config over a (data, model) device mesh: one
prefill and a batch of requests decoded token by token, each rank holding
its blocks of the weights (``models/sharding.py``, ``serve`` mode) and of
the KV caches, the batch split over ``data``.

Launched by ``torchrun``, one rank a card (NCCL), e.g. qwen2-72b at its
full depth over four cards:

    PYTHONPATH=src torchrun --nproc-per-node 4 tools/serve_sharded.py \\
        --arch qwen2-72b --model 4

or as one process on one card (no ``torchrun``: a mesh of one rank).
``--device cpu`` runs gloo ranks on the CPU (``--smoke`` and a small
``--seq`` there).  Prints, on rank 0: the prefill's ms and tokens/s (the
second of two prefills, host clock to a sync of every rank), the decode's
ms a step and tokens/s, each card's peak memory, and the decode's logits
against ``forward``'s on the same tokens, which must lie within relative
L2 5e-2 (the serving gate).  ``--save FILE`` writes the prefill logits at
every ``SAVE_STRIDE``-th position and the decode logits; ``--against FILE``
holds this run's against a saved run's within atol = rtol ``--tol``.  On
the card one more prefill and one more decode step run under
``torch.profiler``: the NCCL kernels' share of rank 0's busy time, their
ms and launches a layer.  The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.synthetic import token_dataset  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from nccl_share import profile_share  # noqa: E402

SAVE_STRIDE = 128  # prefill positions kept by --save
DECODE_REL_L2 = 5e-2


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--dtype", default="", help="float32 or bfloat16 (default: the config's)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192, help="prefill tokens")
    ap.add_argument("--prefill-batch", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4, help="decode requests")
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    ap.add_argument("--tol", type=float, default=1e-4)
    return ap.parse_args(argv)


def config(arch: str, layers: int = 0, dtype: str = "", smoke: bool = False):
    """``arch``'s config (its smoke config with ``smoke``), its depth cut to
    ``layers`` attention layers and its dtype set where given."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    kinds = {bt for cycle, _ in cfg.layer_plan for bt in cycle}
    if kinds - {"attn", "attn_g"}:
        raise ValueError(f"{arch} is not a dense attention config ({sorted(kinds)})")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, layer_plan=((("attn",), layers),))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def _rows(n: int, mesh) -> slice:
    """This rank's rows of an n-row batch (split over ``data``)."""
    if mesh is None:
        return slice(0, n)
    d, nd = mesh.coords["data"], mesh.shape["data"]
    if n % nd:
        raise ValueError(f"a batch of {n} does not split over data = {nd}")
    return slice(d * n // nd, (d + 1) * n // nd)


def run(args, mesh, dev, log=print) -> dict:
    """The prefill and the decode on this rank; returns the readings."""
    cfg = config(args.arch, args.layers, args.dtype, args.smoke)
    t0 = time.perf_counter()
    shard = None if mesh is None else S.layer_slicer(mesh, "serve")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev,
                           shard=shard)
    _sync(dev)
    local_gb = sum(t.numel() * t.element_size() for t in M.tree_leaves(params)) / 1e9
    log(f"{cfg.name} {cfg.n_layers} layers {cfg.dtype}: {cfg.n_params} parameters, "
        f"{local_gb:.2f} GB a rank, drawn in {time.perf_counter() - t0:.1f} s")

    prefill = steps.make_prefill_step(cfg, mesh)
    tokens = torch.as_tensor(token_dataset(args.prefill_batch * args.seq, vocab=cfg.vocab,
                                           seed=args.seed), dtype=torch.int64,
                             device=dev).reshape(args.prefill_batch, args.seq)
    tokens = tokens[_rows(args.prefill_batch, mesh)]
    logits = prefill(params, {"tokens": tokens})  # warm-up
    finite = bool(torch.isfinite(logits).all())
    saved = {"prefill": logits[:, ::SAVE_STRIDE].float().cpu().numpy()}
    del logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
    del logits

    # decode: each request's prompt replayed into a fresh cache, then greedy
    serve = steps.make_serve_step(cfg, mesh)
    rows = _rows(args.batch, mesh)
    n_loc = rows.stop - rows.start
    prompts = token_dataset(args.batch * args.prompt, vocab=cfg.vocab, seed=args.seed + 1)
    fed = torch.zeros((n_loc, args.prompt + args.new), dtype=torch.int64, device=dev)
    fed[:, :args.prompt] = torch.as_tensor(prompts.reshape(args.batch, args.prompt)[rows])
    cache = M.init_cache(cfg, args.batch, args.cache_len, dev, mesh=mesh)
    dec = []
    for t in range(args.prompt):
        lg, cache = serve(params, cache, fed[:, t], t)
        dec.append(lg)
    _sync(dev)
    t1 = time.perf_counter()
    for t in range(args.prompt, args.prompt + args.new):
        fed[:, t] = dec[-1].argmax(-1)
        lg, cache = serve(params, cache, fed[:, t], t)
        dec.append(lg)
    _sync(dev)
    step_ms = (time.perf_counter() - t1) * 1e3 / args.new
    share = {}
    if dev.type == "cuda":  # the collectives' share of one prefill and one decode step
        t = args.prompt + args.new
        share = {"prefill": profile_share(lambda: prefill(params, {"tokens": tokens})),
                 "decode": profile_share(lambda: serve(params, cache, fed[:, t - 1], t))}
        for name, sh in share.items():
            log(f"{cfg.name} profile, one {name}{' step' if name == 'decode' else ''} on "
                f"rank 0: busy {sh['busy_ms']:.3f} ms (union), NCCL kernels "
                f"{sh['nccl_ms']:.3f} ms ({sh['nccl_share']:.4f} of busy), "
                f"{sh['nccl_kernels']} NCCL launches: {sh['nccl_ms'] / cfg.n_layers:.4f} ms "
                f"and {sh['nccl_kernels'] / cfg.n_layers:.2f} launches a layer")
    dec = torch.stack(dec, 1).float()
    fwd = prefill(params, {"tokens": fed}).float()
    rel = float(((dec - fwd).norm(dim=(1, 2)) / fwd.norm(dim=(1, 2))).max())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
    saved["decode"] = dec.cpu().numpy()
    return {"prefill_ms": prefill_ms, "prefill_tokens_per_s": args.prefill_batch * args.seq
            / prefill_ms * 1e3, "decode_ms_per_step": step_ms,
            "decode_tokens_per_s": args.batch / step_ms * 1e3, "prefill_peak_gib": prefill_peak,
            "peak_gib": peak, "decode_vs_forward_rel_l2": rel, "argmax_agreement": agree,
            "finite": finite and bool(torch.isfinite(dec).all()), "saved": saved,
            "local_gb": local_gb, "profile": share}


def main(argv=None) -> int:
    args = _parse(argv)
    dev = torch.device(args.device)
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_host_mesh(data=args.data, model=args.model)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    elif args.data * args.model != 1:
        raise ValueError(f"data {args.data} x model {args.model} needs that many ranks: "
                         f"launch them under torchrun")
    rank = 0 if mesh is None else mesh.rank
    world = 1 if mesh is None else mesh.size

    def log(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    try:
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        out = run(args, mesh, dev, log)
        # every rank's readings on rank 0, in rank order
        peaks = [out["peak_gib"]]
        if mesh is not None:
            peaks = [float(x) for x in mesh.axis(mesh.axis_names).gather(
                torch.tensor([out["peak_gib"]], dtype=torch.float64, device=dev))]
        saved = out.pop("saved")
        ok = out["finite"] and out["decode_vs_forward_rel_l2"] <= DECODE_REL_L2
        text = ""
        if args.against and rank == 0:
            want = np.load(args.against)
            errs = {k: float(np.abs(saved[k] - want[k]).max()) for k in ("prefill", "decode")}
            close = all(np.allclose(saved[k], want[k], atol=args.tol, rtol=args.tol)
                        for k in errs)
            ok = ok and close
            text = (f"; against {args.against}: max abs err {errs} (atol = rtol "
                    f"{args.tol}): {'within' if close else 'OUTSIDE'}")
        if args.save and rank == 0:
            np.savez(args.save, **saved)
        log(f"{args.arch} over data {args.data} x model {args.model} ({world} ranks): prefill "
            f"B={args.prefill_batch} S={args.seq} {out['prefill_ms']:.1f} ms "
            f"({out['prefill_tokens_per_s']:.0f} tokens/s), peak {out['prefill_peak_gib']:.2f} "
            f"GiB on rank 0; decode B={args.batch} {out['decode_ms_per_step']:.2f} ms/step "
            f"({out['decode_tokens_per_s']:.1f} tokens/s); decode vs forward relative L2 "
            f"{out['decode_vs_forward_rel_l2']:.4g} (tol {DECODE_REL_L2}), argmax agreement "
            f"{out['argmax_agreement']:.3f}; peak memory a card (GiB) "
            f"{[round(p, 2) for p in peaks]}{text}")
        log(json.dumps({**out, "peak_gib_per_card": peaks, "ok": ok, "arch": args.arch,
                        "layers": args.layers, "dtype": args.dtype, "data": args.data,
                        "model": args.model}))
        return 0 if ok else 1
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
