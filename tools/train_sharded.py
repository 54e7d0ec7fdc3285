"""EF-HC training of a dense attention config over a (data, model) device
mesh, with the checks a multi-card run needs: a firing replica (P != I),
launch counts of the trigger and mixing kernels, replicated leaves equal
across each model group, a profiled step's collective share, a resume from
the per-rank checkpoints, and optionally a one-card twin.

Launched by ``torchrun``, one rank a card (NCCL), e.g. starcoder2-15b at
its full depth over four cards (2 replicas, each split over 2 cards):

    PYTHONPATH=src torchrun --nproc-per-node 4 tools/train_sharded.py \\
        --arch starcoder2-15b --data 2 --model 2

``--device cpu`` runs gloo ranks on the CPU (``--smoke``, small ``--seq``).
The run: ``--dense`` dense steps through ``launch.train.train`` with a
checkpoint at their end (a directory a rank, named by its mesh
coordinates), then ``--neighbor`` neighbor steps; replica
``FIRE_REPLICA``'s ``w_hat`` starts as another seed's weights, so that it
fires at step 0 and P != I.  Then: each leaf whole over ``model`` compared
across its model group; one dense step under ``torch.profiler`` (the NCCL
kernels' share of the device's busy time, the union of its activities'
intervals); the neighbor steps again from the checkpoint, every leaf's
SHA-256 and every metric equal to the uninterrupted run's (a disk too
small for the checkpoints fails the run).  With
``--twin``, rank 0 then runs the same steps with all replicas on its own
card (``make_setup(cfg, m)``) and holds v equal and the floats within
rtol 2e-4 / atol 2e-5 (for fp32 configs).  The last line on rank 0 is a
JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.mixing import ops as mixing_ops  # noqa: E402
from repro_torch.kernels.trigger import ops as trigger_ops  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from nccl_share import profile_share  # noqa: E402

FIRE_REPLICA = 1
TWIN_RTOL, TWIN_ATOL = 2e-4, 2e-5


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-15b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--dtype", default="")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dense", type=int, default=3)
    ap.add_argument("--neighbor", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_sharded_ckpt"))
    ap.add_argument("--twin", action="store_true", help="rank 0 reruns on one card")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _counts() -> dict[str, int]:
    return {k: n for d in (trigger_ops.LAUNCHES, mixing_ops.LAUNCHES) for k, n in d.items() if n}


def _reset() -> None:
    for d in (trigger_ops.LAUNCHES, mixing_ops.LAUNCHES):
        for k in d:
            d[k] = 0


def _digests(tree) -> list[str]:
    return [hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for t in tree_leaves(tree)]


def _state(cfg, setup, seed: int, dev):
    """The replicas' seeded weights; replica FIRE_REPLICA's w_hat another
    seed's (its own blocks on a mesh)."""
    params, w_hat = T.init_state(cfg, setup.m, seed, dev, setup)
    if FIRE_REPLICA in range(setup.own.start, setup.own.stop):
        shard = None if setup.mesh is None else S.layer_slicer(setup.mesh, setup.mode)
        other = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 1), dev,
                              shard=shard)
        row = FIRE_REPLICA - setup.own.start
        tree_map(lambda h, o: h[row].copy_(o), w_hat, other)
        del other
    return params, w_hat


def _legs(cfg, args, dev, mesh, log, ckpt: str = ""):
    """The dense leg (checkpointed at its end) and the neighbor leg."""
    kw = dict(batch=args.batch, seq=args.seq, seed=args.seed, device=dev, log=log)
    # without a mesh: the mesh's replicas, every one on this card
    setup = steps_mod.make_setup(cfg, mesh if mesh is not None else args.data)
    state = _state(cfg, setup, args.seed, dev)
    first = T.train(cfg, m=None if mesh is not None else setup.m, mesh=mesh,
                    steps=args.dense, ckpt=ckpt, ckpt_every=args.dense + args.neighbor + 1,
                    state=(*state, 0), **kw)
    run = T.train(cfg, m=None if mesh is not None else setup.m, mesh=mesh,
                  steps=args.neighbor, mix="neighbor",
                  state=(first.params, first.w_hat, first.step), **kw)
    return first, run, kw


def main(argv=None) -> int:
    args = _parse(argv)
    dev = torch.device(args.device)
    import torch.distributed as dist

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    mesh = make_host_mesh(data=args.data, model=args.model)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = mesh.rank

    def log(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    try:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                      layer_plan=((("attn",), args.layers),))
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        cfg = dataclasses.replace(cfg, fl_m=args.data)
        ckpt = args.ckpt
        # every rank's params and w_hat, whole: the checkpoints' bytes
        need = 2 * args.data * cfg.n_params * (2 if cfg.dtype == "bfloat16" else 4)
        room = [None]
        if rank == 0:
            shutil.rmtree(ckpt, ignore_errors=True)
            os.makedirs(ckpt, exist_ok=True)
            room = [shutil.disk_usage(ckpt).free]
        dist.broadcast_object_list(room, src=0)
        resume = room[0] > 1.05 * need
        log(f"{ckpt}: {room[0] / 1e9:.1f} GB free, the checkpoints need "
            f"{need / 1e9:.1f} GB: " + ("the resume runs" if resume else
                                        "TOO LITTLE ROOM: no checkpoint, the run fails"))
        if not resume:
            ckpt = ""
        label = (f"train {cfg.name} {cfg.n_layers}L {cfg.dtype} data {args.data} x model "
                 f"{args.model} B={args.batch} S={args.seq}")
        _reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        first, run, kw = _legs(cfg, args, dev, mesh, lambda s: log(f"{label}: {s}"), ckpt)
        wall = time.perf_counter() - t0
        counts = _counts()
        setup = run.setup
        n_leaves = len(tree_leaves(run.params))
        specs = S.spec_leaves(S.param_specs(cfg, M.init_params(cfg, device="meta"), mesh,
                                            setup.mode))
        counted = sum(setup.counted)
        steps = args.dense + args.neighbor
        suffix = "_bf16" if cfg.dtype == "bfloat16" else ""
        slabs = sum(len(mixing_ops.slabs(t.reshape(t.shape[0], -1)))
                    for t in tree_leaves(run.params))
        want = {f"trigger_sq{suffix}": counted * steps, f"mix{suffix}": slabs * args.dense,
                f"mix_sparse{suffix}": slabs * args.neighbor}
        ok = counts == want or dev.type != "cuda"  # the CPU's plain versions count none
        records = first.records + run.records
        fired = sum(sum(r["v"]) for r in records)
        ok = ok and fired > 0 and all(np.isfinite(r["loss"]) for r in records)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
        peaks = [float(x) for x in mesh.axis(mesh.axis_names).gather(
            torch.tensor([peak], dtype=torch.float64, device=dev))]
        warm = first.step_ms[1:] + run.step_ms
        step_ms = statistics.median(warm)
        log(f"{label}: {cfg.n_params} parameters a replica, {n_leaves} leaves; step ms "
            f"{[round(x, 1) for x in first.step_ms + run.step_ms]} (the first warms up); "
            f"median {step_ms:.1f} ms/step, {run.tokens_per_step / step_ms * 1e3:.0f} tokens/s "
            f"({run.tokens_per_step} tokens a step); peak memory a card (GiB) "
            f"{[round(p, 2) for p in peaks]}; rank 0 launches {counts} (want {want}); v a step "
            f"{[r['v'] for r in records]}; {wall:.1f} s for init, {steps} steps and the "
            f"checkpoint")

        # leaves whole over model: one value in each model group
        same = 0
        whole = [S.whole_over_model(s) for s in specs]
        for tree in (run.params, run.w_hat):
            for leaf, w in zip(tree_leaves(tree), whole):
                if w:
                    same += all(torch.equal(p, leaf) for p in setup.model.gather(leaf))
        n_whole = 2 * sum(whole)
        ok = ok and same == n_whole
        log(f"{label}: {same} of the {n_whole} params / w_hat leaves whole over model "
            f"bit-identical across each model group")

        # the state the resume must reach (before the profiled step moves it)
        want_digests = (_digests(run.params), _digests(run.w_hat))
        want_records = run.records

        # one dense step under the profiler
        share = {}
        if dev.type == "cuda":
            step = steps_mod.make_train_step(dataclasses.replace(setup, mix="dense"),
                                             n_model_params=cfg.n_params)
            b = next(T._batches(cfg, setup.m, args.batch, args.seq, args.seed, dev))
            b = {k: v[setup.own] for k, v in b.items()}
            share = profile_share(lambda: step(run.params, run.w_hat, b, run.step))
            log(f"{label} profile: one dense step, {share['activities']} device activities, "
                f"busy {share['busy_ms']:.1f} ms (union), NCCL kernels {share['nccl_ms']:.1f} "
                f"ms ({share['nccl_kernels']} launches): {share['nccl_share']:.4f} of busy on "
                f"rank 0")

        # the resume: the neighbor leg again from the checkpoint, bit-equal
        del first, run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        agree = []  # no resume fails the run
        ok = ok and resume
        if resume:
            t0 = time.perf_counter()
            restored = T._restore(T.ckpt_dir(ckpt, setup), dev)
            resumed = T.train(cfg, m=None, mesh=mesh, steps=args.neighbor, mix="neighbor",
                              state=restored, **kw)
            del restored
            same_state = (_digests(resumed.params), _digests(resumed.w_hat)) == want_digests
            same_records = resumed.records == want_records
            agree = [int(x) for x in mesh.axis(mesh.axis_names).gather(
                torch.tensor([int(same_state and same_records)], device=dev))]
            ok = ok and all(agree)
            ckpt_gb = sum(f.stat().st_size for f in Path(ckpt).rglob("step_*.msgpack")) / 1e9
            log(f"{label}: resumed from the step-{args.dense} checkpoints ({ckpt_gb:.2f} GB "
                f"in {ckpt}), {args.neighbor} neighbor steps bit-equal to the uninterrupted run "
                f"on ranks {agree} (1 = every leaf's SHA-256 and every metric); resume leg "
                f"{time.perf_counter() - t0:.1f} s")
            del resumed
        dist.barrier()
        if rank == 0:
            shutil.rmtree(args.ckpt, ignore_errors=True)

        twin = {}
        if args.twin:
            twin = _twin(cfg, args, dev, mesh, log, label)
            ok = ok and twin["ok"]
        log(json.dumps({"ok": ok, "step_ms": step_ms, "tokens_per_s":
                        args.batch * args.seq / step_ms * 1e3, "peak_gib_per_card": peaks,
                        "launches_rank0": counts, "launches_want": want, "fired": fired,
                        "whole_equal": [same, n_whole], "resume_equal": agree, **share,
                        "twin": twin, "layers": cfg.n_layers, "dtype": cfg.dtype}))
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def _twin(cfg, args, dev, mesh, log, label) -> dict:
    """Rank 0 reruns the legs with every replica on its own card and holds
    the mesh run's v (equal), metrics and final state (rtol 2e-4 / atol
    2e-5) against it; the state is gathered first (on the host)."""
    import torch.distributed as dist

    first, run, _ = _legs(cfg, args, dev, mesh, lambda s: None)
    setup = run.setup
    specs = S.add_fl_axis(S.param_specs(cfg, M.init_params(cfg, device="meta"), mesh,
                                        setup.mode), mesh, setup.mode)
    got = {}  # the whole state, kept on rank 0's host
    for name in ("params", "w_hat"):
        got[name] = [x.cpu() if mesh.rank == 0 else None for x in
                     (S.gather_leaf(t, s, mesh) for t, s in
                      zip(tree_leaves(getattr(run, name)), S.spec_leaves(specs)))]
    mesh_records = first.records + run.records
    del first, run
    out = {"ok": True}
    if mesh.rank == 0:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        one_first, one_run, _ = _legs(cfg, args, dev, None, lambda s: None)
        one_records = one_first.records + one_run.records
        v_equal = [a["v"] for a in mesh_records] == [b["v"] for b in one_records]
        worst = 0.0
        close = True
        for name in ("params", "w_hat"):
            for g, w in zip(got[name], tree_leaves(getattr(one_run, name))):
                w = w.cpu()
                close = close and bool(torch.allclose(g, w, rtol=TWIN_RTOL, atol=TWIN_ATOL))
                worst = max(worst, float(((g - w).abs() / (TWIN_ATOL + TWIN_RTOL * w.abs()))
                                         .max()))
        loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(mesh_records, one_records))
        out = {"ok": v_equal and close, "v_equal": v_equal, "states_close": close,
               "worst_share_of_tol": worst, "max_loss_diff": loss}
        log(f"{label} twin: every replica on one card: v equal {v_equal}, params and w_hat "
            f"within rtol {TWIN_RTOL} / atol {TWIN_ATOL}: {close} (worst {worst:.3g} of the "
            f"tolerance), max |loss diff| {loss:.3g}")
    dist.barrier()
    return out


if __name__ == "__main__":
    sys.exit(main())
