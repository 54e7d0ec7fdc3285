#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` and runs, failing (non-zero exit, no final ``ok`` line) on any
error:

1. card: the GPU's name and power limit from ``nvidia-smi``;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with its time, the plain version's, one PyTorch library
   call's and the least time the card could take (``bound_ms``);
3. golden: the m=8 golden configuration of
   ``tests/test_golden_trajectory.py`` on the card under
   ``mix_impl="pallas"`` and ``"sparse_pallas"``, against
   ``tests/golden/efhc_m8_trajectory.json``;
4. paper: ``api.simulate`` at m=1024, mlp, D=50890, ``mix_impl="pallas"``
   for 20 iterations, counting ``trigger_sq`` and ``mix`` launches;
5. fleet: ``simulator.run`` at m=4096, svm, D=7850 on the rgg
   ``fleet_radius`` fabric with edge dropout, ``mix_impl="sparse_pallas"``
   for 20 iterations, counting ``mix_sparse`` launches;
6. cpu: m=64, svm, D=7850, ``mix_impl="pallas"``, T=30 on the card and on
   the CPU (plain versions), channel by channel;
7. profile: device activities, device busy time and idle share per
   iteration of the paths of phases 4 and 5, under ``torch.profiler``.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  It imports nothing of the
JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s
# and fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# golden tolerances of tests/test_golden_trajectory.py
RTOL, ATOL = 2e-4, 2e-5
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "tx_time", "util", "consensus_err")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of its bytes over the
    memory rate and its operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single calls timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev, seed: int) -> dict[str, dict]:
    import torch.nn.functional as F

    from repro_torch.core import mixing, topology, triggers
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref
    from repro_torch.kernels.trigger import ops as trigger_ops
    from repro_torch.kernels.trigger.ref import trigger_sq_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: dict[str, dict] = {}

    # trigger_sq: (1024, 50890) is the paper path's shape (mlp), (4096,
    # 7850) the svm fleet's; tolerance: fp32 sums in another order
    trig_rtol = 1e-5
    for m, n in ((4096, 7850), (1024, 50890)):
        w = torch.randn((m, n), generator=gen, device=dev)
        h = w + 0.01 * torch.randn((m, n), generator=gen, device=dev)
        got = trigger_ops.trigger_sq(w, h)
        ref = trigger_sq_ref(w, h)
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        rel_err = float(((got - ref).abs() / ref.abs()).max())
        check(rel_err <= trig_rtol,
              f"trigger_sq ({m}, {n}): max rel err {rel_err:.3g} > {trig_rtol}")
        ms = time_ms(torch, lambda: trigger_ops.trigger_sq(w, h))
        plain = time_ms(torch, lambda: trigger_sq_ref(w, h))
        lib = time_ms(torch, lambda: F.pairwise_distance(w, h, eps=0.0) ** 2)
        b_ms, b_by = bound(2 * m * n * 4 + m * 4, 3 * m * n)
        row = {"name": "trigger_sq", "shape": [m, n], "max_abs_err": abs_err,
               "max_rel_err": rel_err, "tolerance": f"rtol {trig_rtol}",
               "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib}
        print(f"kernel trigger_sq m={m} D={n}: max abs err {abs_err:.3g}, max "
              f"rel err {rel_err:.3g} (tol rtol {trig_rtol}); kernel_ms {ms:.4f}"
              f" plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
              f"{b_ms:.4f} ({b_by})")
        rows["trigger_sq"] = row  # the (1024, 50890) main-path row stays
        del w, h

    # mix: P is a real Metropolis matrix of the m=1024 rgg fabric the paper
    # path runs on; tolerance: fp32 products summed in another order
    m, n = 1024, 50890
    g = topology.make_process(m, "rgg", time_varying="edge_dropout",
                              drop=0.3, seed=0)
    adj = g.adjacency(0, dev)
    v = torch.rand(m, generator=gen, device=dev) < 0.5
    p = mixing.build_p(adj, triggers.communication_matrix(v, adj))
    w = torch.randn((m, n), generator=gen, device=dev)
    got = mixing_ops.mix(p, w)
    ref = mix_ref(p, w)
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    mix_atol = 1e-5
    check(abs_err <= mix_atol, f"mix: max abs err {abs_err:.3g} > {mix_atol}")
    ms = time_ms(torch, lambda: mixing_ops.mix(p, w))
    plain = time_ms(torch, lambda: mix_ref(p, w))
    lib = time_ms(torch, lambda: torch.matmul(p, w))
    b_ms, b_by = bound((m * m + 2 * m * n) * 4, 2 * m * m * n)
    rows["mix"] = {"name": "mix", "shape": [m, n], "max_abs_err": abs_err,
                   "tolerance": f"atol {mix_atol}", "ms": ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib}
    print(f"kernel mix m={m} D={n}: max abs err {abs_err:.3g} (tol atol "
          f"{mix_atol}); kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
          f"{lib:.4f} (torch.matmul, TF32 off) bound_ms {b_ms:.4f} ({b_by})")
    del w, p, adj, got, ref

    # mix_sparse: the real neighbor list of the large-fleet fabric; the
    # kernel rounds every product and sum as the plain version does, so the
    # two must agree bit for bit
    m, n = 4096, 7850
    g = topology.make_process(m, "rgg", radius=topology.fleet_radius(m),
                              time_varying="edge_dropout", drop=0.3, seed=0)
    nl = topology.StagedNeighbors.from_host(g.neighbors(), dev)
    adj_ell = g.adjacency_ell(0, nl)
    v = torch.rand(m, generator=gen, device=dev) < 0.5
    comm_ell = torch.logical_and(torch.logical_or(v[:, None], v[nl.idx]), adj_ell)
    p_diag, p_off = mixing.build_p_ell(nl.idx, adj_ell, comm_ell)
    w = torch.randn((m, n), generator=gen, device=dev)
    got = mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w)
    ref = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    check(abs_err == 0.0, f"mix_sparse: max abs err {abs_err:.3g}, expected 0")
    # the same P as one CSR matrix for the library call
    rows_i = torch.arange(m, device=dev)[:, None].expand_as(nl.idx)
    nz = p_off != 0
    r = torch.cat([rows_i[nz], torch.arange(m, device=dev)])
    c = torch.cat([nl.idx[nz], torch.arange(m, device=dev)])
    vals = torch.cat([p_off[nz], p_diag])
    csr = torch.sparse_coo_tensor(torch.stack([r, c]), vals, (m, m)
                                  ).coalesce().to_sparse_csr()
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w))
    plain = time_ms(torch, lambda: mix_sparse_ref(nl.idx, p_diag, p_off, w))
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w))
    nnz = int(nz.sum())
    d_max = nl.d_max
    b_ms, b_by = bound(2 * m * n * 4 + m * d_max * (8 + 4) + m * 4,
                       2 * nnz * n + m * n)
    rows["mix_sparse"] = {
        "name": "mix_sparse", "shape": [m, n], "d_max": d_max,
        "nnz_off": nnz, "max_abs_err": abs_err, "tolerance": "exact",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib}
    print(f"kernel mix_sparse m={m} D={n} d_max={d_max} nnz_off={nnz}: max abs "
          f"err {abs_err:.3g} (tol exact); kernel_ms {ms:.4f} plain_ms "
          f"{plain:.4f} library_ms {lib:.4f} (torch.sparse.mm, CSR) bound_ms "
          f"{b_ms:.4f} ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# phases 3-6: the port's paths end to end
# ---------------------------------------------------------------------------

def _compare(res, want: dict, label: str, fields_int=INT_FIELDS,
             fields_float=FLOAT_FIELDS) -> None:
    for f in fields_int:
        got = np.asarray(getattr(res, f), np.int64)
        ref = np.asarray(want[f], np.int64)
        check(got.shape == ref.shape and np.array_equal(got, ref),
              f"{label}: integer channel {f} differs")
    for f in fields_float:
        got = np.asarray(getattr(res, f), np.float64)
        ref = np.asarray(want[f], np.float64)
        ok = got.shape == ref.shape and np.allclose(got, ref, rtol=RTOL, atol=ATOL)
        check(ok, f"{label}: float channel {f} outside rtol {RTOL} / atol {ATOL}")


def phase_golden(dev) -> None:
    from repro_torch.core.topology import make_process
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.fl.simulator import SimConfig, run

    want = json.loads((ROOT / "tests" / "golden" / "efhc_m8_trajectory.json"
                       ).read_text())
    for impl in ("pallas", "sparse_pallas"):
        x, y = image_dataset(600, seed=0, dim=want["dim"])
        parts = by_labels(y, want["m"], 3)
        graph = make_process(want["m"], "rgg", time_varying="edge_dropout",
                             drop=0.3, seed=0)
        sim = SimConfig(m=want["m"], iters=want["iters"], dim=want["dim"],
                        batch=8, r=50.0, seed=0, mix_impl=impl)
        res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
                  None, eval_every=5, device=dev)
        check(np.allclose(res.bandwidths, want["bandwidths"], rtol=1e-5),
              f"golden {impl}: bandwidth draw differs")
        _compare(res, want, f"golden {impl}")
        print(f"golden m=8 {impl}: v/comm_count/deg exact, loss/tx_time/util/"
              f"consensus_err within rtol {RTOL} / atol {ATOL}")


def _finite(res, label: str) -> None:
    for f in ("loss", "acc", "tx_time", "util", "consensus_err"):
        check(bool(np.isfinite(getattr(res, f)).all()),
              f"{label}: channel {f} is not finite")


def _reset_launches() -> None:
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.trigger import ops as trigger_ops
    for counts in (trigger_ops.LAUNCHES, mixing_ops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict[str, int]:
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.trigger import ops as trigger_ops
    return {**trigger_ops.LAUNCHES, **mixing_ops.LAUNCHES}


def phase_paper(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                T: int = 20) -> dict[str, int]:
    from repro_torch import api

    spec = api.ScenarioSpec(m=m, model="mlp", dim=dim, n_train=n_train,
                            iters=T, eval_every=10, mix_impl="pallas",
                            trace="summary")
    t0 = time.perf_counter()
    _reset_launches()
    res = api.simulate(spec, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    check(launches["trigger_sq"] == T and launches["mix"] == T,
          f"paper path: expected {T} trigger_sq and {T} mix launches, got "
          f"{launches}")
    check(res.model_dim == (dim + 1) * 64 + 65 * 10,
          f"paper path: D={res.model_dim}")
    _finite(res, "paper path")
    print(f"paper path m={m} mlp D={res.model_dim} pallas T={T}: launches "
          f"{launches}; first step {res.timing['first_step_ms']:.2f} ms, "
          f"{res.timing['ms_per_step']:.3f} ms/step after it; wall {wall:.2f} s "
          f"with staging; final acc {res.acc[-1]:.4f}; trigger rate "
          f"{res.v.mean():.4f}")
    return launches, res


def phase_fleet(dev, m: int = 4096, dim: int = 784, T: int = 20
                ) -> dict[str, int]:
    from repro_torch.core.topology import fleet_radius, make_process
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.fl.simulator import SimConfig, make_eval_fn, run

    x, y = image_dataset(max(4000, 4 * m), seed=0, dim=dim)
    xt, yt = image_dataset(800, seed=1, dim=dim)
    parts = by_labels(y, m, 3)
    graph = make_process(m, "rgg", radius=fleet_radius(m),
                         time_varying="edge_dropout", drop=0.3, seed=0)
    sim = SimConfig(m=m, iters=T, dim=dim, r=50.0, trace="summary",
                    mix_impl="sparse_pallas")
    eval_fn = make_eval_fn(sim, xt, yt)
    t0 = time.perf_counter()
    _reset_launches()
    res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
              eval_fn, eval_every=20, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    check(launches["mix_sparse"] == T,
          f"fleet path: expected {T} mix_sparse launches, got {launches}")
    _finite(res, "fleet path")
    print(f"fleet path m={m} svm D={res.model_dim} sparse_pallas T={T}: "
          f"launches {launches}; first step {res.timing['first_step_ms']:.2f} "
          f"ms, {res.timing['ms_per_step']:.3f} ms/step after it; wall "
          f"{wall:.2f} s with staging; final acc {res.acc[-1]:.4f}; mean "
          f"degree {res.deg.mean():.2f}")
    return launches, res


def phase_cpu(dev, m: int = 64, dim: int = 784) -> None:
    from repro_torch import api

    spec = api.ScenarioSpec(m=m, model="svm", dim=dim, iters=30,
                            mix_impl="pallas", trace="full")
    gpu = api.simulate(spec, device=dev)
    cpu = api.simulate(spec, device="cpu")
    want = {f: getattr(cpu, f) for f in (*INT_FIELDS, *FLOAT_FIELDS, "acc")}
    _compare(gpu, want, "card vs cpu", fields_float=(*FLOAT_FIELDS, "acc"))
    check(np.array_equal(gpu.comm, cpu.comm) and np.array_equal(gpu.adj, cpu.adj),
          "card vs cpu: link matrices differ")
    print(f"card vs cpu m={m} svm pallas T=30: integer channels and link "
          f"matrices equal, float channels within rtol {RTOL} / atol {ATOL}")


def _device_activity(torch, run) -> tuple[int, float, dict[str, float]]:
    """Device activities, their summed device time (ms) and the time per
    kernel name of one ``run()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: dict[str, float] = {}
    for e in dev_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return len(dev_events), sum(per_name.values()), per_name


def phase_profile(torch, dev) -> None:
    """Per-iteration device activities, device busy time and idle share of
    the two driven paths: each runs at T=4 and T=8 under the profiler, and
    the difference over 4 iterations cancels staging and init."""
    cells = {"paper": lambda T: phase_paper(dev, T=T)[1],
             "fleet": lambda T: phase_fleet(dev, T=T)[1]}
    for name, cell in cells.items():
        cell(4)  # warm
        n4, busy4, _ = _device_activity(torch, lambda: cell(4))
        out = {}
        n8, busy8, per_name = _device_activity(
            torch, lambda: out.setdefault("res", cell(8)))
        if not n8:
            print(f"profile {name}: the profiler saw no device activity; "
                  f"busy share not measured")
            continue
        step_ms = out["res"].timing["ms_per_step"]
        launches = (n8 - n4) / 4
        busy = (busy8 - busy4) / 4
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile {name}: {launches:.1f} device activities/iteration, "
              f"device busy {busy:.3f} ms/iteration of {step_ms:.3f} ms "
              f"(idle share {1 - busy / step_ms:.3f})")
        for kname, ms in top:
            print(f"profile {name}:   {ms:9.3f} ms in the T=8 run  {kname[:90]}")


KERNEL_SOURCES = {
    "trigger_sq": ("src/repro_torch/kernels/csrc/trigger_sq.cu",
                   "src/repro/kernels/trigger/kernel.py:39"),
    "mix": ("src/repro_torch/kernels/csrc/mix.cu",
            "src/repro/kernels/mixing/kernel.py:32"),
    "mix_sparse": ("src/repro_torch/kernels/csrc/mix_sparse.cu",
                   "src/repro/kernels/mixing/kernel.py:74"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch finds no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    try:
        print(card_line())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.library()
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

        rows = phase_kernels(torch, dev, seed=0)
        phase_golden(dev)
        paper, _ = phase_paper(dev)
        launches = {"trigger_sq": paper["trigger_sq"], "mix": paper["mix"],
                    "mix_sparse": phase_fleet(dev)[0]["mix_sparse"]}
        phase_cpu(dev)
        phase_profile(torch, dev)
        torch.cuda.synchronize()
    except Exception as exc:  # report any phase's failure, then exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
