#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` and runs, failing (non-zero exit, no final ``ok`` line) on any
error:

1. card: the GPU's name and power limit from ``nvidia-smi``;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with its time, the plain version's, one PyTorch library
   call's and the least time the card could take (``bound_ms``); the two
   SWA kernels (split TF32 on the tensor cores for fp32, with the SIMT
   kernel, the fp32 path's earlier design, and a build whose split rounds
   lo to nearest timed beside it, all three held against fp64; bf16 on the
   tensor cores) at S=8192 and S=32768, each with the per-phase cycle
   profile of a build with its profile macro (``VARIANT_BUILDS``); the
   gather-mix's three routes with
   the row-group plan of their fabric (build time, groups, union rows):
   the 128-column kernel on the fleet fabric, the wide kernel on the dense
   rgg r=0.4 fabric at m=1024 and on rgg r=0.2 at m=4096, and the wide
   and direct kernels on rgg r=0.4 at m=4096, each route alone on its
   rows; on each dense fabric the plan's chunk width beside the other;
   the sweep's cell axis at C = 8 (``mix`` at m=1024, D=50890, against
   batched ``torch.matmul`` and the fp64 gates; ``mix_sparse`` on the
   fleet fabric, rgg r=0.4 at m=1024 and at m=4096, against CSR of the
   block-diagonal P), each cell bit-equal to its solo launch; the
   gather-mix over a rectangular source at phase 5h's large cell's shapes
   (m=16384 on 8 shards, the stacked [own; halo] buffer of n_src rows)
   against CSR of the same rectangular P;
   the dense mix's and the fp32 SWA kernel's tensor-core opcodes and
   registers (``cuobjdump``, TF32 ones required) and their error and bias
   against fp64, each within a stated limit;
3. golden: the m=8 golden configurations of
   ``tests/test_golden_trajectory.py`` (svm and ``mlp_blocks``) on the
   card under ``mix_impl="pallas"`` and ``"sparse_pallas"``, against
   ``tests/golden/efhc_m8_trajectory.json`` and
   ``efhc_m8_mlp_blocks.json``;
4. paper: ``api.simulate`` at m=1024, mlp, D=50890, ``mix_impl="pallas"``
   for 20 iterations, counting ``trigger_sq`` and ``mix`` launches, then
   with the plain ``mix_impl="dense"``: v, comm_count and deg must agree
   (a flip is reported with its decision margins);
5. fleet: ``simulator.run`` at m=4096, svm, D=7850 on the rgg
   ``fleet_radius`` fabric with edge dropout, ``mix_impl="sparse_pallas"``
   for 20 iterations, counting ``mix_sparse`` launches, then with the
   plain ``mix_impl="sparse"``: v, comm_count and deg must agree; then the
   same at m=1024 on the rgg r=0.4 fabric (10 iterations, every row on
   ``mix_sparse_wide``) and at m=4096 on rgg r=0.4 (3 iterations, on
   ``mix_sparse_wide`` and ``mix_sparse_direct``);
   4b. paper sweep: ``api.sweep`` of the paper cell over seeds (0, 1) and
   the four policies, 8 cells in one batched run: exactly 20 ``mix`` and
   20 ``trigger_sq`` launches (one an iteration for all cells), its
   ``mix_impl="dense"`` twin (every cell's v, comm_count and deg equal),
   each cell against ``api.simulate`` of its (seed, policy) on the card,
   and the sweep's ms/iteration beside 8 x the solo runs';
   5b. fleet sweep: ``run_sweep`` of the fleet cell over the same grid:
   exactly 20 ``mix_sparse`` launches, and its ``sparse`` twin;
   5c. service: ``api.serve`` on one ``ScenarioService`` (max_cells 8),
   two waves of interleaved requests over three signatures (A the paper
   cell, 6 cells; B svm ``sparse_pallas`` on the spec's rgg r=0.4 fabric,
   3 cells; C B on another fabric): every report ok, one launch per
   signature a wave with exactly 20 ``trigger_sq`` + 20 ``mix`` (A) and
   20 ``mix_sparse_wide`` (B, C) launches, 2 gather-mix plan builds over
   both waves, engine and program cache hits in the second, every cell
   against its solo ``api.simulate`` on the card; then A with an Inf
   training row planted (``PoisonedProvider``): the cell that draws it
   quarantined, its neighbour in the launch equal to its solo run;
   5d. deep models: ``api.simulate`` of ``cnn`` and ``mlp_blocks`` at
   m=1024, dim 784, and ``tiny_transformer`` at m=64 on seeded token
   windows, each under ``mix_impl="pallas"`` (exactly 20 ``mix`` + 20
   ``trigger_sq`` launches) beside its ``dense`` twin (the cnn's step by
   step from the same state, ``StepTwin``: the decisions, the ``mix``
   kernel's output, the loss and the consensus error; its whole runs
   under ``dense``, ``delta`` and an fp64 dense mix printed, ungated);
   5e. paper dynamics: the paper cell with every scenario-dynamics
   mechanism on (churn, stragglers, the bandwidth walk, a budget of 4
   broadcasts, cluster outages, flapping links, crashes with warm start,
   the scripted partition of iterations 8-11, a window-4 watchdog):
   exactly 20 ``trigger_sq`` + 20 ``mix`` launches, each mechanism at
   work, its ``dense`` twin equal on all nine integer channels; then its
   seeds (0, 1) x four policies sweep (8 cells, each with its own
   adjacency: 20 + 20 launches), every cell against its solo card run;
   5f. fleet dynamics: the fleet cell with churn, flapping links, crashes
   with warm start and a window-8 watchdog: exactly 20 ``mix_sparse``
   launches (the warm start's neighbour sum is the plain ELL slot loop),
   at most one plan build, its ``sparse`` twin equal on every integer
   channel;
   5h. sharded: the fleet cell through ``mix_impl="sharded"`` at S = 1, 2
   and 8 in one process, each after the gather-mix wrapper on that S's
   [own; halo] table held bit-exact against its plain version, and each
   against phase 5's ``sparse_pallas`` run (integer channels equal, floats
   within RTOL / ATOL, every channel but consensus_err bit-equal), then at
   S = 8 under ``torch.distributed`` on NCCL at world size 1, bit-equal to
   the one-process run; then m=16384 on 8 shards with 5f's knobs beside
   its ``sparse_pallas`` twin (every integer channel equal, every channel
   but consensus_err bit-equal), with the plan's
   halo sizes, the halo bytes an iteration, device activities and the
   idle share; every run exactly 20 ``mix_sparse`` launches;
   5g. resume: ``run_checkpointed`` of the 5e cell with Adam, a checkpoint
   every 10 iterations (~0.84 GB each) in a temporary directory: halted
   after one segment and resumed in a fresh Python process, bit-equal on
   every channel to the uninterrupted run, and against ``run`` integer
   channels equal, floats within RTOL / ATOL; each checkpoint's bytes and
   save and restore seconds;
6. cpu: m=64, svm, D=7850, ``mix_impl="pallas"``, T=30, the same with
   5e's knobs (every dynamics channel too), the same sharded on 4 shards,
   and m=16, cnn, T=10, on the card and on the CPU (plain versions),
   channel by channel;
7. profile: device activities, device busy time, idle share and each of
   the repo's kernels' device time per iteration of the paper, fleet,
   dense-fabric, paper-sweep and fleet-sweep paths, one service launch of
   signature A, the cnn path and the 5e and 5f paths, under
   ``torch.profiler``, and one watchdog step at 5e's and 5f's shapes;
8. serve: starcoder2-15b at full width and depth (40 layers, bf16,
   ``attn_impl="pallas_swa"``, random weights from a seeded generator):
   one prefill of 32768 tokens through the steps of
   ``repro_torch.launch.steps``, counting the SWA launches (all on the
   tensor-core kernel) and holding layer 0's kernel output against the
   plain version on three heads, then four requests decoded one token at
   a time (16 prompt tokens replayed into the KV cache, 16 greedy tokens)
   against ``forward`` on the same tokens;
9. serve_fp32: starcoder2-15b at full width in fp32, its depth cut from 40
   to 2 layers: one prefill of 8192 tokens, both SWA launches on the
   split-TF32 kernel, layer 0's kernel output against the plain version
   on three heads, the logits against the same prefill with
   ``attn_impl="chunked"`` within atol=rtol 1e-4, then decode as in 8;
10. serve_cpu: the starcoder2 smoke configuration (fp32, S=128) on the
   card (the split-TF32 SWA kernel) and on the CPU (plain versions),
   logits within atol=rtol 1e-4.

The SIMT SWA kernel has no wrapper route, so no counter: its launches are
counted from the profiler's device activities in the prefills of 8-10,
beside each prefill's counted launches of the kernel that serves it.

A line ``[t s] ... done`` after each group of phases gives the script's
time so far.  The line before the last is one JSON object
``{"kernels": [...]}``; the
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

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s,
# fp32 FLOP/s outside the tensor cores and dense bf16 and TF32 tensor-core
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 494.7e12

# golden tolerances of tests/test_golden_trajectory.py
RTOL, ATOL = 2e-4, 2e-5
# the split-TF32 mix against fp64 (phase 2): largest error within this
# multiple of cuBLAS's fp32 one, mean relative bias within fp32's ulp
MIX_FP64_ERR_VS_LIB = 2.0
MIX_FP64_BIAS = 2.0 ** -23
# the split-TF32 SWA kernel against fp64 (phase 2) on a few heads (the
# first, the first of the second KV group, the last): largest error within
# this multiple of the SIMT kernel's fp32 one, mean relative bias within
# fp32's ulp
SWA_FP64_ERR_VS_SIMT = 2.0
SWA_FP64_BIAS = 2.0 ** -23
SWA_FP64_HEADS = (0, 12, 47)
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "tx_time", "util", "consensus_err")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time in ms for the work: the larger of its bytes over the
    memory rate and its operations over the peak rate of their type
    (fp32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def kernel_resources(lib: Path) -> dict[str, dict]:
    """Per kernel function of the built library (mangled names shortened to
    the function's name and template argument): registers from
    ``cuobjdump -res-usage`` (and its stack frame, where spills go) and the
    tensor-core instructions in its SASS (``cuobjdump -sass``), by opcode."""
    import re

    from repro_torch.kernels import build

    tool = str(Path(build.nvcc()).parent / "cuobjdump")

    def run(*args):
        return subprocess.run([tool, *args, str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout

    def short(mangled):
        # an identifier is mangled as its length and its name: find the
        # "<n>..._kernel" whose length prefix ends a run of digits
        for m in re.finditer(r"\d+", mangled):
            for i in range(len(m.group())):
                end = m.end() + int(m.group()[i:])
                name = mangled[m.end():end]
                if name.endswith("_kernel") and re.fullmatch(r"[a-z_][a-z0-9_]*", name):
                    tmpl = re.match(r"I(?:Li\d+E)+E", mangled[end:])
                    args = re.findall(r"Li(\d+)E", tmpl.group() if tmpl else "")
                    return f"{name}<{', '.join(args)}>" if args else name
        return mangled

    facts: dict[str, dict] = {}
    for name, regs, stack in re.findall(r"Function (\S+):\s*REG:(\d+)(?:\s+STACK:(\d+))?",
                                        run("-res-usage")):
        facts.setdefault(short(name), {})["registers"] = int(regs)
        if stack:
            facts[short(name)]["stack"] = int(stack)
    for block in run("-sass").split("Function : ")[1:]:
        name = short(block.split()[0])
        ops = re.findall(r"\b((?:HGMMA|HMMA)\.[A-Z0-9x.]+)", block)
        facts.setdefault(name, {})["tensor_ops"] = dict(
            sorted((op, ops.count(op)) for op in set(ops)))
    return facts


def card_state() -> str:
    """The card's SM clock, power draw and temperature now, to read beside
    the timing that just ended (a card under sustained load clocks down)."""
    return card_line("clocks.sm,power.draw,temperature.gpu")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev, seed: int, variant_libs: dict[str, Path]
                  ) -> dict[str, dict]:
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
    # path runs on; tolerance: fp32 products summed in another order (the
    # kernel's split TF32 drops terms ~2^-22 of each product, far below it)
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
    # both against fp64: the largest error and the mean error signed along
    # the exact value, relative to its mean size (a truncating sum shrinks)
    exact = p.double() @ w.double()
    fp64_err = {k: (float((v.double() - exact).abs().max()),
                    float(((v.double() - exact) * exact.sign()).mean() / exact.abs().mean()))
                for k, v in (("kernel", got), ("library", ref))}
    del exact
    # the split's limits against fp64: its largest error within twice
    # cuBLAS's fp32 one, and its bias within one fp32 ulp (2^-23) of the
    # values' mean size.  (cuBLAS's own bias, ~1e-11, is at this measure's
    # noise floor, so no multiple of it is a yardstick.)
    check(fp64_err["kernel"][0] <= MIX_FP64_ERR_VS_LIB * fp64_err["library"][0],
          f"mix: max abs err against fp64 {fp64_err['kernel'][0]:.3g} > "
          f"{MIX_FP64_ERR_VS_LIB} x torch.matmul's {fp64_err['library'][0]:.3g}")
    check(abs(fp64_err["kernel"][1]) <= MIX_FP64_BIAS,
          f"mix: mean relative bias against fp64 {fp64_err['kernel'][1]:.3g} "
          f"outside +-{MIX_FP64_BIAS:.3g}")
    ms = time_ms(torch, lambda: mixing_ops.mix(p, w))
    plain = time_ms(torch, lambda: mix_ref(p, w))
    lib = time_ms(torch, lambda: torch.matmul(p, w))
    # split TF32: three tensor-core products per fp32 one, at the TF32 peak;
    # beside it the bound of fp32 arithmetic off the tensor cores
    b_ms, b_by = bound((m * m + 2 * m * n) * 4, 3 * 2 * m * m * n, TF32_TC_FLOPS)
    b_fp32, _ = bound((m * m + 2 * m * n) * 4, 2 * m * m * n)
    # the kernel's SASS must hold the TF32 tensor-core instructions
    from repro_torch.kernels import build
    res = kernel_resources(build.build())
    mix_res = {k: v for k, v in res.items() if k.startswith("mix_kernel")}
    tc = sorted({op for v in mix_res.values() for op in v.get("tensor_ops", {})
                 if "TF32" in op})
    check(bool(mix_res) and all(any("TF32" in op for op in v.get("tensor_ops", {}))
                                for v in mix_res.values()),
          f"mix: no TF32 tensor-core instruction in the kernel's SASS ({mix_res})")
    rows["mix"] = {"name": "mix", "shape": [m, n], "max_abs_err": abs_err,
                   "tolerance": f"atol {mix_atol}", "ms": ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib, "sass_tensor_ops": tc}
    print("kernel resources (cuobjdump -res-usage / -sass): " + "; ".join(
        f"{k} {v.get('registers')} registers, stack {v.get('stack', 'not read')} B, "
        f"tensor ops {v.get('tensor_ops') or 'none'}"
        for k, v in sorted(res.items()) if k.startswith(("mix", "swa_tf32"))))
    print(f"kernel mix m={m} D={n}: max abs err {abs_err:.3g} (tol atol "
          f"{mix_atol}); kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
          f"{lib:.4f} (torch.matmul, TF32 off) bound_ms {b_ms:.4f} ({b_by}: 3 x "
          f"2 m^2 D at the TF32 tensor-core peak {TF32_TC_FLOPS:.4g} FLOP/s; "
          f"fp32 off the tensor cores {b_fp32:.4f}); {2 * m * m * n / ms / 1e9:.1f}"
          f" fp32-product TFLOP/s; against fp64: kernel max abs err "
          f"{fp64_err['kernel'][0]:.3g}, mean relative bias {fp64_err['kernel'][1]:.3g}"
          f" (limits {MIX_FP64_ERR_VS_LIB} x torch.matmul's, +-{MIX_FP64_BIAS:.3g}); "
          f"torch.matmul {fp64_err['library'][0]:.3g}, {fp64_err['library'][1]:.3g}")
    del w, p, adj, got, ref

    # mix_sparse: the real neighbor list of the large-fleet fabric and its
    # row-group plan, built as a run builds it; the kernel rounds every
    # product and sum as the plain version does, so the two must agree bit
    # for bit
    m, n = 4096, 7850
    g = topology.make_process(m, "rgg", radius=topology.fleet_radius(m),
                              time_varying="edge_dropout", drop=0.3, seed=0)
    nl = topology.StagedNeighbors.from_host(g.neighbors(), dev)
    plan = mixing_ops.prepare_plan(nl.idx)  # as simulator.run builds it
    check(plan.n_direct == 0, f"mix_sparse: {plan.n_direct} rows of the fleet "
                              f"fabric do not fit a slab")
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
    csr = _csr(torch, nl.idx, p_diag, p_off)  # the same P for the library call
    nz = p_off != 0
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w))
    plain = time_ms(torch, lambda: mix_sparse_ref(nl.idx, p_diag, p_off, w))
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w))
    nnz = int(nz.sum())
    d_max = nl.d_max
    b_ms, b_by = _sparse_bound(nnz, m, m, d_max, n)
    rows["mix_sparse"] = {
        "name": "mix_sparse", "shape": [m, n], "d_max": d_max,
        "nnz_off": nnz, "max_abs_err": abs_err, "tolerance": "exact",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "plan_build_ms": plan.build_ms}
    print(f"kernel mix_sparse m={m} D={n} d_max={d_max} nnz_off={nnz}: max abs "
          f"err {abs_err:.3g} (tol exact); kernel_ms {ms:.4f} plain_ms "
          f"{plain:.4f} library_ms {lib:.4f} (torch.sparse.mm, CSR) bound_ms "
          f"{b_ms:.4f} ({b_by}); plan: built in {plan.build_ms:.1f} ms (host, "
          f"once per run), {plan.n_groups} groups, "
          f"{plan.mean_union:.1f} union rows per group, largest union "
          f"{plan.max_union} rows / group {plan.max_rows} rows, "
          f"{plan.smem_bytes} B of shared memory a block; nonzero share of "
          f"slots {nnz / (m * d_max):.4f}")
    del w, got, ref, csr
    rows["mix_sparse_wide"] = _wide_row(torch, dev, gen)
    _width_row(torch, dev, gen)
    rows["mix_sparse_direct"], wide_4096 = _direct_row(torch, dev, gen)
    rows["mix_sparse_wide"].update(wide_4096)
    # the sweep's cell axis: C = 8 cells in one launch
    rows["mix"].update(_mix_cells_row(torch, dev, gen))
    rows["mix_sparse"].update(_mix_sparse_cells_row(torch, dev, gen, 4096, None,
                                                    ("mix_sparse",)))
    rows["mix_sparse_wide"].update(_mix_sparse_cells_row(torch, dev, gen, 1024, 0.4,
                                                         ("mix_sparse_wide",)))
    rows["mix_sparse_direct"].update(_mix_sparse_cells_row(
        torch, dev, gen, 4096, 0.4, ("mix_sparse_wide", "mix_sparse_direct")))
    # the sharded engine's rectangular source (phase 5h)
    rows["mix_sparse"].update(_halo_row(torch, dev, gen))
    rows.update(_swa_fp32_rows(torch, dev, gen, res, variant_libs))
    rows.update(_swa_rows(torch, dev, gen, variant_libs["swa_attention_tc"]))
    return rows


CELLS = 8  # the paper sweep's cells: seeds (0, 1) x four policies


def _mix_cells_row(torch, dev, gen, m: int = 1024, n: int = 50890,
                   cells: int = CELLS) -> dict:
    """The dense mix with the sweep's cell axis: P (C, m, m), W (C, m, D)
    in one launch.  Each cell must give the bits of a launch on that cell
    alone, and the batch stays within the split-TF32 gates against fp64;
    timed against the plain version, batched ``torch.matmul`` (TF32 off)
    and C x the solo bound."""
    from repro_torch.core import mixing, topology, triggers
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ref

    g = topology.make_process(m, "rgg", time_varying="edge_dropout", drop=0.3, seed=0)
    adj = g.adjacency(0, dev)
    v = torch.rand((cells, m), generator=gen, device=dev) < 0.5
    p = mixing.build_p(adj, triggers.communication_matrix(v, adj))
    w = torch.randn((cells, m, n), generator=gen, device=dev)
    before = mixing_ops.LAUNCHES["mix"]
    got = mixing_ops.mix(p, w)
    check(mixing_ops.LAUNCHES["mix"] == before + 1, "mix with cells: not one launch")
    for c in range(cells):
        check(torch.equal(got[c], mixing_ops.mix(p[c], w[c])),
              f"mix with cells: cell {c} differs from its solo launch")
    ref = mix_ref(p, w)
    abs_err = float((got - ref).abs().max())
    exact = p.double() @ w.double()
    fp64_err = {k: (float((x.double() - exact).abs().max()),
                    float(((x.double() - exact) * exact.sign()).mean() / exact.abs().mean()))
                for k, x in (("kernel", got), ("library", ref))}
    del exact
    check(fp64_err["kernel"][0] <= MIX_FP64_ERR_VS_LIB * fp64_err["library"][0],
          f"mix with cells: max abs err against fp64 {fp64_err['kernel'][0]:.3g} > "
          f"{MIX_FP64_ERR_VS_LIB} x torch.matmul's {fp64_err['library'][0]:.3g}")
    check(abs(fp64_err["kernel"][1]) <= MIX_FP64_BIAS,
          f"mix with cells: mean relative bias against fp64 "
          f"{fp64_err['kernel'][1]:.3g} outside +-{MIX_FP64_BIAS:.3g}")
    ms = time_ms(torch, lambda: mixing_ops.mix(p, w), reps=10)
    plain = time_ms(torch, lambda: mix_ref(p, w), reps=10)
    lib = time_ms(torch, lambda: torch.matmul(p, w), reps=10)
    solo = time_ms(torch, lambda: mixing_ops.mix(p[0], w[0]))
    b_ms, b_by = bound(cells * (m * m + 2 * m * n) * 4, cells * 3 * 2 * m * m * n,
                       TF32_TC_FLOPS)
    print(f"kernel mix with cells C={cells} m={m} D={n}: every cell bit-equal to its "
          f"solo launch; max abs err {abs_err:.3g} against the plain version; against "
          f"fp64: kernel {fp64_err['kernel'][0]:.3g} (bias {fp64_err['kernel'][1]:.3g}),"
          f" torch.matmul {fp64_err['library'][0]:.3g} (limits {MIX_FP64_ERR_VS_LIB} x "
          f"torch.matmul's, +-{MIX_FP64_BIAS:.3g}); kernel_ms {ms:.4f} ({ms / solo:.3f} x "
          f"the solo launch's {solo:.4f} in this call, {ms / (cells * solo):.3f} of "
          f"{cells} solo launches) plain_ms {plain:.4f} library_ms {lib:.4f} "
          f"(torch.matmul on (C, m, m) @ (C, m, D), TF32 off) bound_ms {b_ms:.4f} "
          f"({b_by}, {cells} x the solo bound)")
    return {"cells": cells, "ms_c8": ms, "plain_ms_c8": plain, "library_ms_c8": lib,
            "bound_ms_c8": b_ms, "solo_ms_in_c8_call": solo,
            "fp64_max_abs_err_c8": fp64_err["kernel"][0]}


def _csr_cells(torch, idx, p_diag, p_off):
    """The C cells' ELL P as one block-diagonal (C m, C m) CSR matrix."""
    cells, m, d = p_off.shape
    off = (torch.arange(cells, device=idx.device) * m)[:, None, None]
    nz = p_off != 0
    r = torch.arange(m, device=idx.device)[None, :, None] + off
    diag = (torch.arange(m, device=idx.device)[None, :] + off[:, :, 0]).reshape(-1)
    rows = torch.cat([r.expand(cells, m, d)[nz], diag])
    cols = torch.cat([(idx[None] + off)[nz], diag])
    return torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.cat([p_off[nz], p_diag.reshape(-1)]),
        (cells * m, cells * m)).coalesce().to_sparse_csr()


def _mix_sparse_cells_row(torch, dev, gen, m: int, radius: float | None,
                          routes: tuple[str, ...], n: int = 7850,
                          cells: int = CELLS) -> dict:
    """The gather-mix with the sweep's cell axis on one rgg fabric
    (``radius`` None: the fleet's): one shared table and plan, each cell
    its own broadcasting devices.  The wrapper must launch each route of
    ``routes`` once for all cells, and each cell must give the plain slot
    loop's bits and those of a launch on that cell alone; timed against
    the plain version, CSR ``torch.sparse.mm`` of the block-diagonal
    (C m, C m) P on W as (C m, D), and the bound of the cells' work."""
    from repro_torch.core import topology
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    nl, p_diag, p_off = _ell_p(torch, dev, gen, m, radius or topology.fleet_radius(m),
                               cells)
    w = torch.randn((cells, m, n), generator=gen, device=dev)
    plan = mixing_ops.prepare_plan(nl.idx)
    label = f"mix_sparse with cells C={cells} m={m} rgg r={radius or 'fleet'}"
    # the plain version, timed once (at m=4096 r=0.4 one call takes seconds)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ref = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    b.record()
    b.synchronize()
    plain = a.elapsed_time(b)
    abs_err = _wrapper_check(torch, nl, p_diag, p_off, w, ref, routes, label)
    for c in range(cells):
        check(torch.equal(mixing_ops.mix_sparse(nl.idx, p_diag[c], p_off[c], w[c]), ref[c]),
              f"{label}: cell {c}'s solo launch differs from the batched one")
    reps = 5 if plan.n_direct else 10
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w), reps=reps)
    solo = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag[0], p_off[0], w[0]),
                   reps=reps)
    csr = _csr_cells(torch, nl.idx, p_diag, p_off)
    w2 = w.reshape(cells * m, n)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w2), reps=reps)
    del csr
    nnz = int((p_off != 0).sum())
    b_ms, b_by = _sparse_bound(nnz, cells * m, cells * m, nl.d_max, n)
    print(f"kernel {label} D={n} d_max={nl.d_max} nnz_off={nnz} (all cells): routes "
          f"{routes} launched once each for all cells, every cell bit-equal to the "
          f"plain version and to its solo launch (max abs err {abs_err:.3g}); "
          f"kernel_ms {ms:.4f} ({ms / solo:.3f} x the solo launch's {solo:.4f} in this "
          f"call, {ms / (cells * solo):.3f} of {cells} solo launches) plain_ms "
          f"{plain:.4f} (one call) library_ms {lib:.4f} (torch.sparse.mm, CSR, the "
          f"block-diagonal (C m, C m) P) bound_ms {b_ms:.4f} ({b_by}); one plan "
          f"({plan.n_groups} groups, {plan.n_direct} direct rows)")
    return {"cells": cells, "ms_c8": ms, "plain_ms_c8": plain, "library_ms_c8": lib,
            "bound_ms_c8": b_ms, "solo_ms_in_c8_call": solo}


def _ell_p(torch, dev, gen, m: int, radius: float, cells: int | None = None):
    """The rgg fabric at ``radius`` with edge dropout, its neighbor list on
    the card and the ELL P of half the devices broadcasting (with
    ``cells``, each cell its own broadcasting devices over the shared
    table: p_diag (C, m), p_off (C, m, d_max))."""
    from repro_torch.core import mixing, topology

    g = topology.make_process(m, "rgg", radius=radius, time_varying="edge_dropout",
                              drop=0.3, seed=0)
    nl = topology.StagedNeighbors.from_host(g.neighbors(), dev)
    adj_ell = g.adjacency_ell(0, nl)
    v = torch.rand(m if cells is None else (cells, m), generator=gen, device=dev) < 0.5
    comm_ell = torch.logical_and(torch.logical_or(v[..., :, None], v[..., nl.idx]),
                                 adj_ell)
    p_diag, p_off = mixing.build_p_ell(nl.idx, adj_ell, comm_ell)
    return nl, p_diag, p_off


def _sparse_bound(nnz: int, rows: int, reads: int, d_max: int, n: int
                  ) -> tuple[float, str]:
    """The gather-mix over ``rows`` output rows: the ``reads`` rows of W
    they read once, the outputs written once and their slot lists (fp32
    weight, int64 index) against 2 flops per weighted (slot, column) and
    one product per (row, column) for the diagonal."""
    return bound((reads + rows) * n * 4 + rows * d_max * (8 + 4) + rows * 4,
                 2 * nnz * n + rows * n)


def _wide_row(torch, dev, gen, m: int = 1024, n: int = 7850) -> dict:
    """The wide tier at the shapes of the dense-fabric path (phase 5): rgg
    r=0.4 at m=1024 (d_max 516), every row staged.  The wrapper (the slot
    compaction and ``mix_sparse_wide_kernel``) must give the plain
    version's bits and launch only the wide route; it is timed against
    the plain slot loop and CSR ``torch.sparse.mm`` of the whole P, and at
    both chunk widths (``_widths``)."""
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    nl, p_diag, p_off = _ell_p(torch, dev, gen, m, 0.4)
    plan = mixing_ops.prepare_plan(nl.idx)
    check(plan.wide and plan.n_direct == 0,
          f"dense fabric: expected every row in wide groups, got chunk {plan.chunk}, "
          f"{plan.n_direct} direct rows")
    w = torch.randn((m, n), generator=gen, device=dev)
    ref = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    abs_err = _wrapper_check(torch, nl, p_diag, p_off, w, ref, ("mix_sparse_wide",),
                             "dense fabric")
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w))
    plain = time_ms(torch, lambda: mix_sparse_ref(nl.idx, p_diag, p_off, w))
    csr = _csr(torch, nl.idx, p_diag, p_off)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w))
    widths = _widths(torch, nl, p_diag, p_off, w, plan, ref)
    nnz = int((p_off != 0).sum())
    b_ms, b_by = _sparse_bound(nnz, m, m, nl.d_max, n)
    print(f"kernel mix_sparse_wide m={m} D={n} rgg r=0.4 d_max={nl.d_max} nnz_off={nnz}: "
          f"max abs err {abs_err:.3g} (tol exact); wrapper (slot compaction + wide "
          f"kernel) kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
          f"(torch.sparse.mm, CSR, the whole P) bound_ms {b_ms:.4f} ({b_by}); plan: "
          f"built in {plan.build_ms:.1f} ms (host, once per run, both widths cut), "
          f"{plan.chunk} columns, {plan.mean_union:.1f} union rows per group, largest "
          f"union {plan.max_union} rows / group {plan.max_rows} rows, "
          f"{plan.smem_bytes} B of slab a block; {_widths_text(widths, plan.chunk)}; "
          f"nonzero share of slots {nnz / (m * nl.d_max):.4f}")
    return {"name": "mix_sparse_wide", "shape": [m, n], "d_max": nl.d_max,
            "max_abs_err": abs_err, "tolerance": "exact", "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "plan_build_ms": plan.build_ms,
            **{f"ms_{c}_columns": t for c, (_, t) in widths.items()}}


HALO_M, HALO_SHARDS = 16384, 8  # phase 5h's large sharded cell


def _halo_case(torch, dev, gen, m: int, shards: int, n: int = 7850):
    """The sharded engine's gather-mix at m devices on ``shards`` shards:
    the fleet fabric (rgg at ``fleet_radius(m)``, edge dropout 0.3) cut by
    ``shard_plan``, the table of all shards over the stacked [own rows ;
    halo rows] buffer (``ShardCtx.nbr_loc``, n_src = m + S H_max rows) and
    a P of half the devices broadcasting.  The wrapper must launch the
    128-column route once and give the plain version's bits.  Returns
    (plan, ctx, gather-mix plan, p_diag, p_off, w, abs_err)."""
    from repro_torch.core import efhc, topology
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    radius = topology.fleet_radius(m)
    g = topology.make_process(m, "rgg", radius=radius, time_varying="edge_dropout",
                              drop=0.3, seed=0)
    plan = topology.shard_plan(g.edges, shards, coords=g.coords)
    ctx = efhc.ShardCtx.of(plan, range(shards), dev)
    # the fleet's P, its rows in the shards' order (their slots are the
    # global table's: plan.nbr_gid = idx[owned])
    _, p_diag, p_off = _ell_p(torch, dev, gen, m, radius)
    p_diag, p_off = p_diag[ctx.owned].contiguous(), p_off[ctx.owned].contiguous()
    n_src = m + shards * plan.h_max
    w = torch.randn((n_src, n), generator=gen, device=dev)
    pl = mixing_ops.prepare_plan(ctx.nbr_loc)
    check(not pl.wide and pl.n_direct == 0 and pl.n_src <= n_src,
          f"halo table m={m} S={shards}: expected the 128-column tier, got chunk "
          f"{pl.chunk}, {pl.n_direct} direct rows, n_src {pl.n_src} of {n_src}")
    nl = topology.StagedNeighbors(idx=ctx.nbr_loc, mask=ctx.mask)
    ref = mix_sparse_ref(ctx.nbr_loc, p_diag, p_off, w)
    abs_err = _wrapper_check(torch, nl, p_diag, p_off, w, ref, ("mix_sparse",),
                             f"the [own; halo] buffer at m={m}, S={shards}")
    del ref
    return plan, ctx, pl, p_diag, p_off, w, abs_err


def _halo_row(torch, dev, gen, m: int = HALO_M, shards: int = HALO_SHARDS,
              n: int = 7850) -> dict:
    """The gather-mix over a rectangular source at phase 5h's large cell's
    shapes (``_halo_case`` at m=16384 on 8 shards): bit-equal to the plain
    version, timed against the plain slot loop, CSR ``torch.sparse.mm`` of
    the same rectangular (m, n_src) P, and the bound of the rows it reads."""
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    plan, ctx, pl, p_diag, p_off, w, abs_err = _halo_case(torch, dev, gen, m, shards, n)
    n_src = w.shape[0]
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(ctx.nbr_loc, p_diag, p_off, w))
    plain = time_ms(torch, lambda: mix_sparse_ref(ctx.nbr_loc, p_diag, p_off, w), reps=5)
    nz = p_off != 0
    r = torch.arange(m, device=dev)
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat([r[:, None].expand_as(ctx.nbr_loc)[nz], r]),
                     torch.cat([ctx.nbr_loc[nz], r])]),
        torch.cat([p_off[nz], p_diag]), (m, n_src)).coalesce().to_sparse_csr()
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w))
    nnz = int(nz.sum())
    # the source rows this P reads: every own row (its self term) and the
    # halo rows of its weighted slots
    reads = int(torch.unique(torch.cat([r, ctx.nbr_loc[nz]])).numel())
    b_ms, b_by = _sparse_bound(nnz, m, reads, plan.d_max, n)
    print(f"kernel mix_sparse over a halo buffer m={m} n_src={n_src} ({shards} shards, "
          f"B_max {plan.b_max}, H_max {plan.h_max}, boundary_frac "
          f"{plan.boundary_frac:.4f}) D={n} d_max={plan.d_max} nnz_off={nnz}: max abs "
          f"err {abs_err:.3g} (tol exact); kernel_ms {ms:.4f} plain_ms {plain:.4f} "
          f"library_ms {lib:.4f} (torch.sparse.mm, CSR, the rectangular P) bound_ms "
          f"{b_ms:.4f} ({b_by}, {reads} source rows read); plan: built in "
          f"{pl.build_ms:.1f} ms, {pl.n_groups} groups, {pl.mean_union:.1f} union rows "
          f"per group, largest union {pl.max_union} rows / group {pl.max_rows} rows")
    del csr, w
    return {"ms_halo": ms, "plain_ms_halo": plain, "library_ms_halo": lib,
            "bound_ms_halo": b_ms, "bound_by_halo": b_by, "max_abs_err_halo": abs_err}


def _wrapper_check(torch, nl, p_diag, p_off, w, ref, routes, label) -> float:
    """One wrapper call: it must launch each gather-mix route of
    ``routes`` once and no other, and give the plain version's bits."""
    from repro_torch.kernels.mixing import ops as mixing_ops

    before = dict(mixing_ops.LAUNCHES)
    got = mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w)
    torch.cuda.synchronize()
    moved = {k: mixing_ops.LAUNCHES[k] - before[k] for k in before}
    check(moved == {k: int(k in routes) for k in before},
          f"{label}: the wrapper launched {moved}, expected one of each of {routes}")
    abs_err = float((got - ref).abs().max())
    check(abs_err == 0.0, f"mix_sparse on {label}: max abs err {abs_err:.3g}, expected 0")
    return abs_err


def _launcher(torch, plan, p_diag, p_off, w, routes=("wide", "direct")):
    """A call of a wide plan's routes of ``routes`` that it gives rows to
    (the slot compaction and wide kernel, then the finiteness pass and
    direct kernel), as the wrapper launches them, into one output,
    counting no launch."""
    from repro_torch.kernels import build, stream_handle

    m, n = w.shape
    idx = plan.nbr_idx
    d_max = idx.shape[1]
    n_rows, stride = plan.rows.numel(), d_max + d_max % 2
    kept = torch.empty((n_rows, stride, 2), dtype=torch.int32, device=w.device)
    n_kept = torch.empty(n_rows, dtype=torch.int32, device=w.device)
    finite = torch.empty(m, dtype=torch.uint8, device=w.device)
    out = torch.empty_like(w)
    lib, stream = build.library(), stream_handle(w.device)

    def run():
        if "wide" in routes and plan.n_groups:
            build.check(lib.repro_mix_sparse_wide_f32(
                p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(), out.data_ptr(),
                plan.rows.data_ptr(), plan.row_ptr.data_ptr(), plan.union.data_ptr(),
                plan.union_ptr.data_ptr(), plan.slot_pos.data_ptr(),
                plan.self_pos.data_ptr(), kept.data_ptr(), n_kept.data_ptr(), 1, m, m,
                plan.n_groups, n_rows, d_max, stride, n, plan.max_union, plan.chunk,
                stream), "mix_sparse_wide")
        if "direct" in routes and plan.n_direct:
            build.check(lib.repro_mix_sparse_direct_f32(
                idx.data_ptr(), p_diag.data_ptr(), p_off.data_ptr(), w.data_ptr(),
                out.data_ptr(), plan.direct.data_ptr(), finite.data_ptr(), 1,
                plan.n_direct, m, m, d_max, n, stream), "mix_sparse_direct")
        return out
    return run


def _widths(torch, nl, p_diag, p_off, w, plan, ref) -> dict[int, tuple]:
    """Chunk width -> (plan, ms) of both routes (wide groups, then direct
    rows) at each wide width: the wrapper's plan and the other width's cut
    (``plan.group_rows``), each launched as the wrapper launches it and
    required to give the plain version's bits."""
    from repro_torch.kernels.mixing import plan as mixing_plan

    out = {}
    for chunk in mixing_plan.WIDE_CHUNKS:
        cut = plan if chunk == plan.chunk else mixing_plan.plan_of(
            nl.idx, chunk, mixing_plan.group_rows(
                nl.idx.cpu().numpy(), mixing_plan.WIDE_ROWS_MAX,
                mixing_plan.wide_union_cap(chunk)))
        run = _launcher(torch, cut, p_diag, p_off, w)
        check(torch.equal(run(), ref),
              f"the gather-mix at {chunk} columns differs from the plain version")
        out[chunk] = (cut, time_ms(torch, run, reps=10))
    return out


def _widths_text(widths: dict[int, tuple], chosen: int) -> str:
    return "; ".join(
        f"at {c} columns{' (the plan)' if c == chosen else ''}: {p.n_groups} groups, "
        f"{p.staged_per_row:.2f} staged rows per output row, {p.n_direct} direct "
        f"rows, both routes {t:.4f} ms" for c, (p, t) in widths.items())


def _width_row(torch, dev, gen, m: int = 4096, radius: float = 0.2,
               n: int = 7850) -> None:
    """The wide tier at 32 columns: rgg r=0.2 at m=4096 (d_max 579), every
    row staged.  The wrapper must give the plain version's bits; it is
    timed against CSR ``torch.sparse.mm`` of the whole P and at both
    chunk widths."""
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    nl, p_diag, p_off = _ell_p(torch, dev, gen, m, radius)
    plan = mixing_ops.prepare_plan(nl.idx)
    check(plan.wide and plan.n_direct == 0,
          f"rgg r={radius} m={m}: expected every row in wide groups")
    w = torch.randn((m, n), generator=gen, device=dev)
    ref = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    abs_err = _wrapper_check(torch, nl, p_diag, p_off, w, ref, ("mix_sparse_wide",),
                             f"rgg r={radius} m={m}")
    ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w), reps=10)
    csr = _csr(torch, nl.idx, p_diag, p_off)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, w), reps=10)
    widths = _widths(torch, nl, p_diag, p_off, w, plan, ref)
    print(f"kernel mix_sparse_wide m={m} D={n} rgg r={radius} d_max={nl.d_max}: max "
          f"abs err {abs_err:.3g} (tol exact); wrapper {ms:.4f} ms against "
          f"torch.sparse.mm of the whole P (CSR) {lib:.4f} ms; plan built in "
          f"{plan.build_ms:.1f} ms; {_widths_text(widths, plan.chunk)}")


def _direct_row(torch, dev, gen, m: int = 4096, n: int = 7850) -> tuple[dict, dict]:
    """Both routes of a wide plan with direct rows: rgg r=0.4 at m=4096
    (d_max 2090).  The wrapper (wide and direct routes) must give the
    plain version's bits; it is timed against CSR ``torch.sparse.mm`` of
    the whole P and at both chunk widths, and each route alone on its own
    rows against the plain slot loop and a CSR ``torch.sparse.mm`` over
    the same rows.  Returns the direct kernel's row and the wide kernel's
    figures here."""
    from repro_torch.core import consensus
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_sparse_ref

    nl, p_diag, p_off = _ell_p(torch, dev, gen, m, 0.4)
    plan = mixing_ops.prepare_plan(nl.idx)
    check(plan.n_direct > 0 and plan.n_groups > 0,
          f"m=4096 r=0.4: expected wide groups and direct rows, got {plan.n_groups} "
          f"groups, {plan.n_direct} direct rows")
    w = torch.randn((m, n), generator=gen, device=dev)
    ref = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    abs_err = _wrapper_check(torch, nl, p_diag, p_off, w, ref,
                             ("mix_sparse_wide", "mix_sparse_direct"), "m=4096 r=0.4")
    wrapper_ms = time_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w),
                         reps=10)
    full_csr = _csr(torch, nl.idx, p_diag, p_off)
    full_csr_ms = time_ms(torch, lambda: torch.sparse.mm(full_csr, w), reps=10)
    del full_csr
    widths = _widths(torch, nl, p_diag, p_off, w, plan, ref)
    print(f"gather-mix m={m} D={n} rgg r=0.4 d_max={nl.d_max}: wrapper (both routes) "
          f"max abs err {abs_err:.3g} (tol exact), {wrapper_ms:.4f} ms against "
          f"torch.sparse.mm of the whole P (CSR) {full_csr_ms:.4f} ms; plan built in "
          f"{plan.build_ms:.1f} ms; {_widths_text(widths, plan.chunk)}")
    figures = {}
    for route, rows_r in (("wide", plan.rows.long()), ("direct", plan.direct.long())):
        run = _launcher(torch, plan, p_diag, p_off, w, routes=(route,))
        check(torch.equal(run()[rows_r], ref[rows_r]),
              f"mix_sparse_{route} differs from the plain version on its rows")
        ms = time_ms(torch, run, reps=10)
        idx_r, pd_r, po_r = nl.idx[rows_r], p_diag[rows_r], p_off[rows_r]
        plain = time_ms(torch, lambda: consensus._sparse_mix_flat(
            idx_r, po_r, w, pd_r.reshape(-1, 1) * w[rows_r]), reps=3, warmup=1)
        csr = _csr(torch, nl.idx, p_diag, p_off, rows_r)
        lib = time_ms(torch, lambda: torch.sparse.mm(csr, w), reps=10)
        del csr
        nnz, k = int((po_r != 0).sum()), rows_r.numel()
        read = int(torch.unique(torch.cat([idx_r.reshape(-1), rows_r])).numel())
        b_ms, b_by = _sparse_bound(nnz, k, read, nl.d_max, n)
        text = ("slot compaction + wide kernel" if route == "wide"
                else "finiteness pass + direct kernel")
        print(f"kernel mix_sparse_{route} m={m} D={n} rgg r=0.4 d_max={nl.d_max}: "
              f"the route alone on its {k} of {m} rows ({text}, {plan.chunk}-column "
              f"plan): kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
              f"(torch.sparse.mm, CSR, those rows) bound_ms {b_ms:.4f} ({b_by}); "
              f"nonzero share of their slots {nnz / (k * nl.d_max):.4f}")
        figures[route] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib}
    return ({"name": "mix_sparse_direct", "shape": [m, n], "d_max": nl.d_max,
             "max_abs_err": abs_err, "tolerance": "exact", **figures["direct"]},
            {f"{k}_m4096_r04": v for k, v in figures["wide"].items()})


def _csr(torch, idx, p_diag, p_off, rows=None):
    """Rows ``rows`` (all by default) of the ELL P as one CSR matrix."""
    m = idx.shape[0]
    rows = torch.arange(m, device=idx.device) if rows is None else rows
    idx, p_diag, p_off = idx[rows], p_diag[rows], p_off[rows]
    nz = p_off != 0
    r = torch.arange(rows.numel(), device=idx.device)
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat([r[:, None].expand_as(idx)[nz], r]),
                     torch.cat([idx[nz], rows])]),
        torch.cat([p_off[nz], p_diag]), (rows.numel(), m)).coalesce().to_sparse_csr()


def swa_pairs(s: int, window: int) -> int:
    """In-window (query, key) pairs of causal sliding-window attention."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def swa_bound(b: int, s: int, h: int, g: int, dh: int, window: int,
              elem_bytes: int, flops_per_s: float = BF16_TC_FLOPS,
              products: int = 1) -> tuple[float, str]:
    """q, k, v read once and out written once, against 4 dh flops per
    in-window pair and head, ``products`` times over (3 for split TF32), at
    ``flops_per_s`` (the bf16 tensor-core peak by default)."""
    nbytes = b * s * (2 * h + 2 * g) * dh * elem_bytes
    flops = products * 4 * dh * h * b * swa_pairs(s, window)
    return bound(nbytes, flops, flops_per_s)


# swa_attention against its plain version, per output dtype: (atol, rtol,
# relative L2).  fp32 (the split-TF32 kernel; the SIMT one too): both sides
# sum the fp32 products (three TF32 products each in the split) in another
# order.  bf16 (the tensor-core kernel): the products
# are exact, P enters P V rounded to bf16 (relative 2^-9) and both sides
# round the output once, so they differ by about one bf16 step (2^-8 of the
# value); the limits sit a few such steps above that and well below the
# outputs' scale.
SWA_TOL = {"fp32": (2e-5, 2e-5, None), "bf16": (5e-3, 1e-2, 1e-2)}


def swa_close(torch, got, ref, name: str) -> tuple[bool, float, float, float]:
    """Whether ``got`` lies within ``SWA_TOL[name]`` of ``ref``, with the
    max abs error, the relative L2 error and the std of ``ref``."""
    atol, rtol, rel_max = SWA_TOL[name]
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    ok = bool(torch.allclose(got, ref, atol=atol, rtol=rtol))
    ok = ok and (rel_max is None or rel <= rel_max)
    return ok, err, rel, float(ref.std())


def swa_tol_text(name: str) -> str:
    atol, rtol, rel_max = SWA_TOL[name]
    rel = "" if rel_max is None else f", rel L2 {rel_max}"
    return f"atol {atol} rtol {rtol}{rel}"


def swa_route(torch, dtype) -> str:
    """The launch counter of the SWA kernel that serves ``dtype``."""
    return "swa_attention_tc" if dtype == torch.bfloat16 else "swa_attention_tf32"


SWA_SHAPE = (1, 48, 4, 128, 4096)  # starcoder2-15b: B, H, G, dh, window


def _swa_inputs(torch, dev, gen, s: int, dtype):
    b, h, g, dh, _ = SWA_SHAPE
    return [torch.randn((b, s, n, dh), generator=gen, device=dev).to(dtype)
            for n in (h, g, g)]


def _swa_library_call(torch, dev, qt, kt, vt):
    """``F.scaled_dot_product_attention`` over (B, H, S, dh) inputs with the
    window as a boolean mask and GQA: the library call of the SWA rows."""
    import torch.nn.functional as F

    s, win = qt.shape[2], SWA_SHAPE[4]
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def _entry_call(torch, dev, q, k, v, fn, label: str):
    """A call of an SWA kernel through its C entry point ``fn`` (no launch
    counted), into one output."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                 k.shape[2], dh, SWA_SHAPE[4], stream)
        check(err == 0, f"{label}: launch error {err}")
        return out
    return run


def _simt_call(torch, dev, q, k, v, entry: str):
    """A call of the SIMT SWA kernel through its C entry point ``entry`` (no
    wrapper route reaches it)."""
    from repro_torch.kernels import build

    return _entry_call(torch, dev, q, k, v, getattr(build.library(), entry),
                       "swa_attention")


def _variant_entry(path: Path, entry: str):
    """The C entry point ``entry`` of the SWA kernel library at ``path`` (a
    build of ``VARIANT_BUILDS``)."""
    import ctypes

    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _swa_fp64(torch, q, k, v, hh: int):
    """Head ``hh`` of the SWA output in fp64, dense and masked: (S, dh)."""
    import math

    _, h, g, dh, win = SWA_SHAPE
    gg = hh // (h // g)
    qh, kh, vh = q[0, :, hh].double(), k[0, :, gg].double(), v[0, :, gg].double()
    pos = torch.arange(qh.shape[0], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    scores = (qh @ kh.T / math.sqrt(dh)).masked_fill_(~mask, -1e30)
    return torch.softmax(scores, -1) @ vh


def _swa_fp32_rows(torch, dev, gen, res: dict, variant_libs: dict[str, Path]
                   ) -> dict[str, dict]:
    """The fp32 path at starcoder2-15b's heads: the split-TF32 kernel
    through the wrapper (the route of every fp32 CUDA tensor), the SIMT
    kernel, its earlier design, through its entry point, and the split
    kernel built with lo rounded to nearest (``-DSWA_TF32_RNA_LO``, mix.cu's
    split), all against the plain version at S=8192 within
    ``SWA_TOL["fp32"]`` and against fp64 on ``SWA_FP64_HEADS`` (the
    split's largest error within ``SWA_FP64_ERR_VS_SIMT`` x the SIMT
    kernel's, its mean relative bias within ``SWA_FP64_BIAS``), timed
    beside the plain version and SDPA in fp32, then timed at S=32768 with
    two heads held against the plain version (neither the plain version
    nor SDPA in fp32 fits the card there: both build the scores), and its
    phase profile taken there.  The split kernel's SASS must hold TF32
    tensor-core instructions."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa.ref import swa_ref

    b, h, g, dh, win = SWA_SHAPE
    # bounds: the split's three TF32 products per fp32 one at the TF32
    # tensor-core peak; the SIMT kernel's fp32 arithmetic on the fp32 units
    peaks = {"swa_attention_tf32": (TF32_TC_FLOPS, 3), "swa_attention": (FP32_FLOPS, 1)}
    q, k, v = _swa_inputs(torch, dev, gen, 8192, torch.float32)
    before = dict(swa_ops.LAUNCHES)
    got = swa_ops.swa_attention(q, k, v, window=win)
    check(swa_ops.LAUNCHES == {**before, "swa_attention_tf32":
                               before["swa_attention_tf32"] + 1},
          "swa_attention fp32: the call did not launch swa_attention_tf32 alone")
    simt = _simt_call(torch, dev, q, k, v, "repro_swa_attention_f32")
    old = simt().clone()
    rna_lo = _entry_call(torch, dev, q, k, v, _variant_entry(
        variant_libs["swa_attention_tf32_rna_lo"], "repro_swa_attention_tf32_f32"),
        "swa_attention_tf32 (-DSWA_TF32_RNA_LO)")
    rounded = rna_lo().clone()
    outs = (("swa_attention_tf32", got), ("swa_attention", old), ("rna_lo", rounded))
    ref = swa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  window=win).transpose(1, 2)
    close = {}
    for name, out in outs:
        close[name] = swa_close(torch, out, ref, "fp32")
        ok, err, rel, _ = close[name]
        check(ok, f"{name} S=8192 fp32: outside {swa_tol_text('fp32')} (max abs err "
                  f"{err:.3g}, rel L2 {rel:.3g})")
    del ref
    # against fp64: the largest error and the mean error signed along the
    # exact value, relative to its mean size (a truncating sum shrinks)
    diff = {name: [] for name, _ in outs}
    size = 0.0
    for hh in SWA_FP64_HEADS:
        exact = _swa_fp64(torch, q, k, v, hh)
        size += float(exact.abs().sum())
        for name, out in outs:
            d = out[0, :, hh].double() - exact
            diff[name].append((float(d.abs().max()), float((d * exact.sign()).sum())))
        del exact
    fp64 = {name: (max(e for e, _ in ds), sum(s_ for _, s_ in ds) / size)
            for name, ds in diff.items()}
    check(fp64["swa_attention_tf32"][0] <= SWA_FP64_ERR_VS_SIMT * fp64["swa_attention"][0],
          f"swa_attention_tf32: max abs err against fp64 {fp64['swa_attention_tf32'][0]:.3g}"
          f" > {SWA_FP64_ERR_VS_SIMT} x the SIMT kernel's {fp64['swa_attention'][0]:.3g}")
    check(abs(fp64["swa_attention_tf32"][1]) <= SWA_FP64_BIAS,
          f"swa_attention_tf32: mean relative bias against fp64 "
          f"{fp64['swa_attention_tf32'][1]:.3g} outside +-{SWA_FP64_BIAS:.3g}")
    del got, old, rounded, outs
    tc = sorted({op for kname, r in res.items() if kname.startswith("swa_tf32_kernel")
                 for op in r.get("tensor_ops", {}) if "TF32" in op})
    check(bool(tc) and all(any("TF32" in op for op in r.get("tensor_ops", {}))
                           for kname, r in res.items() if kname.startswith("swa_tf32_kernel")),
          "swa_attention_tf32: no TF32 tensor-core instruction in the kernel's SASS")

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(torch, lambda: swa_ops.swa_attention(q, k, v, window=win),
                 reps=10, warmup=2)
    rna_lo_ms = time_ms(torch, rna_lo, reps=10, warmup=2)
    simt_ms = time_ms(torch, simt, reps=5, warmup=1)
    plain = time_ms(torch, lambda: swa_ref(qt, kt, vt, window=win), reps=5, warmup=1)
    lib = time_ms(torch, _swa_library_call(torch, dev, qt, kt, vt), reps=5, warmup=1)
    del q, k, v, qt, kt, vt
    rows = {}
    for name, t in (("swa_attention_tf32", ms), ("swa_attention", simt_ms)):
        _, err, rel, _ = close[name]
        b_ms, b_by = swa_bound(b, 8192, h, g, dh, win, 4, *peaks[name])
        rows[name] = {
            "name": name, "shape": [b, 8192, h, g, dh], "window": win, "dtype": "fp32",
            "max_abs_err": err, "rel_l2": rel, "tolerance": swa_tol_text("fp32"),
            "ms": t, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "bound_share": b_ms / t,
            "fp64_max_abs_err": fp64[name][0], "fp64_bias": fp64[name][1]}
    row, old_row = rows["swa_attention_tf32"], rows["swa_attention"]
    row["bound_ms_fp32_units"] = old_row["bound_ms"]
    row["sass_tensor_ops"] = tc
    row["ms_rna_lo"] = rna_lo_ms
    row["fp64_max_abs_err_rna_lo"], row["fp64_bias_rna_lo"] = fp64["rna_lo"]
    print(f"kernel swa_attention_tf32 S=8192 fp32: max abs err {row['max_abs_err']:.3g}, "
          f"rel L2 {row['rel_l2']:.3g}, output std {close['swa_attention_tf32'][3]:.3g} "
          f"(tol {swa_tol_text('fp32')}); kernel_ms {ms:.4f} plain_ms {plain:.4f} "
          f"library_ms {lib:.4f} (F.scaled_dot_product_attention, fp32, bool mask, "
          f"enable_gqa) bound_ms {row['bound_ms']:.4f} ({row['bound_by']}: 3 TF32 "
          f"products per fp32 one at the TF32 tensor-core peak), share of the bound "
          f"{row['bound_share']:.3f}; on the fp32 units bound_ms "
          f"{row['bound_ms_fp32_units']:.4f}, share {row['bound_ms_fp32_units'] / ms:.3f}; "
          f"against fp64 on heads {list(SWA_FP64_HEADS)}: max abs err "
          f"{row['fp64_max_abs_err']:.3g}, mean relative bias {row['fp64_bias']:.3g} "
          f"(limits {SWA_FP64_ERR_VS_SIMT} x the SIMT kernel's, +-{SWA_FP64_BIAS:.3g}); "
          f"TF32 tensor ops {tc}")
    print(f"kernel swa_attention (SIMT, the earlier design, entry point called "
          f"directly) S=8192 fp32: max abs err {old_row['max_abs_err']:.3g} (tol "
          f"{swa_tol_text('fp32')}); kernel_ms {simt_ms:.4f} bound_ms "
          f"{old_row['bound_ms']:.4f} ({old_row['bound_by']}, fp32 units), share "
          f"{old_row['bound_share']:.3f}; against fp64: max abs err "
          f"{old_row['fp64_max_abs_err']:.3g}, mean relative bias {old_row['fp64_bias']:.3g}")
    print(f"kernel swa_attention_tf32 split A/B S=8192 fp32, lo = x - hi read by the "
          f"tensor cores as TF32 (the shipped build) against lo rounded to nearest "
          f"(-DSWA_TF32_RNA_LO, mix.cu's split; max abs err vs plain "
          f"{close['rna_lo'][1]:.3g}): kernel_ms {ms:.4f} vs {rna_lo_ms:.4f}; "
          f"against fp64 max abs err {row['fp64_max_abs_err']:.4g} vs "
          f"{row['fp64_max_abs_err_rna_lo']:.4g} (ratio "
          f"{row['fp64_max_abs_err'] / row['fp64_max_abs_err_rna_lo']:.3f}), mean "
          f"relative bias {row['fp64_bias']:.4g} vs {row['fp64_bias_rna_lo']:.4g}")

    # S=32768, the prefill's length: two heads against the plain version
    q, k, v = _swa_inputs(torch, dev, gen, 32768, torch.float32)
    got = swa_ops.swa_attention(q, k, v, window=win)
    for hh in (0, h - 1):
        gg = hh // (h // g)
        ref = swa_ref(q[:, :, hh:hh + 1].transpose(1, 2), k[:, :, gg:gg + 1].transpose(1, 2),
                      v[:, :, gg:gg + 1].transpose(1, 2), window=win).transpose(1, 2)
        ok, err, rel, _ = swa_close(torch, got[:, :, hh:hh + 1], ref, "fp32")
        check(ok, f"swa_attention_tf32 S=32768 fp32 head {hh}: outside "
                  f"{swa_tol_text('fp32')} (max abs err {err:.3g}, rel L2 {rel:.3g})")
        del ref
    del got
    row["ms_s32768"] = time_ms(torch, lambda: swa_ops.swa_attention(q, k, v, window=win),
                               reps=5, warmup=1)
    old_row["ms_s32768"] = time_ms(torch, _simt_call(torch, dev, q, k, v,
                                                     "repro_swa_attention_f32"),
                                   reps=3, warmup=1)
    # no library time: SDPA in fp32 with a mask takes its math path, which
    # builds the (H, S, S) scores, 192 GiB here
    for name, r in rows.items():
        r["library_ms_s32768"] = None
        r["bound_ms_s32768"], _ = swa_bound(b, 32768, h, g, dh, win, 4, *peaks[name])
    row["bound_ms_fp32_units_s32768"] = old_row["bound_ms_s32768"]
    print(f"kernel swa_attention_tf32 B={b} H={h} G={g} dh={dh} window={win} fp32: "
          f"S=32768 kernel_ms {row['ms_s32768']:.4f} library_ms not measurable (SDPA's "
          f"fp32 masked path builds 192 GiB of scores) bound_ms "
          f"{row['bound_ms_s32768']:.4f} (3 TF32 products, share "
          f"{row['bound_ms_s32768'] / row['ms_s32768']:.3f}), on the fp32 units "
          f"{old_row['bound_ms_s32768']:.4f} (share "
          f"{old_row['bound_ms_s32768'] / row['ms_s32768']:.3f}); the SIMT kernel "
          f"{old_row['ms_s32768']:.4f} ms; plain_ms not measurable (206 GB of "
          f"scores); card right after (SM clock, power, temperature): {card_state()}")
    _swa_profile(torch, dev, "swa_attention_tf32", variant_libs["swa_attention_tf32"],
                 q, k, v, row["ms_s32768"])
    del q, k, v
    return rows


def _swa_rows(torch, dev, gen, profile_lib: Path) -> dict[str, dict]:
    """The bf16 tensor-core kernel at starcoder2-15b's heads (B=1, H=48,
    G=4, dh=128, window 4096) against its plain version at S=8192, timed
    beside the plain version and one library call
    (``F.scaled_dot_product_attention`` with a boolean mask and GQA) at
    S=8192 and at S=32768, the prefill's length (bf16 tensor-core bound),
    with the SIMT kernel's bf16 entry point (the earlier design of the bf16
    path) timed in the same run and the tensor-core kernel's phase
    profile."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa.ref import swa_ref

    b, h, g, dh, win = SWA_SHAPE
    route = "swa_attention_tc"
    q, k, v = _swa_inputs(torch, dev, gen, 8192, torch.bfloat16)
    before = dict(swa_ops.LAUNCHES)
    got = swa_ops.swa_attention(q, k, v, window=win)
    check(swa_ops.LAUNCHES == {**before, route: before[route] + 1},
          f"swa_attention bf16: the call did not launch {route} alone")
    ref = swa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  window=win).transpose(1, 2)
    ok, err, rel, scale = swa_close(torch, got, ref, "bf16")
    check(ok, f"{route} S=8192 bf16: outside {swa_tol_text('bf16')} "
              f"(max abs err {err:.3g}, rel L2 {rel:.3g})")
    del got, ref
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(torch, lambda: swa_ops.swa_attention(q, k, v, window=win),
                 reps=10, warmup=2)
    plain = time_ms(torch, lambda: swa_ref(qt, kt, vt, window=win), reps=5, warmup=1)
    lib = time_ms(torch, _swa_library_call(torch, dev, qt, kt, vt), reps=5, warmup=1)
    b_ms, b_by = swa_bound(b, 8192, h, g, dh, win, 2)
    row = {"name": route, "shape": [b, 8192, h, g, dh], "window": win,
           "dtype": "bf16", "max_abs_err": err, "rel_l2": rel,
           "tolerance": swa_tol_text("bf16"), "ms": ms, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
           "bound_share": b_ms / ms}
    print(f"kernel {route} S=8192 bf16: max abs err {err:.3g}, rel L2 {rel:.3g}, "
          f"output std {scale:.3g} (tol {swa_tol_text('bf16')}); kernel_ms {ms:.4f} "
          f"plain_ms {plain:.4f} library_ms {lib:.4f} (F.scaled_dot_product_attention, "
          f"bool mask, enable_gqa) bound_ms {b_ms:.4f} ({b_by}, bf16 peak), share of "
          f"the bound {b_ms / ms:.3f}")
    del qt, kt, vt

    # the earlier design of the bf16 path, on the same inputs: the SIMT
    # kernel's bf16 entry point, called directly (no launch counted)
    row["simt_bf16_ms"] = time_ms(
        torch, _simt_call(torch, dev, q, k, v, "repro_swa_attention_bf16"), reps=5, warmup=1)
    del q, k, v

    q, k, v = _swa_inputs(torch, dev, gen, 32768, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row["ms_s32768"] = time_ms(
        torch, lambda: swa_ops.swa_attention(q, k, v, window=win), reps=10, warmup=2)
    row["library_ms_s32768"] = time_ms(torch, _swa_library_call(torch, dev, qt, kt, vt),
                                       reps=3, warmup=1)
    del qt, kt, vt
    row["bound_ms_s32768"], _ = swa_bound(b, 32768, h, g, dh, win, 2)
    row["bound_share_s32768"] = row["bound_ms_s32768"] / row["ms_s32768"]
    print(f"kernel swa_attention_tc B={b} H={h} G={g} dh={dh} window={win} bf16: "
          f"S=32768 kernel_ms {row['ms_s32768']:.4f} library_ms "
          f"{row['library_ms_s32768']:.4f} bound_ms {row['bound_ms_s32768']:.4f} "
          f"(operations), share of the bound {row['bound_share_s32768']:.3f}; "
          f"S=8192 kernel_ms {row['ms']:.4f}, share {row['bound_share']:.3f}, "
          f"the SIMT kernel's bf16 entry {row['simt_bf16_ms']:.4f} ms; card "
          f"right after (SM clock, power, temperature): {card_state()}")
    _swa_profile(torch, dev, route, profile_lib, q, k, v, row["ms_s32768"])
    del q, k, v
    return {route: row}


# the cycle-profile builds of the SWA kernels: source, macro, entry point,
# counter reader, and the phases of the tile loop in the order of the
# kernel's Phase enum
PROFILE_BUILDS = {
    "swa_attention_tc": ("swa_attention_tc.cu", "SWA_TC_PROFILE",
                         "repro_swa_attention_tc_bf16", "repro_swa_tc_profile",
                         ("wait_q", "wait_k", "s_gemm", "softmax", "wait_v", "pv_gemm",
                          "epilogue")),
    "swa_attention_tf32": ("swa_attention_tf32.cu", "SWA_TF32_PROFILE",
                           "repro_swa_attention_tf32_f32", "repro_swa_tf32_profile",
                           ("barriers", "s_issue", "split", "s_wait", "softmax", "pv_issue",
                            "pv_wait", "copy", "epilogue")),
}


# every build of an SWA kernel's source with a macro, a library of its own
# each: the profile builds, and the split-TF32 kernel with lo rounded to
# nearest (phase 2's A/B of the split)
VARIANT_BUILDS = {**{name: (source, macro) for name, (source, macro, *_)
                     in PROFILE_BUILDS.items()},
                  "swa_attention_tf32_rna_lo": ("swa_attention_tf32.cu", "SWA_TF32_RNA_LO")}


def start_variant_builds() -> dict[str, tuple[subprocess.Popen, Path]]:
    """Starts nvcc on each of ``VARIANT_BUILDS`` (built beside the kernels'
    library)."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, macro) in VARIANT_BUILDS.items():
        lib = build.BUILD_DIR / f"{name}_variant.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-D{macro}", "-shared",
               str(build.CSRC / source), "-o", str(lib)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    return procs


def _swa_profile(torch, dev, name: str, path: Path, q, k, v, ms: float) -> None:
    """Runs the profile build of SWA kernel ``name`` on the inputs and prints
    the share of its warpgroups' clock cycles spent in each phase of the
    tile loop, with the cycles per KV tile (``ms``: the kernel's time per
    call without the profile)."""
    import ctypes

    _, _, entry, reader, phases = PROFILE_BUILDS[name]
    fn = _variant_entry(path, entry)
    read = getattr(ctypes.CDLL(str(path)), reader)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counters = (ctypes.c_ulonglong * (len(phases) + 2))()
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                 k.shape[2], dh, SWA_SHAPE[4], stream)
        check(err == 0, f"{name} profile build: launch error {err}")

    prof_ms = time_ms(torch, launch, reps=3, warmup=1)
    check(read(counters) == 0, "profile counters unreadable")
    launch()
    torch.cuda.synchronize()
    check(read(counters) == 0, "profile counters unreadable")
    cycles = list(counters[:len(phases)])
    tiles, wgs = counters[len(phases)], counters[len(phases) + 1]
    total = sum(cycles)
    print(f"{name} profile S={s} (build with -D{PROFILE_BUILDS[name][1]}, {prof_ms:.4f} "
          f"ms per call against {ms:.4f} without): {tiles / wgs:.2f} KV tiles per "
          f"warpgroup, {total / tiles:.0f} cycles per tile; share of its cycles (cycles "
          f"per tile): " + ", ".join(f"{p} {c / total:.3f} ({c / tiles:.0f})"
                                     for p, c in zip(phases, cycles)))
    del out


# ---------------------------------------------------------------------------
# phases 3-6: the port's paths end to end
# ---------------------------------------------------------------------------

def _compare(res, want: dict, label: str, fields_int=INT_FIELDS,
             fields_float=FLOAT_FIELDS) -> str:
    """Integer channels equal, float channels within RTOL / ATOL; returns
    each float channel's worst deviation as a share of its allowance
    (|got - ref| / (ATOL + RTOL |ref|); 1 is the limit)."""
    used = {}
    for f in fields_int:
        got = np.asarray(getattr(res, f), np.int64)
        ref = np.asarray(want[f], np.int64)
        check(got.shape == ref.shape and np.array_equal(got, ref),
              f"{label}: integer channel {f} differs")
    for f in fields_float:
        got = np.asarray(getattr(res, f), np.float64)
        ref = np.asarray(want[f], np.float64)
        ok = got.shape == ref.shape and np.allclose(got, ref, rtol=RTOL, atol=ATOL)
        if got.shape == ref.shape:
            used[f] = float(np.max(np.abs(got - ref) / (ATOL + RTOL * np.abs(ref)),
                                   initial=0.0))
        check(ok, f"{label}: float channel {f} outside rtol {RTOL} / atol {ATOL} "
                  f"(worst share of the allowance {used.get(f, float('nan')):.3g})")
    return ", ".join(f"{f} {u:.3g}" for f, u in used.items())


GOLDEN = {"svm": "efhc_m8_trajectory.json", "mlp_blocks": "efhc_m8_mlp_blocks.json"}


def phase_golden(dev, model: str = "svm") -> None:
    """The m=8 golden configuration of ``model`` (``GOLDEN``) under the two
    kernel impls, against its artifact."""
    from repro_torch.core.topology import make_process
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.fl.simulator import SimConfig, run

    want = json.loads((ROOT / "tests" / "golden" / GOLDEN[model]).read_text())
    for impl in ("pallas", "sparse_pallas"):
        x, y = image_dataset(600, seed=0, dim=want["dim"])
        parts = by_labels(y, want["m"], 3)
        graph = make_process(want["m"], "rgg", time_varying="edge_dropout",
                             drop=0.3, seed=0)
        sim = SimConfig(m=want["m"], iters=want["iters"], dim=want["dim"],
                        batch=8, r=50.0, seed=0, mix_impl=impl, model=model)
        res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
                  None, eval_every=5, device=dev)
        check(np.allclose(res.bandwidths, want["bandwidths"], rtol=1e-5),
              f"golden {model} {impl}: bandwidth draw differs")
        check(res.model_dim == want.get("model_dim", res.model_dim),
              f"golden {model} {impl}: D={res.model_dim}")
        used = _compare(res, want, f"golden {model} {impl}")
        print(f"golden m=8 {model} {impl}: v/comm_count/deg exact, loss/tx_time/"
              f"util/consensus_err within rtol {RTOL} / atol {ATOL}; worst share "
              f"of the allowance: {used}")


def _finite(res, label: str) -> None:
    for f in ("loss", "acc", "tx_time", "util", "consensus_err"):
        check(bool(np.isfinite(getattr(res, f)).all()),
              f"{label}: channel {f} is not finite")


def _launch_counts() -> tuple[dict[str, int], ...]:
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.trigger import ops as trigger_ops
    return trigger_ops.LAUNCHES, mixing_ops.LAUNCHES, swa_ops.LAUNCHES


def _reset_launches() -> None:
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def _launches() -> dict[str, int]:
    return {k: n for counts in _launch_counts() for k, n in counts.items()}


class TriggerLog:
    """While active, keeps the inputs of every broadcast decision the EF-HC
    step takes (references only: no device work is added), so that each
    decision's margin dev / threshold - 1 can be read after the run."""

    def __enter__(self):
        from repro_torch.core import triggers
        self._mod, self._real, self.calls = triggers, triggers.broadcast_events, []

        def logged(cfg, **kw):
            self.calls.append((cfg, kw["dev"], kw["bandwidths"], kw["gamma_k"],
                               kw.get("cells")))
            return self._real(cfg, **kw)

        triggers.broadcast_events = logged
        return self

    def __exit__(self, *exc) -> None:
        self._mod.broadcast_events = self._real

    def margins(self) -> np.ndarray:
        """(T, C, m) dev / threshold - 1, in float64, of each decision of
        each cell under the cell's policy (inf or NaN where the policy
        has no threshold: zero and gossip)."""
        import dataclasses

        import torch

        def thresholds(cfg, bw, gamma, cells):
            names = [cfg.policy] * bw.shape[0] if cells is None else cells.names
            return torch.stack([self._mod.thresholds(dataclasses.replace(cfg, policy=n),
                                                     bw[i], gamma)
                                for i, n in enumerate(names)])

        return torch.stack([d.double() / thresholds(c, b, g, cells).double() - 1
                            for c, d, b, g, cells in self.calls]).cpu().numpy()


def _closest(mk: np.ndarray) -> float:
    """The closest decision |dev / threshold - 1| among the finite margins."""
    fin = np.abs(mk[np.isfinite(mk)])
    return float(fin.min()) if fin.size else float("nan")


def _twin(label: str, res, log: TriggerLog, plain, plain_log: TriggerLog,
          impl: str, fields=INT_FIELDS) -> None:
    """The kernel run's integer channels (``fields``) against the run of
    the plain ``impl`` on the card: equal, or the first flips with their
    margins."""
    differ = [f for f in fields
              if not np.array_equal(getattr(res, f), getattr(plain, f))]
    mk = log.margins()[:, 0]  # a solo run is one cell
    if not differ:
        print(f"{label} kernel vs plain ({impl}) on the card: {', '.join(fields)} "
              f"equal over {mk.shape[0]} iterations x {mk.shape[1]} devices; "
              f"closest decision |dev / threshold - 1| {_closest(mk):.3g}")
        return
    mp = plain_log.margins()[:, 0]
    flips = [(int(k), int(i), float(mk[k, i]), float(mp[k, i]))
             for k, i in np.argwhere(np.asarray(res.v) != np.asarray(plain.v))[:5]]
    check(False, f"{label}: the kernel and plain ({impl}) runs differ in {differ}; "
                 f"first v flips (iteration, device, margin kernel run, margin "
                 f"plain run): {flips}")


class StepTwin:
    """While active, each EF-HC step of a kernel run (``mix_impl``
    "pallas") is taken once more from the same state with the plain
    ``dense`` mix, and the two steps are compared at every iteration of
    the full-size run, without the trajectories' drift: v, comm_count and
    deg equal; the ``mix`` kernel's output against ``consensus.mix_dense``
    of the same P and W within RTOL / ATOL, and against the fp64 product
    within ``MIX_FP64_ERR_VS_LIB`` x the plain mix's error or an fp32 ulp
    of the largest output, whichever is larger (``mix_err``:
    the largest of each, kernel vs plain, kernel vs fp64, plain vs fp64);
    the step's loss and consensus error (both computed after the mix)
    within RTOL / ATOL.  ``differ`` lists the (iteration, channels) that
    disagree.  The new models are compared as well and reported, not
    gated (``w_gap``: each step's largest difference and the number of
    entries outside RTOL / ATOL): a relu unit that changes sign on a
    rounding difference changes that step's gradient by a finite
    amount."""

    def __init__(self):
        self.steps, self.differ, self.mix_err, self.w_gap = 0, [], [0.0] * 3, []

    def __enter__(self):
        import dataclasses

        import torch

        from repro_torch.core import consensus, efhc
        from repro_torch.kernels.mixing import ops as mixing_ops
        self._mod, self._real = efhc, efhc.step
        self._ops, self._mix = mixing_ops, mixing_ops.mix
        mixed = []

        def held_mix(p, w):
            out = self._mix(p, w)
            plain = consensus.mix_dense(p, w)
            exact = p.double() @ w.double()
            errs = [float((a - b).abs().max())
                    for a, b in ((out, plain), (out, exact), (plain, exact))]
            # an fp32 ulp of the largest output, where the plain mix is exact
            ulp = float(exact.abs().max()) * 2.0 ** -23
            mixed.append((errs, bool(torch.allclose(out, plain, rtol=RTOL, atol=ATOL))
                          and errs[1] <= max(MIX_FP64_ERR_VS_LIB * errs[2], ulp)))
            return out

        def close(a, b) -> bool:
            return bool(torch.allclose(a, b, rtol=RTOL, atol=ATOL))

        def twinned(cfg, graph, state, **kw):
            mixed.clear()
            mixing_ops.mix = held_mix
            try:
                new, aux = self._real(cfg, graph, state, **kw)
            finally:
                mixing_ops.mix = self._mix
            plain_new, plain = self._real(dataclasses.replace(cfg, mix_impl="dense"),
                                          graph, state, **kw)
            bad = [f for f in INT_FIELDS
                   if not bool((getattr(aux, f) == getattr(plain, f)).all())]
            bad += [f for f in ("loss", "consensus_err")
                    if not close(getattr(aux, f), getattr(plain, f))]
            if len(mixed) != 1 or not mixed[0][1]:
                bad.append(f"mix ({len(mixed)} launches, max abs err "
                           f"{[e for e, _ in mixed]})")
            for errs, _ in mixed:
                self.mix_err = [max(a, b) for a, b in zip(self.mix_err, errs)]
            w, wp = efhc.flatten_stack(new.w, lead=2), efhc.flatten_stack(plain_new.w, lead=2)
            outside = ~torch.isclose(w, wp, rtol=RTOL, atol=ATOL)
            self.w_gap.append((float((w - wp).abs().max()), int(outside.sum())))
            if bad:
                self.differ.append((self.steps, bad))
            self.steps += 1
            return new, aux

        efhc.step = twinned
        return self

    def __exit__(self, *exc) -> None:
        self._mod.step = self._real
        self._ops.mix = self._mix


def _sweep_twin(label: str, res, log: TriggerLog, plain, plain_log: TriggerLog,
                impl: str, fields=INT_FIELDS) -> None:
    """``_twin`` for a sweep: every cell's integer channels against the
    same cell of the sweep of the plain ``impl`` on the card."""
    differ = [f for f in fields
              if not np.array_equal(getattr(res, f), getattr(plain, f))]
    mk = log.margins()  # (T, C, m), cells in (seed, policy) order
    S, P = len(res.seeds), len(res.policies)
    if not differ:
        print(f"{label} kernel vs plain ({impl}) on the card: {', '.join(fields)} "
              f"equal in all {S * P} cells over {mk.shape[0]} iterations x "
              f"{mk.shape[2]} devices; closest decision |dev / threshold - 1| "
              f"{_closest(mk):.3g}")
        return
    mp = plain_log.margins()
    flips = [(res.seeds[s], res.policies[p], int(k), int(i),
              float(mk[k, s * P + p, i]), float(mp[k, s * P + p, i]))
             for s, p, k, i in np.argwhere(np.asarray(res.v) != np.asarray(plain.v))[:5]]
    check(False, f"{label}: the kernel and plain ({impl}) sweeps differ in {differ}; "
                 f"first v flips (seed, policy, iteration, device, margin kernel "
                 f"run, margin plain run): {flips}")


def phase_paper(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                T: int = 20, twin: bool = False) -> dict[str, int]:
    """The paper cell; with ``twin``, then again with the plain dense mix
    (``mix_impl="dense"``), its integer channels required equal."""
    import dataclasses

    from repro_torch import api

    spec = api.ScenarioSpec(m=m, model="mlp", dim=dim, n_train=n_train,
                            iters=T, eval_every=10, mix_impl="pallas",
                            trace="summary")
    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
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
    if twin:
        with TriggerLog() as plain_log:
            plain = api.simulate(dataclasses.replace(spec, mix_impl="dense"),
                                 device=dev)
        _twin("paper", res, log, plain, plain_log, "dense")
    return launches, res


GATHER_ROUTES = ("mix_sparse", "mix_sparse_wide", "mix_sparse_direct")
# 5f's dynamics knobs (the fleet dynamics cell and 5h's large sharded cell)
FLEET_DYNAMICS = dict(churn_rate=0.05, flap_rate=0.1, crash_rate=0.02, warm_start=True,
                      watchdog_window=8)


def _fleet_inputs(m: int, dim: int, radius: float | None = None):
    """Phase 5's data, eval set and rgg fabric at m devices (radius
    ``fleet_radius(m)`` unless given), edge dropout 0.3."""
    from repro_torch.core.topology import fleet_radius, make_process
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset

    x, y = image_dataset(max(4000, 4 * m), seed=0, dim=dim)
    xt, yt = image_dataset(800, seed=1, dim=dim)
    graph = make_process(m, "rgg", radius=radius or fleet_radius(m),
                         time_varying="edge_dropout", drop=0.3, seed=0)
    return x, y, by_labels(y, m, 3), xt, yt, graph


def phase_fleet(dev, m: int = 4096, dim: int = 784, T: int = 20,
                twin: bool = False, radius: float | None = None,
                routes: tuple[str, ...] = ("mix_sparse",)) -> dict[str, int]:
    """The fleet cell (rgg at ``fleet_radius(m)``: the 128-column tier), or
    with ``radius`` a dense fabric (the wide tier, and at m=4096 r=0.4 the
    direct kernel for the rows no wide slab holds): each of ``routes``
    launched once an iteration and no other gather-mix kernel; with
    ``twin``, then again with the plain slot loop (``mix_impl="sparse"``,
    the kernels' arithmetic), its integer channels required equal."""
    import dataclasses

    from repro_torch.data.loader import FederatedBatches
    from repro_torch.fl.simulator import SimConfig, make_eval_fn, run

    x, y, parts, xt, yt, graph = _fleet_inputs(m, dim, radius)
    label = "fleet" if radius is None else f"dense fabric (rgg r={radius})"
    sim = SimConfig(m=m, iters=T, dim=dim, r=50.0, trace="summary",
                    mix_impl="sparse_pallas")
    eval_fn = make_eval_fn(sim, xt, yt)
    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
        res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
                  eval_fn, eval_every=20, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    want = {k: T if k in routes else 0 for k in GATHER_ROUTES}
    check(all(launches[k] == n for k, n in want.items()),
          f"{label} path: expected launches {want}, got {launches}")
    _finite(res, f"{label} path")
    print(f"{label} path m={m} svm D={res.model_dim} sparse_pallas T={T}: "
          f"launches {launches}; first step {res.timing['first_step_ms']:.2f} "
          f"ms, {res.timing['ms_per_step']:.3f} ms/step after it; wall "
          f"{wall:.2f} s with staging; final acc {res.acc[-1]:.4f}; mean "
          f"degree {res.deg.mean():.2f}")
    if twin:
        with TriggerLog() as plain_log:
            plain = run(dataclasses.replace(sim, mix_impl="sparse"), graph,
                        FederatedBatches(x, y, parts, sim.batch, seed=2), eval_fn,
                        eval_every=20, device=dev)
        _twin(label, res, log, plain, plain_log, "sparse")
    return launches, res


SWEEP_SEEDS = (0, 1)  # x the four policies: 8 cells


def phase_sweep(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                T: int = 20, twin: bool = False, solo: bool = False):
    """The paper sweep: ``api.sweep`` of the paper cell over seeds (0, 1)
    and the four policies, 8 cells in one batched run, each kernel
    launched once an iteration for all cells; with ``twin``, then again
    with the plain dense mix, every cell's integer channels required
    equal; with ``solo``, each cell against ``api.simulate`` of its (seed,
    policy) on the card (integer channels equal, floats within RTOL /
    ATOL), and the sweep's ms/iteration beside 8 x the solo runs' mean."""
    import dataclasses

    from repro_torch import api

    spec = api.ScenarioSpec(m=m, model="mlp", dim=dim, n_train=n_train,
                            iters=T, eval_every=10, mix_impl="pallas",
                            trace="summary")
    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
        res = api.sweep(spec, seeds=SWEEP_SEEDS, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    cells = len(res.seeds) * len(res.policies)
    check({k: n for k, n in launches.items() if n} == {"trigger_sq": T, "mix": T},
          f"paper sweep: expected {T} trigger_sq and {T} mix launches for "
          f"{cells} cells, got {launches}")
    check(res.model_dim == (dim + 1) * 64 + 65 * 10, f"paper sweep: D={res.model_dim}")
    _finite(res, "paper sweep")
    print(f"paper sweep m={m} mlp D={res.model_dim} pallas T={T}, seeds "
          f"{res.seeds} x policies {res.policies} ({cells} cells): launches "
          f"{launches}; first step {res.timing['first_step_ms']:.2f} ms, "
          f"{res.timing['ms_per_step']:.3f} ms/iteration after it for all cells; "
          f"wall {wall:.2f} s with staging; final acc per cell "
          f"{np.round(res.acc[..., -1].ravel(), 4).tolist()}; trigger rate per "
          f"policy {np.round(res.v.mean(axis=(0, 2, 3)), 4).tolist()}")
    if twin:
        with TriggerLog() as plain_log:
            plain = api.sweep(dataclasses.replace(spec, mix_impl="dense"),
                              seeds=SWEEP_SEEDS, device=dev)
        _sweep_twin("paper sweep", res, log, plain, plain_log, "dense")
        del plain
    if solo:
        solo_ms, used = [], {}
        for s in res.seeds:
            for pol in res.policies:
                one = api.simulate(dataclasses.replace(spec, policy=pol), seed=s,
                                   device=dev)
                used[(s, pol)] = _compare(
                    res.result(s, pol), {f: getattr(one, f) for f in (
                        *INT_FIELDS, *FLOAT_FIELDS, "acc")},
                    f"paper sweep cell (seed {s}, {pol}) vs its solo run",
                    fields_float=(*FLOAT_FIELDS, "acc"))
                solo_ms.append(one.timing["ms_per_step"])
        solo_mean = statistics.mean(solo_ms)
        print(f"paper sweep: every cell against its solo api.simulate run on the "
              f"card: integer channels equal, float channels within rtol {RTOL} / "
              f"atol {ATOL}; worst shares of the allowance: "
              + "; ".join(f"{s}/{p}: {u}" for (s, p), u in used.items()))
        print(f"paper sweep: {res.timing['ms_per_step']:.3f} ms/iteration for "
              f"{cells} cells against {cells} x solo {cells * solo_mean:.3f} ms "
              f"(solo mean {solo_mean:.3f} ms/iteration over the {cells} runs, "
              f"{min(solo_ms):.3f}-{max(solo_ms):.3f}); ratio "
              f"{res.timing['ms_per_step'] / (cells * solo_mean):.3f}")
    return launches, res


def phase_fleet_sweep(dev, m: int = 4096, dim: int = 784, T: int = 20,
                      twin: bool = False):
    """The fleet sweep: ``run_sweep`` of the fleet cell (rgg at
    ``fleet_radius(m)`` with edge dropout, svm, ``mix_impl=
    "sparse_pallas"``) over seeds (0, 1) and the four policies: one plan
    and one ``mix_sparse`` launch an iteration for all 8 cells; with
    ``twin``, then with the plain slot loop (``mix_impl="sparse"``), every
    cell's integer channels required equal."""
    import dataclasses

    from repro_torch.core.topology import fleet_radius, make_process
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.fl.simulator import SimConfig, make_eval_fn
    from repro_torch.fl.sweep import run_sweep

    x, y = image_dataset(max(4000, 4 * m), seed=0, dim=dim)
    xt, yt = image_dataset(800, seed=1, dim=dim)
    parts = by_labels(y, m, 3)
    graph = make_process(m, "rgg", radius=fleet_radius(m),
                         time_varying="edge_dropout", drop=0.3, seed=0)
    sim = SimConfig(m=m, iters=T, dim=dim, r=50.0, trace="summary",
                    mix_impl="sparse_pallas")
    eval_fn = make_eval_fn(sim, xt, yt)

    def sweep(cfg):
        return run_sweep(cfg, graph, lambda s: FederatedBatches(x, y, parts, cfg.batch,
                                                                seed=2 + s),
                         eval_fn, seeds=SWEEP_SEEDS, eval_every=20, device=dev)

    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
        res = sweep(sim)
    launches = _launches()
    wall = time.perf_counter() - t0
    check({k: n for k, n in launches.items() if n} == {"mix_sparse": T},
          f"fleet sweep: expected {T} mix_sparse launches, got {launches}")
    _finite(res, "fleet sweep")
    print(f"fleet sweep m={m} svm D={res.model_dim} sparse_pallas T={T}, seeds "
          f"{res.seeds} x policies {res.policies}: launches {launches}; first step "
          f"{res.timing['first_step_ms']:.2f} ms, {res.timing['ms_per_step']:.3f} "
          f"ms/iteration after it for all cells; wall {wall:.2f} s with staging; "
          f"final acc per cell {np.round(res.acc[..., -1].ravel(), 4).tolist()}")
    if twin:
        with TriggerLog() as plain_log:
            plain = sweep(dataclasses.replace(sim, mix_impl="sparse"))
        _sweep_twin("fleet sweep", res, log, plain, plain_log, "sparse")
    return launches, res


# ---------------------------------------------------------------------------
# phases 5c-5d: the scenario service and the deep models
# ---------------------------------------------------------------------------

SERVICE_CELLS = 8  # the service's max_cells


def service_specs(m: int = 1024, dim: int = 784, n_train: int = 8192, T: int = 20
                  ) -> dict:
    """The service's three signatures: A the paper cell (mlp, the trigger
    and dense-mix kernels), B svm on the spec's rgg r=0.4 fabric (the
    wide gather-mix tier at m=1024), C B on another fabric."""
    import dataclasses

    from repro_torch import api

    a = api.ScenarioSpec(m=m, model="mlp", dim=dim, n_train=n_train, iters=T,
                         mix_impl="pallas", trace="summary")
    b = api.ScenarioSpec(m=m, model="svm", dim=dim, n_train=n_train, iters=T,
                         mix_impl="sparse_pallas", trace="summary")
    return {"A": a, "B": b, "C": dataclasses.replace(b, graph_seed=1)}


# one wave of interleaved requests: (signature, policy, seeds); A has 6
# cells (a bucket of 8), B and C 3 each (buckets of 4)
SERVICE_WAVE = (("A", "efhc", (0, 1)), ("B", "efhc", (0, 1)), ("C", "efhc", (0, 1)),
                ("A", "gossip", (0, 1)), ("B", "gossip", (0,)), ("C", "gossip", (0,)),
                ("A", "zero", (2,)), ("A", "global", (3,)))


def phase_service(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                  T: int = 20, solo: bool = True, waves=(0, 10)):
    """``api.serve`` on one resident ``ScenarioService`` (max_cells 8), two
    waves of ``SERVICE_WAVE`` (seeds shifted by each of ``waves``): each
    wave is one launch per signature, exactly T ``trigger_sq`` + T ``mix``
    launches for A and T ``mix_sparse_wide`` for B and C; the gather-mix
    plans are built twice over both waves (B's and C's tables); the second
    wave hits the engine and program caches; with ``solo``, every cell
    against its solo ``api.simulate`` on the card.  Returns the launch
    counts over both waves and one A launch's first result (its timing is
    the launch's)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.fl.service import _bucket
    from repro_torch.kernels.mixing import ops as mixing_ops

    specs = service_specs(m, dim, n_train, T)
    svc = api.ScenarioService(max_cells=SERVICE_CELLS, device=dev)
    plans0 = mixing_ops.PLAN_BUILDS
    total: dict[str, int] = {}
    served = []
    a_res = None
    for w, shift in enumerate(waves):
        reqs = [(sig, dataclasses.replace(specs[sig], policy=pol,
                                          seeds=tuple(s + shift for s in seeds)))
                for sig, pol, seeds in SERVICE_WAVE]
        t0 = time.perf_counter()
        _reset_launches()
        reports = api.serve([spec for _, spec in reqs], service=svc)
        launches = _launches()
        wall = time.perf_counter() - t0
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        check(all(r.ok for r in reports),
              f"service wave {w}: reports failed: "
              f"{[(r.request_id, r.error) for r in reports if not r.ok]}")
        check(not any(r.quarantined for r in reports),
              f"service wave {w}: cells quarantined: "
              f"{[(r.request_id, r.quarantined) for r in reports if r.quarantined]}")
        want = {"trigger_sq": T, "mix": T, "mix_sparse_wide": 2 * T}
        check({k: n for k, n in launches.items() if n} == want,
              f"service wave {w}: expected launches {want} (A: T trigger_sq + T mix; "
              f"B, C: T mix_sparse_wide each), got {launches}")
        by_launch: dict[int, list] = {}
        for (sig, _), rep in zip(reqs, reports):
            by_launch.setdefault(rep.launch_id, []).append((sig, rep))
        check(len(by_launch) == 3 and all(len({s for s, _ in reps}) == 1
                                         for reps in by_launch.values()),
              f"service wave {w}: expected one launch per signature, got "
              f"{ {k: [s for s, _ in v] for k, v in by_launch.items()} }")
        cells = sum(len(r.results) for r in reports)
        for lid, reps in sorted(by_launch.items()):
            sig, rep = reps[0]
            res = next(iter(rep.results.values()))
            if sig == "A" and a_res is None:
                a_res = res
            print(f"service wave {w} launch {lid} (signature {sig}, "
                  f"{specs[sig].model} {specs[sig].mix_impl}): {rep.launch_cells} cells, "
                  f"{_bucket(rep.launch_cells) - rep.launch_cells} padded; first "
                  f"step {res.timing['first_step_ms']:.2f} ms, "
                  f"{res.timing['ms_per_step']:.3f} ms/iteration after it; run_s "
                  f"{rep.run_s:.3f}, stage_s {rep.stage_s:.3f}; engine cache hit "
                  f"{rep.engine_cache_hit}, program cache hit {rep.program_cache_hit}")
        print(f"service wave {w}: {len(reports)} requests, {cells} cells in "
              f"{len(by_launch)} launches, {wall:.2f} s wall ({cells / wall:.2f} "
              f"sims/s); launches {launches}")
        if w:
            check(all(r.engine_cache_hit and r.program_cache_hit for r in reports),
                  f"service wave {w}: expected engine and program cache hits, got "
                  f"{[(r.engine_cache_hit, r.program_cache_hit) for r in reports]}")
        served += reports
    builds = mixing_ops.PLAN_BUILDS - plans0
    check(builds == 2, f"service: expected 2 gather-mix plan builds over both "
                       f"waves (B's and C's tables), got {builds}")
    print(f"service: {builds} gather-mix plan builds over {len(waves)} waves; "
          f"stats {json.dumps(svc.stats().as_dict())}")
    if solo:
        worst = 0.0
        for rep in served:
            for s, res in rep.results.items():
                one = api.simulate(rep.spec, seed=s, device=dev)
                used = _compare(res, {f: getattr(one, f) for f in (
                    *INT_FIELDS, *FLOAT_FIELDS, "acc")},
                    f"service cell (request {rep.request_id}, seed {s}) vs its solo run",
                    fields_float=(*FLOAT_FIELDS, "acc"))
                worst = max([worst] + [float(u.split()[-1]) for u in used.split(", ")])
        print(f"service: every cell against its solo api.simulate run on the card: "
              f"integer channels equal, float channels within rtol {RTOL} / atol "
              f"{ATOL}; worst share of the allowance {worst:.3g}")
    return total, a_res


class PoisonedProvider:
    """The default synthetic dataset with one appended training row of Inf
    that only device 0 can draw, among ``extra`` other rows added to its
    partition: a cell diverges only if its sampler draws that row."""

    def __init__(self, extra: int = 300):
        self.extra, self._cache = extra, {}

    def __call__(self, spec):
        import dataclasses

        from repro_torch.fl import service

        k = service.SyntheticProvider.key(spec)
        if k not in self._cache:
            ds = service._DEFAULT_PROVIDER(spec)
            n = len(ds.x)
            x = np.concatenate([ds.x, np.full((1, ds.x.shape[1]), np.inf, np.float32)])
            y = np.concatenate([ds.y, ds.y[:1]])
            parts = list(ds.parts)
            parts[0] = np.concatenate([np.asarray(parts[0]),
                                       np.arange(self.extra), [n]]).astype(np.int64)
            self._cache[k] = dataclasses.replace(ds, x=x, y=y, parts=parts)
            self.row = n
        return self._cache[k]


def phase_quarantine(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                     T: int = 20) -> None:
    """Signature A with ``PoisonedProvider``: two cells in one launch, one
    drawing the Inf row in its first T/2 iterations, one never: the first
    is quarantined, the second equals its solo run on the card."""
    import dataclasses

    from repro_torch import api
    from repro_torch.fl import service

    prov = PoisonedProvider()
    spec = service_specs(m, dim, n_train, T)["A"]
    ds = prov(spec)
    hit = miss = None
    for s in range(64):
        idx = spec.batches(s, ds).stage(T)
        per_step = (idx == prov.row).reshape(T, -1).any(1)
        if hit is None and per_step[: T // 2].any():
            hit = s
        if miss is None and not per_step.any():
            miss = s
        if hit is not None and miss is not None:
            break
    check(hit is not None and miss is not None,
          "quarantine: no poisoned and clean sampler streams among seeds 0..63")
    spec = dataclasses.replace(spec, seeds=(hit, miss))
    _reset_launches()
    rep = api.serve([spec], provider=prov, max_cells=SERVICE_CELLS, device=dev)[0]
    launches = _launches()
    check(rep.ok, f"quarantine: the report failed: {rep.error}")
    check({k: n for k, n in launches.items() if n} == {"trigger_sq": T, "mix": T},
          f"quarantine: expected {T} trigger_sq and {T} mix launches, got {launches}")
    check(rep.quarantined == (hit,) and set(rep.results) == {miss},
          f"quarantine: expected seed {hit} quarantined and {miss} served, got "
          f"{rep.quarantined} and {sorted(rep.results)}")
    solo = service.solo_run(spec, seed=miss, provider=prov, device=dev)
    used = _compare(rep.results[miss], {f: getattr(solo, f) for f in (
        *INT_FIELDS, *FLOAT_FIELDS, "acc")}, "quarantine: the clean cell vs its solo run",
        fields_float=(*FLOAT_FIELDS, "acc"))
    bad = service.solo_run(spec, seed=hit, provider=prov, device=dev)
    check(not np.isfinite(bad.loss).all(), "quarantine: the poisoned solo run stayed finite")
    print(f"quarantine m={m} signature A: seed {hit} (draws the Inf row) quarantined, "
          f"seed {miss} served beside it in one launch of {rep.launch_cells} cells; the "
          f"clean cell against its solo run: integer channels equal, floats within "
          f"rtol {RTOL} / atol {ATOL} ({used}); launches {launches}")


class TokenProvider:
    """Next-token windows (``seq`` tokens, the next one the label) over a
    seeded numpy bigram chain of ``vocab`` tokens; each device holds a
    contiguous stretch of the stream."""

    def __init__(self, m: int, seq: int = 16, vocab: int = 64, n: int = 8192,
                 seed: int = 0):
        from repro_torch.fl.service import Dataset

        rng = np.random.default_rng(seed)
        succ = rng.integers(0, vocab, size=(vocab, 4))

        def stream(length):
            pick, jump = rng.integers(0, 4, length), rng.random(length) < 0.25
            anew = rng.integers(0, vocab, length)
            out, cur = np.empty(length, np.int32), 0
            for i in range(length):
                out[i] = cur
                cur = anew[i] if jump[i] else succ[cur, pick[i]]
            return out

        def windows(tokens, stride):
            starts = np.arange(0, len(tokens) - seq, stride)
            return (np.stack([tokens[i:i + seq] for i in starts]),
                    tokens[starts + seq].astype(np.int32))

        x, y = windows(stream(2 * n + seq), 2)
        xt, yt = windows(stream(800 * seq + seq), seq)
        self.ds = Dataset(x, y, np.array_split(np.arange(len(y)), m), xt, yt)

    def __call__(self, spec):
        return self.ds


DEEP_D = {"cnn": 26698, "mlp_blocks": 37824}


class Fp64Mix:
    """While active, the plain dense mix (``consensus.mix_dense``) runs its
    product in fp64 and rounds it to fp32: a mix that differs from the
    fp32 product only in rounding, by about as much as the kernel does."""

    def __enter__(self):
        from repro_torch.core import consensus
        self._mod, self._real = consensus, consensus.mix_dense
        consensus.mix_dense = lambda p, flat: (p.double() @ flat.double()).to(flat.dtype)
        return self

    def __exit__(self, *exc) -> None:
        self._mod.mix_dense = self._real


def _parting(a, b) -> str:
    """Two whole runs side by side: the largest loss gap per iteration and
    the first v flip."""
    gap = np.abs(np.asarray(a.loss, np.float64) - b.loss).max(axis=1)
    flips = np.argwhere(np.asarray(a.v) != np.asarray(b.v))
    return (f"largest loss gap per iteration {[float(f'{g:.2g}') for g in gap]}, "
            f"first v flip (iteration, device) {flips[:1].tolist()}")


def _cnn_twin(spec, res, dev) -> None:
    """The cnn's twins, held step by step (``StepTwin``: from the same
    state, v, comm_count and deg equal, the mix kernel's output and the
    step's loss and consensus error within RTOL / ATOL).  Its whole runs
    under two mixes that differ in rounding part after a few iterations
    (PERF.md §6): the whole ``dense`` run is printed beside the
    kernel run, and beside it two plain runs, no kernel: ``delta`` (``w +
    (P w - w)``, the same product, a difference in the last rounding) and
    the dense mix in fp64 (``Fp64Mix``, a difference in the product's
    rounding, as the kernel's), ungated."""
    import dataclasses

    from repro_torch import api

    with StepTwin() as twin:
        again = api.simulate(spec, device=dev)
    check(twin.steps == spec.iters, f"cnn step twin: {twin.steps} steps twinned")
    check(not twin.differ, f"cnn step twin: the kernel and plain (dense) steps "
                           f"differ from the same state: (iteration, channels) "
                           f"{twin.differ[:5]}")
    check(all(np.array_equal(getattr(res, f), getattr(again, f)) for f in INT_FIELDS),
          "cnn: the twinned kernel run differs from the first kernel run")
    k_plain, k_exact, plain_exact = twin.mix_err
    print(f"cnn kernel vs plain (dense) on the card, step by step from the same "
          f"state: v, comm_count, deg equal, mix output within rtol {RTOL} / atol "
          f"{ATOL} of the plain mix (max abs err {k_plain:.3g}) and within "
          f"{MIX_FP64_ERR_VS_LIB} x the plain mix's error against fp64 or an ulp "
          f"of the largest output (largest: kernel {k_exact:.3g}, plain "
          f"{plain_exact:.3g}), loss and consensus error "
          f"within rtol {RTOL} / atol {ATOL}, in all {twin.steps} iterations x "
          f"{spec.m} devices; new models (ungated), largest gap and entries outside "
          f"the tolerance per iteration "
          f"{[(float(f'{g:.2g}'), n) for g, n in twin.w_gap]}")
    plain = api.simulate(dataclasses.replace(spec, mix_impl="dense"), device=dev)
    print(f"cnn whole runs, kernel vs plain (dense), ungated: {_parting(plain, res)}")
    delta = api.simulate(dataclasses.replace(spec, mix_impl="delta"), device=dev)
    print(f"cnn whole runs, plain (dense) vs plain (delta: w + (P w - w), the "
          f"same product), no kernel, ungated: {_parting(plain, delta)}")
    with Fp64Mix():
        exact = api.simulate(dataclasses.replace(spec, mix_impl="dense"), device=dev)
    print(f"cnn whole runs, plain (dense) vs plain (dense in fp64, rounded to "
          f"fp32), no kernel, ungated: {_parting(plain, exact)}; final acc "
          f"{plain.acc[-1]:.4f} / {exact.acc[-1]:.4f}")


def phase_deep(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
               T: int = 20, tm: int = 64, twin: bool = True) -> dict:
    """``api.simulate`` of ``cnn`` and ``mlp_blocks`` at the paper cell's
    size and of ``tiny_transformer`` at ``tm`` devices on ``TokenProvider``
    windows, each under ``mix_impl="pallas"`` (exactly T ``trigger_sq`` +
    T ``mix`` launches) and, with ``twin``, under ``mix_impl="dense"`` on
    the card, integer channels required equal.  Returns the results by
    model."""
    import dataclasses

    from repro_torch import api

    out = {}
    for model in ("cnn", "mlp_blocks", "tiny_transformer"):
        if model == "tiny_transformer":
            prov = TokenProvider(tm)
            spec = api.ScenarioSpec(m=tm, model=model, dim=16, n_classes=64,
                                    iters=T, eval_every=10, mix_impl="pallas",
                                    trace="summary")
        else:
            prov = None
            spec = api.ScenarioSpec(m=m, model=model, dim=dim, n_train=n_train,
                                    iters=T, eval_every=10, mix_impl="pallas",
                                    trace="summary")
        t0 = time.perf_counter()
        _reset_launches()
        with TriggerLog() as log:
            res = api.simulate(spec, provider=prov, device=dev)
        launches = _launches()
        wall = time.perf_counter() - t0
        check({k: n for k, n in launches.items() if n} == {"trigger_sq": T, "mix": T},
              f"{model} path: expected {T} trigger_sq and {T} mix launches, got "
              f"{launches}")
        check(res.model_dim == DEEP_D.get(model, res.model_dim), f"{model}: D={res.model_dim}")
        _finite(res, f"{model} path")
        print(f"{model} path m={spec.m} D={res.model_dim} pallas T={T}: launches "
              f"{launches}; first step {res.timing['first_step_ms']:.2f} ms, "
              f"{res.timing['ms_per_step']:.3f} ms/step after it; wall {wall:.2f} s "
              f"with staging; final acc {res.acc[-1]:.4f}; trigger rate "
              f"{res.v.mean():.4f}")
        if twin and model == "cnn":
            _cnn_twin(spec, res, dev)
        elif twin:
            with TriggerLog() as plain_log:
                plain = api.simulate(dataclasses.replace(spec, mix_impl="dense"),
                                     provider=prov, device=dev)
            _twin(model, res, log, plain, plain_log, "dense")
            del plain
        out[model] = res
    return out


# ---------------------------------------------------------------------------
# phases 5e-5g: scenario dynamics and resume
# ---------------------------------------------------------------------------

# the integer channels under scenario dynamics: the trigger channels and
# the resource, fault and watchdog ones
DYN_INT_FIELDS = INT_FIELDS + ("down_count", "exhausted_count", "fault_down_count",
                               "stale_max", "window_connected", "window_needed")
# the scripted bridge partition of the dynamics cell: [start, start + len)
PARTITION = (8, 4)


def dynamics_knobs(model_dim: int) -> dict:
    """Every resource, fault and watchdog mechanism on: the budget holds 4
    broadcasts of the model, so devices run out within 20 iterations."""
    from repro_torch.core.accounting import model_bytes

    return dict(churn_rate=0.05, straggle_rate=0.1, bw_walk=0.1,
                budget_bytes=float(4 * model_bytes(model_dim)),
                cluster_fail_rate=0.05, flap_rate=0.1, crash_rate=0.02,
                warm_start=True, partition_start=PARTITION[0],
                partition_len=PARTITION[1], watchdog_window=4)


def dynamics_spec(m: int = 1024, dim: int = 784, n_train: int = 8192, T: int = 20,
                  **kw):
    """The paper cell (mlp, rgg r=0.4 with edge dropout 0.3, ``pallas``)
    with ``dynamics_knobs``."""
    from repro_torch import api

    return api.ScenarioSpec(m=m, model="mlp", dim=dim, n_train=n_train, iters=T,
                            eval_every=10, mix_impl="pallas", trace="summary",
                            **dynamics_knobs((dim + 1) * 64 + 65 * 10), **kw)


def _mechanisms(res, label: str, all_knobs: bool = True) -> str:
    """Each mechanism at work at some iteration: a non-zero count of down
    and fault-silenced devices and of staleness, and with ``all_knobs``
    (the budget and the scripted partition on) of exhausted devices and
    the watchdog flagging a window inside the partition."""
    counts = {f: int(np.max(getattr(res, f))) for f in (
        "down_count", "exhausted_count", "fault_down_count", "stale_max")}
    want = counts if all_knobs else {k: v for k, v in counts.items()
                                     if k != "exhausted_count"}
    check(all(v > 0 for v in want.values()),
          f"{label}: a dynamics mechanism never acted: largest counts {counts}")
    inside = np.asarray(res.window_connected[PARTITION[0]:sum(PARTITION)])
    if all_knobs:
        check(not inside.all(), f"{label}: the watchdog flagged no window inside "
                                f"the scripted partition {PARTITION}")
    return (f"largest counts {counts}; window_connected "
            f"{np.asarray(res.window_connected).astype(int).tolist()}; "
            f"window_needed max {int(np.max(res.window_needed))}")


def phase_dynamics(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                   T: int = 20, twin: bool = False, sweep: bool = False,
                   checks: bool = True):
    """5e: the paper cell with every dynamics mechanism on
    (``dynamics_spec``) through ``api.simulate``: exactly T ``trigger_sq``
    and T ``mix`` launches; with ``checks`` each mechanism at work; with
    ``twin`` its plain ``dense`` twin with every integer channel equal;
    with ``sweep`` the seeds (0, 1) x four policies grid in one batched run
    (T launches of each kernel for the 8 cells, each cell's adjacency its
    own), every cell against its solo card run."""
    import dataclasses

    from repro_torch import api

    spec = dynamics_spec(m, dim, n_train, T)
    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
        res = api.simulate(spec, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    check({k: n for k, n in launches.items() if n} == {"trigger_sq": T, "mix": T},
          f"paper dynamics: expected {T} trigger_sq and {T} mix launches, got "
          f"{launches}")
    _finite(res, "paper dynamics")
    seen = _mechanisms(res, "paper dynamics") if checks else "not checked"
    print(f"paper dynamics m={m} mlp D={res.model_dim} pallas T={T} (budget "
          f"{spec.budget_bytes:.0f} bytes): launches {launches}; first step "
          f"{res.timing['first_step_ms']:.2f} ms, {res.timing['ms_per_step']:.3f} "
          f"ms/step after it; wall {wall:.2f} s with staging; final acc "
          f"{res.acc[-1]:.4f}; trigger rate {res.v.mean():.4f}; {seen}")
    if twin:
        with TriggerLog() as plain_log:
            plain = api.simulate(dataclasses.replace(spec, mix_impl="dense"),
                                 device=dev)
        _twin("paper dynamics", res, log, plain, plain_log, "dense",
              fields=DYN_INT_FIELDS)
        del plain
    if sweep:
        _reset_launches()
        grid = api.sweep(spec, seeds=SWEEP_SEEDS, device=dev)
        got = _launches()
        cells = len(grid.seeds) * len(grid.policies)
        check({k: n for k, n in got.items() if n} == {"trigger_sq": T, "mix": T},
              f"paper dynamics sweep: expected {T} trigger_sq and {T} mix launches "
              f"for {cells} cells, got {got}")
        used = {}
        for s in grid.seeds:
            for pol in grid.policies:
                one = api.simulate(dataclasses.replace(spec, policy=pol), seed=s,
                                   device=dev)
                used[(s, pol)] = _compare(
                    grid.result(s, pol), {f: getattr(one, f) for f in (
                        *DYN_INT_FIELDS, *FLOAT_FIELDS, "acc")},
                    f"paper dynamics sweep cell (seed {s}, {pol}) vs its solo run",
                    fields_int=DYN_INT_FIELDS, fields_float=(*FLOAT_FIELDS, "acc"))
        print(f"paper dynamics sweep, seeds {grid.seeds} x policies {grid.policies} "
              f"({cells} cells): launches {got}; {grid.timing['ms_per_step']:.3f} "
              f"ms/iteration for all cells; largest exhausted count per policy "
              f"{grid.exhausted_count.max(axis=(0, 2)).tolist()}; every cell against "
              f"its solo api.simulate run on the card: integer channels equal, "
              f"float channels within rtol {RTOL} / atol {ATOL}; worst shares of "
              f"the allowance: " + "; ".join(f"{s}/{p}: {u}" for (s, p), u in used.items()))
        del grid
    return launches, res


def phase_fleet_dynamics(dev, m: int = 4096, dim: int = 784, T: int = 20,
                         twin: bool = False, checks: bool = True):
    """5f: the fleet cell (svm, rgg at ``fleet_radius(m)``,
    ``sparse_pallas``) with churn, flapping links, crashes with warm start
    and the watchdog (window 8) through ``simulator.run``: exactly T
    ``mix_sparse`` launches (the warm start's neighbor sum is the plain
    ELL slot loop, not a second launch), at most one gather-mix plan built
    (the shared table's: the per-cell masks change only its weights); with
    ``twin`` the plain ``sparse`` twin, every integer channel equal."""
    import dataclasses

    from repro_torch.data.loader import FederatedBatches
    from repro_torch.fl.simulator import SimConfig, make_eval_fn, run
    from repro_torch.kernels.mixing import ops as mixing_ops

    x, y, parts, xt, yt, graph = _fleet_inputs(m, dim)
    sim = SimConfig(m=m, iters=T, dim=dim, r=50.0, trace="summary",
                    mix_impl="sparse_pallas", **FLEET_DYNAMICS)
    eval_fn = make_eval_fn(sim, xt, yt)
    plans0 = mixing_ops.PLAN_BUILDS
    t0 = time.perf_counter()
    _reset_launches()
    with TriggerLog() as log:
        res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
                  eval_fn, eval_every=20, device=dev)
    launches = _launches()
    wall = time.perf_counter() - t0
    plans = mixing_ops.PLAN_BUILDS - plans0
    check({k: n for k, n in launches.items() if n} == {"mix_sparse": T},
          f"fleet dynamics: expected {T} mix_sparse launches, got {launches}")
    check(plans <= 1, f"fleet dynamics: {plans} gather-mix plans built in one run")
    _finite(res, "fleet dynamics")
    seen = (_mechanisms(res, "fleet dynamics", all_knobs=False) if checks
            else "not checked")
    print(f"fleet dynamics m={m} svm D={res.model_dim} sparse_pallas T={T}: launches "
          f"{launches} (one mix_sparse an iteration; the warm start's sum is the "
          f"plain slot loop); {plans} plan build(s); first step "
          f"{res.timing['first_step_ms']:.2f} ms, {res.timing['ms_per_step']:.3f} "
          f"ms/step after it; wall {wall:.2f} s with staging; final acc "
          f"{res.acc[-1]:.4f}; {seen}")
    if twin:
        with TriggerLog() as plain_log:
            plain = run(dataclasses.replace(sim, mix_impl="sparse"), graph,
                        FederatedBatches(x, y, parts, sim.batch, seed=2), eval_fn,
                        eval_every=20, device=dev)
        _twin("fleet dynamics", res, log, plain, plain_log, "sparse",
              fields=DYN_INT_FIELDS)
    return launches, res


SHARDS_5H = (1, 2, 8)  # the fleet cell's shard counts in one process
EXACT_FIELDS = INT_FIELDS + ("loss", "acc", "tx_time", "util", "bandwidths")


def _sharded_run(dev, sim, data, label: str, T: int):
    """``simulator.run`` of a sharded ``sim``: exactly T ``mix_sparse``
    launches (one an iteration for all local shards, over the [own; halo]
    buffer) and no other gather-mix route; finite channels."""
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.fl.simulator import make_eval_fn, run

    x, y, parts, xt, yt, graph = data
    _reset_launches()
    t0 = time.perf_counter()
    res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
              make_eval_fn(sim, xt, yt), eval_every=20, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in _launches().items() if n}
    check(launches == {"mix_sparse": T},
          f"{label}: expected {T} mix_sparse launches and no other, got {launches}")
    _finite(res, label)
    return res, launches, wall


def _bit_equal(res, want, label: str, fields=EXACT_FIELDS) -> None:
    """Every channel of ``fields`` of ``res`` bit-equal to ``want``'s."""
    differ = [f for f in fields if not np.array_equal(getattr(res, f), getattr(want, f))]
    check(not differ, f"{label}: differs in bits on {differ}")


def _sharded_entry_points(dev, m: int = 64, shards: int = 4, T: int = 10) -> dict:
    """``api.sweep`` and ``api.serve`` of a sharded spec on the card: the
    cells run one after another, each exactly T ``mix_sparse`` launches;
    a grid cell and a served cell bit-equal to the solo ``api.simulate``
    of their (seed, policy)."""
    import dataclasses

    from repro_torch import api

    spec = api.ScenarioSpec(m=m, iters=T, eval_every=5, mix_impl="sharded",
                            shards=shards)
    solo = api.simulate(dataclasses.replace(spec, policy="gossip", seeds=(1,)),
                        device=dev)
    _reset_launches()
    grid = api.sweep(spec, seeds=(0, 1), device=dev)
    sweep = {k: n for k, n in _launches().items() if n}
    cells = len(grid.seeds) * len(grid.policies)
    _reset_launches()
    reports = api.serve([dataclasses.replace(spec, policy=p, seeds=(0, 1))
                         for p in ("efhc", "gossip")], device=dev)
    served = {k: n for k, n in _launches().items() if n}
    check(sweep == {"mix_sparse": cells * T} and served == {"mix_sparse": 4 * T},
          f"sharded sweep / serve: expected {cells * T} / {4 * T} mix_sparse launches "
          f"and no other, got {sweep} / {served}")
    check(all(r.ok for r in reports), "sharded serve: a report is not ok")
    for label, res in (("sweep cell", grid.result(1, "gossip")),
                       ("served cell", reports[1].results[1])):
        _bit_equal(res, solo, f"sharded {label} (seed 1, gossip) against its solo run",
                   (*EXACT_FIELDS, "consensus_err", *DYN_INT_FIELDS))
    print(f"sharded entry points m={m} S={shards} T={T}: api.sweep of {cells} cells "
          f"({sweep}) and api.serve of 4 cells in {len({r.launch_id for r in reports})} "
          f"launch ({served}), cells one after another; the (1, gossip) cell of each "
          f"bit-equal to its solo api.simulate on the card")
    return {f"api.sweep {cells} cells": sweep.get("mix_sparse", 0),
            "api.serve 4 cells": served.get("mix_sparse", 0)}


def phase_sharded(dev, fleet_res, m: int = 4096, dim: int = 784, T: int = 20,
                  shards=SHARDS_5H, backend: str | None = "nccl", big_m: int = HALO_M,
                  big_shards: int = HALO_SHARDS) -> dict:
    """5h: the sharded fleet engine (``mix_impl="sharded"``).

    1. The fleet cell at each of ``shards`` in one process: first the
       gather-mix wrapper on that S's [own; halo] table (``_halo_case``),
       bit-equal to its plain version; then the run, against phase 5's
       ``sparse_pallas`` run ``fleet_res``: integer channels equal, floats
       within RTOL / ATOL, and every channel but consensus_err bit-equal.
    2. With a ``backend`` (NCCL on the card; gloo rehearses it on the CPU):
       the same at S=8 under ``torch.distributed`` at world size 1 (a file
       store in a temporary directory), every exchange through the process
       group: bit-equal on every channel to the one-process S=8 run.
    3. ``api.sweep`` and ``api.serve`` of a small sharded spec
       (``_sharded_entry_points``).
    4. The fleet at ``big_m`` on ``big_shards`` shards with 5f's dynamics
       knobs: against its ``sparse_pallas`` twin every integer channel
       equal and every channel but consensus_err bit-equal; ms/iteration, device activities, busy time
       and idle share, the plan's B_max / H_max / boundary share and the
       halo bytes an iteration.
    Each run launches ``mix_sparse`` exactly T times.  Returns the
    launches of each run."""
    import dataclasses
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core.topology import shard_plan
    from repro_torch.fl.simulator import SimConfig

    data = _fleet_inputs(m, dim)
    base = SimConfig(m=m, iters=T, dim=dim, r=50.0, trace="summary", mix_impl="sharded")
    want = {f: getattr(fleet_res, f) for f in (*INT_FIELDS, *FLOAT_FIELDS, "acc")}
    out: dict = {}
    one = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for S in shards:
        label = f"sharded fleet S={S}"
        hp, _, _, _, _, hw, abs_err = _halo_case(torch, dev, gen, m, S, n=(dim + 1) * 10)
        print(f"kernel mix_sparse over the halo buffer of {label} m={m} n_src="
              f"{hw.shape[0]} (H_max {hp.h_max}): the wrapper launched the 128-column "
              f"route once, max abs err {abs_err:.3g} against the plain version (tol "
              f"exact)")
        del hw
        res, launches, wall = _sharded_run(dev, dataclasses.replace(base, shards=S),
                                           data, label, T)
        used = _compare(res, want, label, fields_float=(*FLOAT_FIELDS, "acc"))
        plan = shard_plan(data[5].edges, S, coords=data[5].coords)
        one[S] = res
        out[f"S={S}"] = launches.get("mix_sparse", 0)
        print(f"{label} m={m} svm D={res.model_dim} T={T} (one process, {S} shards; "
              f"B_max {plan.b_max}, H_max {plan.h_max}, boundary_frac "
              f"{plan.boundary_frac:.4f}): launches {launches}; first step "
              f"{res.timing['first_step_ms']:.2f} ms, {res.timing['ms_per_step']:.3f} "
              f"ms/step after it (sparse_pallas {fleet_res.timing['ms_per_step']:.3f}); "
              f"wall {wall:.2f} s with staging; against the sparse_pallas run: integer "
              f"channels equal, worst share of the allowance {used}; every channel but "
              f"consensus_err bit-equal")
        _bit_equal(res, fleet_res, f"{label} against the sparse_pallas run")
    if 8 in one:
        seen = _per_iteration(torch, lambda t: _sharded_run(
            dev, dataclasses.replace(base, shards=8, iters=t), data, "profile", t)[0])
        if seen is None:
            print("profile sharded fleet S=8: the profiler saw no device activity")
        else:
            n_act, busy, _, _ = seen
            ms = one[8].timing["ms_per_step"]
            print(f"profile sharded fleet S=8: {n_act:.1f} device activities/iteration, "
                  f"device busy {busy:.3f} ms/iteration of {ms:.3f} ms (idle share "
                  f"{1 - busy / ms:.3f})")
    if backend:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                    world_size=1, rank=0)
            try:
                label = f"sharded fleet S=8 on {backend}, world size 1"
                res, launches, wall = _sharded_run(
                    dev, dataclasses.replace(base, shards=8), data, label, T)
            finally:
                dist.destroy_process_group()
        _bit_equal(res, one[8], f"{label} against the one-process S=8 run",
                   (*EXACT_FIELDS, "consensus_err", *DYN_INT_FIELDS))
        out[f"S=8 on {backend}"] = launches.get("mix_sparse", 0)
        print(f"{label}: launches {launches}; {res.timing['ms_per_step']:.3f} ms/step "
              f"after the first; wall {wall:.2f} s; every channel bit-equal to the "
              f"one-process S=8 run")

    out.update(_sharded_entry_points(dev))

    # the large cell with 5f's dynamics
    big = _fleet_inputs(big_m, dim)
    plan = shard_plan(big[5].edges, big_shards, coords=big[5].coords)
    bsim = SimConfig(m=big_m, iters=T, dim=dim, r=50.0, trace="summary",
                     mix_impl="sharded", shards=big_shards, **FLEET_DYNAMICS)
    label = f"sharded fleet dynamics m={big_m} S={big_shards}"
    res, launches, wall = _sharded_run(dev, bsim, big, label, T)
    out[f"m={big_m} S={big_shards}"] = launches.get("mix_sparse", 0)
    rounds = bsim.watchdog().rounds(big_m)
    D = res.model_dim
    # per iteration: the w rows, v, deg, up and f_up of the boundary, and the
    # watchdog's int32 distances once a round; the payload all_gather moves
    # is S B_max rows of each
    per_row = D * 4 + 1 + 4 + 1 + 1 + rounds * 4
    print(f"{label} svm D={D} T={T} ({bsim.watchdog_window}-window watchdog, {rounds} "
          f"rounds a step): launches {launches}; first step "
          f"{res.timing['first_step_ms']:.2f} ms, {res.timing['ms_per_step']:.3f} "
          f"ms/step after it; wall {wall:.2f} s with staging; {_mechanisms(res, label, all_knobs=False)}")
    print(f"{label} plan: B_max {plan.b_max}, H_max {plan.h_max}, boundary_frac "
          f"{plan.boundary_frac:.4f} ({int(plan.n_send.sum())} boundary rows); halo "
          f"bytes an iteration: {int(plan.n_send.sum()) * D * 4} of w over the real "
          f"boundary rows, {big_shards * plan.b_max * per_row} gathered in all "
          f"(padded to B_max, with v, deg, liveness and the watchdog's distances)")
    seen = _per_iteration(torch, lambda t: _sharded_run(
        dev, dataclasses.replace(bsim, iters=t), big, "profile", t)[0])
    if seen is None:
        print(f"profile {label}: the profiler saw no device activity; busy share not "
              f"measured")
    else:
        n_act, busy, per_it, _ = seen
        ms = res.timing["ms_per_step"]
        print(f"profile {label}: {n_act:.1f} device activities/iteration, device busy "
              f"{busy:.3f} ms/iteration of {ms:.3f} ms (idle share {1 - busy / ms:.3f})")
        for kname, kms in sorted(per_it.items(), key=lambda kv: -kv[1])[:6]:
            print(f"profile {label}:   {kms:8.4f} ms/iteration  {kname[:90]}")
    plain, _, pwall = _sharded_run(dev, dataclasses.replace(
        bsim, mix_impl="sparse_pallas", shards=1), big, f"{label} sparse_pallas", T)
    used = _compare(res, {f: getattr(plain, f) for f in (*DYN_INT_FIELDS,
                                                         *FLOAT_FIELDS, "acc")},
                    label, fields_int=DYN_INT_FIELDS, fields_float=(*FLOAT_FIELDS, "acc"))
    _bit_equal(res, plain, f"{label} against its sparse_pallas twin")
    print(f"{label} against sparse_pallas on the card "
          f"({plain.timing['ms_per_step']:.3f} ms/step, wall {pwall:.2f} s): "
          f"{', '.join(DYN_INT_FIELDS)} equal; worst share of the allowance {used}; "
          f"every channel but consensus_err bit-equal")
    return out

RESUME_FIELDS = DYN_INT_FIELDS + FLOAT_FIELDS + ("acc", "bandwidths")


def _resume_setup(m: int, dim: int, n_train: int, T: int):
    """The 5e cell with Adam, as ``run_checkpointed`` takes it: the config,
    the graph, a fresh sampler maker and the eval fn (the service's own
    staging, so every process builds the same)."""
    import dataclasses

    from repro_torch.fl import service

    spec = dataclasses.replace(dynamics_spec(m, dim, n_train, T), optimizer="adam")
    stager = service._Stager(None)
    ds = stager.provider(spec)
    return (spec.to_sim(), stager.graph(spec),
            lambda: spec.batches(spec.seeds[0], ds), stager.eval_fn(spec, ds),
            spec.eval_every)


def resume_child(ckpt_dir: str, out: str, device: str, m: int, dim: int,
                 n_train: int, T: int, every: int) -> None:
    """The resuming process of phase 5g: ``run_checkpointed`` into the
    directory a halted run left, its channels and timing saved to ``out``."""
    import torch

    from repro_torch.fl.simulator import run_checkpointed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sim, graph, batches, eval_fn, E = _resume_setup(m, dim, n_train, T)
    res = run_checkpointed(sim, graph, batches(), eval_fn, ckpt_dir=ckpt_dir,
                           checkpoint_every=every, eval_every=E, device=device)
    np.savez(out, timing=json.dumps(res.timing),
             **{f: np.asarray(getattr(res, f)) for f in RESUME_FIELDS})


def phase_resume(dev, m: int = 1024, dim: int = 784, n_train: int = 8192,
                 T: int = 20, every: int = 10) -> None:
    """5g: ``run_checkpointed`` of the 5e cell with Adam, a checkpoint every
    ``every`` iterations, into a temporary directory deleted afterwards:
    the uninterrupted run; a run halted after one segment; its resume in a
    fresh Python process (``resume_child``), bit-equal to the
    uninterrupted run on every channel; and ``run`` of the same spec, its
    integer channels equal and floats within RTOL / ATOL.  Prints each
    checkpoint's bytes and its save and restore seconds."""
    import shutil
    import tempfile

    from repro_torch.fl.simulator import CheckpointHalt, run, run_checkpointed

    sim, graph, batches, eval_fn, E = _resume_setup(m, dim, n_train, T)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        full = run_checkpointed(sim, graph, batches(), eval_fn, ckpt_dir=str(tmp / "full"),
                                checkpoint_every=every, eval_every=E, device=dev)
        _finite(full, "resume: uninterrupted")
        halted = False
        try:
            run_checkpointed(sim, graph, batches(), eval_fn, ckpt_dir=str(tmp / "crash"),
                             checkpoint_every=every, eval_every=E, halt_after=1,
                             device=dev)
        except CheckpointHalt:
            halted = True
        check(halted, "resume: the run did not halt after its first segment")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--resume-child",
             str(tmp / "crash"), str(tmp / "resumed.npz"),
             *map(str, (dev, m, dim, n_train, T, every))],
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0, f"resume: the resuming process failed:\n"
                                     f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
        got = np.load(tmp / "resumed.npz")
        differ = [f for f in RESUME_FIELDS
                  if not np.array_equal(got[f], np.asarray(getattr(full, f)))]
        check(not differ, f"resume: the resumed run differs from the uninterrupted "
                          f"one in {differ}")
        solo = run(sim, graph, batches(), eval_fn, eval_every=E, device=dev)
        used = _compare(full, {f: getattr(solo, f) for f in RESUME_FIELDS},
                        "resume: checkpointed vs run", fields_int=DYN_INT_FIELDS,
                        fields_float=(*FLOAT_FIELDS, "acc", "bandwidths"))
        resumed_t = json.loads(str(got["timing"]))
        for seg in full.timing["segments"]:
            print(f"resume: checkpoint step_{seg['end']} {seg['bytes']} bytes, saved "
                  f"in {seg['save_s']:.3f} s; segment {seg['ms_per_step']:.3f} "
                  f"ms/iteration")
        print(f"resume m={m} mlp D={full.model_dim} Adam T={T}, a checkpoint every "
              f"{every}: halted after one segment, resumed in a fresh process "
              f"({child_s:.1f} s with start-up; restore {resumed_t['restore_s']:.3f} "
              f"s, its save of step_{resumed_t['segments'][0]['end']} "
              f"{resumed_t['segments'][0]['save_s']:.3f} s): every channel "
              f"({', '.join(RESUME_FIELDS)}) bit-equal to the uninterrupted run; "
              f"against run(): integer channels equal, worst share of the "
              f"allowance {used}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cpu(dev, m: int = 64, dim: int = 784, model: str = "svm",
              T: int = 30, dynamics: bool = False, shards: int = 0) -> None:
    """``api.simulate`` on the card and on the CPU (plain versions),
    channel by channel; with ``dynamics`` under ``dynamics_knobs`` (the
    budget 4 broadcasts of this model), every dynamics channel too; with
    ``shards`` the sharded engine on that many shards (summary trace)."""
    from repro_torch import api
    from repro_torch.fl.simulator import model_spec

    kw = dict(m=m, model=model, dim=dim, iters=T, mix_impl="pallas", trace="full")
    if shards:
        kw.update(mix_impl="sharded", shards=shards, trace="summary")
    if dynamics:
        kw.update(dynamics_knobs(model_spec(api.ScenarioSpec(**kw).to_sim()).flat_dim))
    spec = api.ScenarioSpec(**kw)
    gpu = api.simulate(spec, device=dev)
    cpu = api.simulate(spec, device="cpu")
    fields = DYN_INT_FIELDS if dynamics else INT_FIELDS
    want = {f: getattr(cpu, f) for f in (*fields, *FLOAT_FIELDS, "acc")}
    label = (f"card vs cpu {model}" + (" dynamics" if dynamics else "")
             + (f" sharded S={shards}" if shards else ""))
    used = _compare(gpu, want, label, fields_int=fields,
                    fields_float=(*FLOAT_FIELDS, "acc"))
    if dynamics:
        print(f"{label}: {_mechanisms(cpu, label)}")
    if not shards:
        check(np.array_equal(gpu.comm, cpu.comm) and np.array_equal(gpu.adj, cpu.adj),
              f"{label}: link matrices differ")
    print(f"{label} m={m} D={gpu.model_dim} {kw['mix_impl']} T={T}: integer channels"
          f"{'' if shards else ' and link matrices'} equal, float channels within rtol "
          f"{RTOL} / atol {ATOL}; worst share of the allowance: {used}")


def _device_activity(torch, run
                     ) -> tuple[int, float, dict[str, float], dict[str, int]]:
    """Device activities, their summed device time (ms), and the time and
    the number of activities per kernel name of one ``run()`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in dev_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    return len(dev_events), sum(per_name.values()), per_name, count


def _repo_kernel(name: str) -> str | None:
    """The repo's kernel function (``REPO_KERNELS``) a profiler event name
    belongs to, if any."""
    import re

    hit = re.search(r"::(\w+_kernel)\b", name)
    return hit.group(1) if hit and hit.group(1) in REPO_KERNELS else None


def _repo_counts(count: dict[str, int]) -> dict[str, int]:
    """Device activities per kernel name, summed per repo kernel function."""
    seen: dict[str, int] = {}
    for name, n in count.items():
        if fn := _repo_kernel(name):
            seen[fn] = seen.get(fn, 0) + n
    return seen


def _service_a_launch(dev, T: int):
    """One service launch of signature A (``SERVICE_WAVE``'s six A cells,
    padded to 8) at horizon T; its first cell's result (the launch's
    timing)."""
    import dataclasses

    from repro_torch import api

    a = service_specs(T=T)["A"]
    reps = api.serve([dataclasses.replace(a, policy=p, seeds=seeds)
                      for sig, p, seeds in SERVICE_WAVE if sig == "A"],
                     max_cells=SERVICE_CELLS, device=dev)
    check(len({r.launch_id for r in reps}) == 1 and all(r.ok for r in reps),
          "service A launch: expected one launch, every report ok")
    return next(iter(reps[0].results.values()))


def _deep_run(dev, model: str, T: int, m: int = 1024, dim: int = 784,
              n_train: int = 8192):
    from repro_torch import api

    return api.simulate(api.ScenarioSpec(m=m, model=model, dim=dim, n_train=n_train,
                                         iters=T, eval_every=10, mix_impl="pallas",
                                         trace="summary"), device=dev)


def _watchdog_profile(torch, dev) -> None:
    """One ``flow.watchdog_step`` at the dynamics cells' shapes (the 5e
    fabric, rgg r=0.4 at m=1024, for 1 and 8 cells; the 5f fleet fabric at
    m=4096), on a random information-flow mask: its rounds, device
    activities and device busy time per call under the profiler, and its
    host wall time per call without it."""
    from repro_torch.core import flow
    from repro_torch.core.topology import StagedNeighbors, fleet_radius, make_process

    for label, m, radius, cells in (("5e", 1024, 0.4, 1), ("5e sweep", 1024, 0.4, 8),
                                    ("5f", 4096, fleet_radius(4096), 1)):
        nl = StagedNeighbors.from_host(make_process(m, "rgg", radius=radius, seed=0)
                                       .neighbors(), dev)
        gen = torch.Generator(device=dev).manual_seed(m + cells)
        comm = nl.mask & (torch.rand((cells,) + tuple(nl.idx.shape), generator=gen,
                                     device=dev) < 0.3)
        cfg = flow.WatchdogConfig(window=4)
        age = flow.watchdog_init(m, nl.d_max, (cells,), dev).age

        def call():
            return flow.watchdog_step(cfg, nl.idx, comm, age)

        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        n, busy, _, _ = _device_activity(torch, call)
        print(f"profile watchdog ({label}: m={m}, d_max {nl.d_max}, {cells} cell(s), "
              f"{cfg.rounds(m)} rounds): {n} device activities a call, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms host wall (idle share "
              f"{1 - busy / wall:.3f})")


def _per_iteration(torch, cell):
    """``cell(T)`` at T=4 and T=8 under the profiler; the difference over 4
    iterations, which cancels staging and init: (device activities, device
    busy ms, device ms by kernel name, each per iteration; the T=8
    result), or None when the profiler sees no device activity."""
    n4, busy4, per4, _ = _device_activity(torch, lambda: cell(4))
    out = {}
    n8, busy8, per8, _ = _device_activity(torch, lambda: out.setdefault("res", cell(8)))
    if not n8:
        return None
    per_it = {k: (ms - per4.get(k, 0.0)) / 4 for k, ms in per8.items()}
    return (n8 - n4) / 4, (busy8 - busy4) / 4, per_it, out["res"]


def phase_profile(torch, dev, step_ms: dict[str, float]) -> None:
    """Per-iteration device activities, device busy time, idle share, the
    device time of the kernels that take the most and of each of the
    repo's kernels, of the paper, fleet, dense-fabric, paper-sweep and
    fleet-sweep paths, one service launch of signature A and the cnn
    cell: each runs at T=4 and T=8 under the profiler, and
    the difference over 4 iterations cancels staging and init.  The idle
    share is 1 - busy / ``step_ms[cell]``, the ms per iteration of the
    cell's main-path run without the profiler; for the cnn also 1 - busy
    / the ms per iteration of a warm T=8 run without it (its first run in
    the process is 2-3x slower than later ones).  The dynamics cells (5e,
    5f) come with the watchdog's own share (``_watchdog_profile``)."""
    cells = {"paper": lambda T: phase_paper(dev, T=T)[1],
             "fleet": lambda T: phase_fleet(dev, T=T)[1],
             "dense fabric": lambda T: phase_fleet(
                 dev, m=1024, T=T, radius=0.4, routes=("mix_sparse_wide",))[1],
             "paper sweep": lambda T: phase_sweep(dev, T=T)[1],
             "fleet sweep": lambda T: phase_fleet_sweep(dev, T=T)[1],
             "service A launch": lambda T: _service_a_launch(dev, T),
             "cnn": lambda T: _deep_run(dev, "cnn", T),
             "paper dynamics": lambda T: phase_dynamics(dev, T=T, checks=False)[1],
             "fleet dynamics": lambda T: phase_fleet_dynamics(dev, T=T,
                                                              checks=False)[1]}
    for name, cell in cells.items():
        cell(4)  # warm
        # the cnn's first run is slower than its later ones: time a warm one
        warm = cell(8).timing["ms_per_step"] if name == "cnn" else None
        seen = _per_iteration(torch, cell)
        if seen is None:
            print(f"profile {name}: the profiler saw no device activity; "
                  f"busy share not measured")
            continue
        launches, busy, per_it, res8 = seen
        top = sorted(per_it.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile {name}: {launches:.1f} device activities/iteration, "
              f"device busy {busy:.3f} ms/iteration of {step_ms[name]:.3f} ms "
              f"without the profiler (idle share {1 - busy / step_ms[name]:.3f})"
              + ("" if warm is None else f", of {warm:.3f} ms in a warm run "
                                         f"(idle share {1 - busy / warm:.3f})")
              + f"; {res8.timing['ms_per_step']:.3f} ms/iteration under it")
        for kname, ms in top:
            print(f"profile {name}:   {ms:8.4f} ms/iteration ({ms / busy:.3f} of "
                  f"busy)  {kname[:90]}")
        own: dict[str, float] = {}
        for kname, ms in per_it.items():
            if fn := _repo_kernel(kname):
                own[fn] = own.get(fn, 0.0) + ms
        print(f"profile {name}: the repo's kernels, device ms/iteration: " + (
            ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items())) or "none seen"))
    _watchdog_profile(torch, dev)


# ---------------------------------------------------------------------------
# phases 8-9: the architecture model's serving path
# ---------------------------------------------------------------------------

def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _profile_line(torch, label: str, wall_ms: float, n: int, run
                  ) -> dict[str, int] | None:
    """Device activities and busy time per call of ``run`` (which makes
    ``n`` calls) under the profiler, the idle share against ``wall_ms``
    per call measured without it, and the kernels that take the most.
    Returns the device activities of each of the repo's kernels in the
    run, or None when the profiler saw no device activity."""
    n_act, busy, per_name, count = _device_activity(torch, run)
    if not n_act:
        print(f"{label} profile: the profiler saw no device activity; busy "
              f"share not measured")
        return None
    swa = sum(ms for name, ms in per_name.items()
              if (_repo_kernel(name) or "").startswith("swa_"))
    print(f"{label} profile: {n_act / n:.0f} device activities per call, device "
          f"busy {busy / n:.2f} ms of {wall_ms:.2f} ms (idle share "
          f"{1 - busy / n / wall_ms:.3f}); swa_attention {swa / n:.2f} ms")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{label} profile:   {ms / n:9.3f} ms per call  {name[:90]}")
    return _repo_counts(count)


def phase_serve(torch, dev, cfg=None, seq: int = 32768, n_req: int = 4,
                prompt: int = 16, new: int = 16, cache_len: int = 4096,
                heads=(0, 23, 47), seed: int = 0, twin: str | None = None
                ) -> tuple[int, dict[str, int] | None]:
    """starcoder2-15b (or ``cfg``) with ``attn_impl="pallas_swa"``: one
    prefill of ``seq`` tokens (the prefill_32k length, batch cut from 32
    to 1), its logits within atol=rtol 1e-4 of the same prefill with
    ``attn_impl=twin`` where ``twin`` is given, then ``n_req`` requests
    decoded token by token.  Returns the prefill's launches of the SWA
    kernel that serves the model's dtype (the tensor-core kernel in bf16,
    the split-TF32 one in fp32), which must be all of its SWA launches,
    and the device activities of each repo kernel in a profiled prefill
    (None off the card or when the profiler saw none)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.swa.ref import swa_ref
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    cfg = dataclasses.replace(cfg or get_config("starcoder2-15b"),
                              attn_impl="pallas_swa")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    _sync(torch, dev)
    leaves: list = []
    M.tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"serve {cfg.name}: {cfg.n_layers} layers, {n_params} parameters "
          f"({n_bytes / 1e9:.2f} GB {cfg.dtype}) drawn on {dev} in "
          f"{time.perf_counter() - t0:.1f} s")

    prefill = steps.make_prefill_step(cfg)
    tokens = torch.as_tensor(token_dataset(seq, vocab=cfg.vocab, seed=seed),
                             dtype=torch.int64, device=dev)[None]

    # (a) prefill: count the kernel's launches, keep layer 0's kernel
    # inputs and output for the check against the plain version
    first: list = []
    real = swa_ops.swa_attention

    def capture(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if not first:
            first.append((q, k, v, out, kw["window"]))
        return out

    swa_ops.swa_attention = capture
    try:
        _reset_launches()
        logits = prefill(params, {"tokens": tokens})
        _sync(torch, dev)
        counts = _launches()
    finally:
        swa_ops.swa_attention = real
    check(bool(first), "serve prefill: the SWA wrapper was never called")
    route = swa_route(torch, first[0][0].dtype)  # the kernel that serves q's dtype
    launches = counts[route]
    other = sum(counts[k] for k in swa_ops.LAUNCHES if k != route)
    check(launches == cfg.n_layers and other == 0,
          f"serve prefill: expected {cfg.n_layers} launches, all on {route}, "
          f"got {counts}")
    check(tuple(logits.shape) == (1, seq, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"serve prefill: logits {tuple(logits.shape)} not finite or misshaped")
    twin_text = ""
    if twin is not None:
        other = steps.make_prefill_step(dataclasses.replace(cfg, attn_impl=twin))(
            params, {"tokens": tokens})
        err = float((logits - other).abs().max())
        check(bool(torch.allclose(logits, other, atol=1e-4, rtol=1e-4)),
              f"serve prefill: logits vs attn_impl={twin!r} outside atol=rtol 1e-4 "
              f"(max abs err {err:.3g})")
        twin_text = (f"; logits vs attn_impl={twin!r} on the card: max abs err "
                     f"{err:.3g}, logits std {float(logits.std()):.3g} (tol atol=rtol 1e-4)")
        del other
    del logits
    q, k, v, out, win = first.pop()
    group = cfg.n_heads // cfg.n_kv_heads
    tol = "bf16" if out.dtype == torch.bfloat16 else "fp32"
    errs, rels, scales = [], [], []
    for hh in heads:
        gg = hh // group
        ref = swa_ref(q[:, :, hh:hh + 1].transpose(1, 2),
                      k[:, :, gg:gg + 1].transpose(1, 2),
                      v[:, :, gg:gg + 1].transpose(1, 2), window=win).transpose(1, 2)
        ok, err, rel, scale = swa_close(torch, out[:, :, hh:hh + 1], ref, tol)
        errs.append(err)
        rels.append(rel)
        scales.append(scale)
        check(ok, f"serve prefill: layer 0 head {hh} outside {swa_tol_text(tol)} "
                  f"of the plain version (max abs err {err:.3g}, rel L2 {rel:.3g})")
        del ref
    del q, k, v, out

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    _sync(torch, dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    state = card_state() if on_card else "not measured"
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    del logits
    print(f"serve prefill B=1 S={seq}: {launches} {route} launches; logits "
          f"finite; layer 0 heads {list(heads)} vs plain: max abs err "
          f"{max(errs):.3g}, rel L2 {max(rels):.3g}, output std "
          f"{min(scales):.3g}-{max(scales):.3g} (tol {swa_tol_text(tol)}){twin_text}; "
          f"{prefill_ms:.1f} ms "
          f"({seq / prefill_ms * 1e3:.0f} tokens/s, host clock to a sync, second "
          f"run); peak memory {peak:.2f} GB; card right after (SM clock, power, "
          f"temperature): {state}")
    seen = None
    if on_card:
        seen = _profile_line(torch, "serve prefill", prefill_ms, 1,
                             lambda: prefill(params, {"tokens": tokens}))

    # (b) decode: prompts replayed into the ring-buffer cache, then greedy
    serve = steps.make_serve_step(cfg)
    prompts = token_dataset(n_req * prompt, vocab=cfg.vocab, seed=seed + 1)
    fed = torch.zeros((n_req, prompt + new), dtype=torch.int64, device=dev)
    fed[:, :prompt] = torch.as_tensor(prompts.reshape(n_req, prompt))
    cache = M.init_cache(cfg, n_req, cache_len, device=dev)
    dec = []
    t0 = time.perf_counter()
    for t in range(prompt):
        lg, cache = serve(params, cache, fed[:, t], t)
        dec.append(lg)
    _sync(torch, dev)
    t1 = time.perf_counter()
    for t in range(prompt, prompt + new):
        fed[:, t] = dec[-1].argmax(-1)
        lg, cache = serve(params, cache, fed[:, t], t)
        dec.append(lg)
    _sync(torch, dev)
    t2 = time.perf_counter()
    dec = torch.stack(dec, 1).float()
    fwd = prefill(params, {"tokens": fed}).float()
    rel = float(((dec - fwd).norm(dim=(1, 2)) / fwd.norm(dim=(1, 2))).max())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    check(bool(torch.isfinite(dec).all()) and rel <= 5e-2,
          f"serve decode: decode logits vs forward relative L2 {rel:.3g} > 5e-2")
    step_ms = (t2 - t1) * 1e3 / new
    print(f"serve decode B={n_req} cache_len={cache_len}: {prompt} prompt tokens "
          f"replayed in {(t1 - t0) * 1e3 / prompt:.2f} ms/step, {new} greedy steps "
          f"at {step_ms:.2f} ms/step ({n_req * 1e3 / step_ms:.1f} tokens/s); "
          f"logits at {prompt + new} positions vs forward: max relative L2 "
          f"{rel:.3g} (tol 5e-2), argmax agreement {agree:.3f}")
    if on_card:
        _profile_line(torch, "serve decode", step_ms, 4, lambda: [
            serve(params, cache, fed[:, -1], t)
            for t in range(prompt + new, prompt + new + 4)])
    del params, cache, dec, fwd
    if on_card:
        torch.cuda.empty_cache()
    return launches, seen


def phase_serve_cpu(torch, dev, seq: int = 128, seed: int = 0
                    ) -> tuple[int, dict[str, int] | None]:
    """The starcoder2 smoke configuration (fp32, pallas_swa) on the card
    (the split-TF32 kernel) and on the CPU (plain version), one set of
    weights.  Returns the split-TF32 kernel's launches on the card and the
    device activities of each repo kernel in that prefill, which runs under
    the profiler (None off the card or when the profiler saw none)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(smoke_config("starcoder2-15b"), attn_impl="pallas_swa")
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    card_params = M.tree_map(lambda t: t.to(dev), cpu_params)
    tokens = torch.as_tensor(token_dataset(2 * seq, vocab=cfg.vocab, seed=seed),
                             dtype=torch.int64).reshape(2, seq)
    prefill = steps.make_prefill_step(cfg)
    _reset_launches()
    if torch.device(dev).type == "cuda":
        out: dict = {}
        n_act, _, _, count = _device_activity(torch, lambda: out.setdefault(
            "logits", prefill(card_params, {"tokens": tokens.to(dev)})))
        card, seen = out["logits"], _repo_counts(count) if n_act else None
    else:
        card, seen = prefill(card_params, {"tokens": tokens.to(dev)}), None
    counts = _launches()
    launches = counts["swa_attention_tf32"]  # fp32: the split-TF32 kernel
    check(launches == cfg.n_layers and counts["swa_attention_tc"] == 0,
          f"serve_cpu: expected {cfg.n_layers} swa_attention_tf32 launches and no "
          f"swa_attention_tc launch, got {counts}")
    cpu = prefill(cpu_params, {"tokens": tokens})
    err = float((card.cpu() - cpu).abs().max())
    check(bool(torch.allclose(card.cpu(), cpu, atol=1e-4, rtol=1e-4)),
          f"serve_cpu: card vs cpu logits outside atol=rtol 1e-4 (max abs err "
          f"{err:.3g})")
    print(f"serve card vs cpu {cfg.name} fp32 S={seq}: {launches} swa_attention_tf32 "
          f"launches on the card, logits max abs err {err:.3g} (tol atol=rtol 1e-4)")
    return launches, seen


def simt_launches(runs: dict[str, tuple[int, str, dict[str, int] | None]]
                  ) -> int | None:
    """The SIMT SWA kernel's (``swa_kernel``) launches in the serve
    prefills ``runs`` (label: the launches its wrapper counted, the kernel
    function that serves it, the profiler's device activities per repo
    kernel), counted by the profiler: no wrapper route reaches the kernel,
    so it has no counter.  Each prefill's profile must hold as many
    activities of its serving kernel as the wrapper counted, and the SIMT
    kernel none.  None when the profiler saw no device activity."""
    total = 0
    for label, (want, kernel, seen) in runs.items():
        if seen is None:
            print(f"{label}: the profiler saw no device activity; the SIMT "
                  f"kernel's launches not measured")
            return None
        check(seen.get(kernel, 0) == want,
              f"{label}: the profiler saw {seen.get(kernel, 0)} {kernel} launches, "
              f"the wrapper counted {want}")
        total += seen.get("swa_kernel", 0)
    check(total == 0, f"swa_kernel (SIMT) ran {total} times in the serve prefills; "
                      f"no route should reach it")
    print(f"swa_kernel (SIMT) launches in the serve prefills, counted by the "
          f"profiler beside each one's serving kernel: {total} ("
          + ", ".join(f"{label}: {want} {kernel}" for label, (want, kernel, _)
                      in runs.items()) + ")")
    return total


def starcoder2_fp32(n_layers: int = 2):
    """starcoder2-15b at its full width in fp32, its depth cut from 40 to
    ``n_layers`` layers (~1.5 GB of fp32 weights a layer beside the
    embedding and head), with ``attn_impl="pallas_swa"``."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("starcoder2-15b"), n_layers=n_layers,
                               layer_plan=((("attn",), n_layers),), dtype="float32",
                               attn_impl="pallas_swa")


# kernel functions of csrc/ (the names the profiler shows)
REPO_KERNELS = ("trigger_sq_kernel", "mix_kernel", "mix_sparse_kernel",
                "compact_slots_kernel", "mix_sparse_wide_kernel",
                "row_finite_kernel", "mix_sparse_direct_kernel", "swa_kernel",
                "swa_tc_kernel", "swa_tf32_kernel")

KERNEL_SOURCES = {
    "trigger_sq": ("src/repro_torch/kernels/csrc/trigger_sq.cu",
                   "src/repro/kernels/trigger/kernel.py:39"),
    "mix": ("src/repro_torch/kernels/csrc/mix.cu",
            "src/repro/kernels/mixing/kernel.py:32"),
    "mix_sparse": ("src/repro_torch/kernels/csrc/mix_sparse.cu",
                   "src/repro/kernels/mixing/kernel.py:74"),
    "mix_sparse_wide": ("src/repro_torch/kernels/csrc/mix_sparse.cu",
                        "src/repro/kernels/mixing/kernel.py:74"),
    "mix_sparse_direct": ("src/repro_torch/kernels/csrc/mix_sparse.cu",
                          "src/repro/kernels/mixing/kernel.py:74"),
    "swa_attention": ("src/repro_torch/kernels/csrc/swa_attention.cu",
                      "src/repro/kernels/swa/kernel.py:76"),
    "swa_attention_tc": ("src/repro_torch/kernels/csrc/swa_attention_tc.cu",
                         "src/repro/kernels/swa/kernel.py:76"),
    "swa_attention_tf32": ("src/repro_torch/kernels/csrc/swa_attention_tf32.cu",
                           "src/repro/kernels/swa/kernel.py:76"),
}


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--resume-child":
        # phase 5g's resuming process: no result line of its own
        sys.path.insert(0, str(SRC))
        ckpt_dir, out, device, *sizes = sys.argv[2:]
        resume_child(ckpt_dir, out, device, *map(int, sizes))
        return 0
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

    t0 = time.perf_counter()

    def lap(done: str) -> None:  # the script's time so far, against its limit
        print(f"[{time.perf_counter() - t0:.1f} s] {done} done", flush=True)

    try:
        print(card_line())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")
        from repro_torch.kernels import build
        variant_builds = start_variant_builds()  # beside the kernels'
        try:
            build.library()
        finally:
            outs = {name: proc.communicate()[0] for name, (proc, _) in variant_builds.items()}
        for name, (proc, _) in variant_builds.items():
            check(proc.returncode == 0,
                  f"nvcc failed on the variant build {name}:\n{outs[name]}")
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

        rows = phase_kernels(torch, dev, seed=0, variant_libs={
            name: lib for name, (_, lib) in variant_builds.items()})
        lap("phase 2")
        phase_golden(dev)
        phase_golden(dev, "mlp_blocks")
        paper, paper_res = phase_paper(dev, twin=True)
        sweep, sweep_res = phase_sweep(dev, twin=True, solo=True)
        fleet, fleet_res = phase_fleet(dev, twin=True)
        fleet_sweep, fleet_sweep_res = phase_fleet_sweep(dev, twin=True)
        rows["trigger_sq"]["sweep_launches"] = sweep["trigger_sq"]
        rows["mix"]["sweep_launches"] = sweep["mix"]
        rows["mix_sparse"]["sweep_launches"] = fleet_sweep["mix_sparse"]
        dense, dense_res = phase_fleet(dev, m=1024, T=10, twin=True, radius=0.4,
                                       routes=("mix_sparse_wide",))
        launches = {"trigger_sq": paper["trigger_sq"], "mix": paper["mix"],
                    "mix_sparse": fleet["mix_sparse"],
                    "mix_sparse_wide": dense["mix_sparse_wide"]}
        launches["mix_sparse_direct"] = phase_fleet(
            dev, m=4096, T=3, twin=True, radius=0.4,
            routes=("mix_sparse_wide", "mix_sparse_direct"))[0]["mix_sparse_direct"]
        lap("phases 3-5b")
        service, service_res = phase_service(dev)
        for name in ("trigger_sq", "mix", "mix_sparse_wide"):
            rows[name]["service_launches"] = service[name]
        phase_quarantine(dev)
        deep = phase_deep(dev)
        lap("phases 5c-5d")
        dyn, dyn_res = phase_dynamics(dev, twin=True, sweep=True)
        fleet_dyn, fleet_dyn_res = phase_fleet_dynamics(dev, twin=True)
        for name, counts in (("trigger_sq", dyn), ("mix", dyn),
                             ("mix_sparse", fleet_dyn)):
            rows[name]["dynamics_launches"] = counts[name]
        lap("phases 5e-5f")
        rows["mix_sparse"]["sharded_launches"] = phase_sharded(dev, fleet_res)
        lap("phase 5h")
        phase_resume(dev)
        phase_cpu(dev)
        phase_cpu(dev, m=16, model="cnn", T=10)
        phase_cpu(dev, dynamics=True)
        phase_cpu(dev, shards=4)
        lap("phases 5g, 6")
        phase_profile(torch, dev, {
            name: res.timing["ms_per_step"] for name, res in (
                ("paper", paper_res), ("fleet", fleet_res), ("dense fabric", dense_res),
                ("paper sweep", sweep_res), ("fleet sweep", fleet_sweep_res),
                ("service A launch", service_res), ("cnn", deep["cnn"]),
                ("paper dynamics", dyn_res), ("fleet dynamics", fleet_dyn_res))})
        lap("phase 7")
        # the sweeps held ~17 GB of (8, 1024, 50890) tensors: hand the cached
        # blocks back before the serve phases load 32 GB of weights
        del (paper_res, sweep_res, fleet_res, fleet_sweep_res, dense_res, service_res,
             deep, dyn_res, fleet_dyn_res)
        from repro_torch.fl import simulator
        simulator._ENGINE_CACHE.clear()  # the engines keep their datasets on the card
        torch.cuda.empty_cache()
        launches["swa_attention_tc"], seen_bf16 = phase_serve(torch, dev)
        lap("phase 8")
        launches["swa_attention_tf32"], seen_fp32 = phase_serve(
            torch, dev, cfg=starcoder2_fp32(), seq=8192, twin="chunked")
        lap("phase 9")
        smoke, seen_smoke = phase_serve_cpu(torch, dev)
        lap("phase 10")
        launches["swa_attention"] = simt_launches({
            "serve prefill bf16": (launches["swa_attention_tc"], "swa_tc_kernel", seen_bf16),
            "serve prefill fp32": (launches["swa_attention_tf32"], "swa_tf32_kernel",
                                   seen_fp32),
            "serve card vs cpu": (smoke, "swa_tf32_kernel", seen_smoke)})
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
                                   "bound_ms", "bound_by", "library_ms")},
            **{k: row[k] for k in ("ms_s32768", "library_ms_s32768",
                                   "bound_ms_s32768", "bound_ms_fp32_units",
                                   "bound_ms_fp32_units_s32768", "fp64_max_abs_err",
                                   "fp64_bias", "ms_rna_lo", "fp64_max_abs_err_rna_lo",
                                   "fp64_bias_rna_lo", "plan_build_ms", "ms_32_columns",
                                   "sweep_launches", "service_launches",
                                   "dynamics_launches", "sharded_launches", "ms_halo",
                                   "plain_ms_halo", "library_ms_halo", "bound_ms_halo",
                                   "ms_c8", "plain_ms_c8",
                                   "library_ms_c8", "bound_ms_c8",
                                   "ms_64_columns", "ms_m4096_r04",
                                   "plain_ms_m4096_r04", "bound_ms_m4096_r04",
                                   "library_ms_m4096_r04", "sass_tensor_ops")
               if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
