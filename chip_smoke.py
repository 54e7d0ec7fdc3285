#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` and runs, failing (non-zero exit, no final ``ok`` line) on any
error:

1. card: the GPU's name and power limit from ``nvidia-smi``;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with its time, the plain version's, one PyTorch library
   call's and the least time the card could take (``bound_ms``); the
   trigger at the paths' rows (1024 x 50890, 4096 x 7850, 8192 x 50890,
   1024 x 26698), each also against an fp64 sum, bit-equal from run to
   run, with the slab plan and its kernels' own device time read from
   the profiler with the L2 flushed (``_trigger_row``); the two
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
   against fp64, each within a stated limit; the bf16 SWA kernel at
   hymba-1.5b's heads (25 over 5 KV heads, dh 64, window 1024, S=32768);
   the selective scan (hybrid blocks' Mamba heads; no TPU kernel) at
   hymba's prefill (1, 32768, 3200, 16) in bf16 and at (1, 8192, 3200, 16)
   in fp32, each against its plain version and an fp64 recurrence on 256
   channels, bit-equal from run to run, with its registers and stack (none
   required) and its ``MUFU.EX2`` count a (step, state) in the step loop's
   SASS (one required); the
   sLSTM recurrence (xLSTM's sLSTM blocks; no TPU kernel) at xlstm-125m's
   heads (1, 4096, 4, 4, 192) in bf16 and fp32, against its plain per-step
   loop, bit-equal from run to run, the fp32 kernel's error against an fp64
   recurrence within 2 x the plain fp32 loop's and the bf16 kernel's
   distance from the fp32 recurrence within 2 x the plain bf16 loop's, with
   its registers, the byte and operation bound and two serial floors (S x
   one step's product + the per-step signalling between the cluster's
   CTAs alone, timed: at a fixed yardstick shape and at the kernel's own);
   the sLSTM recurrence's backward kernel (``_slstm_bwd_rows``; no TPU
   kernel) at xlstm-125m's train shape a replica (2, 2048, 4, 4, 192) and at
   (1, 4096, 4, 4, 192), bf16 and fp32, from the saving forward's rows (its
   hs bit-equal to the serving launch's): each gradient against the plain
   backward, the fp32 kernel's error against an fp64 backward within 2 x
   the plain fp32 backward's and the bf16 kernel's distance from the fp32
   backward within 2 x the plain bf16 backward's, bit-equal from run to run
   and through autograd of the wrapper, its registers and stack (none
   allowed), the byte and operation bound, a serial floor, and the saving
   forward's time beside the serving launch's;
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
   logits within atol=rtol 1e-4;
11. train: EF-HC training of starcoder2-15b at full width in bf16, its
   depth cut to 2 layers (``starcoder2_train``), through
   ``repro_torch.launch.train.train``: m=4 replicas on a ring with 2 pods,
   global batch 8 at S=2048, 4 dense steps with a checkpoint (~22 GB),
   then 2 neighbor steps in memory; exactly leaves x steps launches of
   ``trigger_sq_bf16`` and of ``mix_bf16`` / ``mix_sparse_bf16`` by
   schedule; ms/step, tokens/s and peak memory; a run resumed from the
   checkpoint bit-equal to the in-memory one; the three bf16 entries
   against their plain versions at the largest leaf (4 x 3.0e8: the
   trigger as in phase 2, both mixes bit for bit) with their times,
   library calls and bounds; one profiled dense step (busy and idle
   time, the entries' share); the smoke configuration in bf16 on the
   card and on the CPU, v equal at every step;
12. serve_mla: deepseek-v3-671b at full width in bf16, its depth cut from
   61 to 2 layers with the reference's smoke block mix (``deepseek_serve``:
   an ``mla`` layer, an ``mla_moe`` layer with 256 routed experts top-8
   and the shared one; the MTP head's parameters built): one prefill of
   8192 tokens (the chunked MLA path in both layers) with the MoE
   capacity's dropped share, four requests decoded through the absorbed
   MLA cache against ``forward`` at a capacity that drops none, and the
   MoE layer's ``scatter`` against its ``dense`` oracle on 512 tokens;
13. serve_moe: granite-moe-3b-a800m at full width and depth (32 layers,
   bf16): the same with a prefill of 32768 tokens;
14. train_moe: EF-HC training of granite-moe-3b-a800m at full width and
   depth through ``repro_torch.launch.train.train`` (phase 11's cell
   without the checkpoint round): exactly leaves x steps launches of each
   entry per dtype (the bf16 entries on the bf16 leaves, the fp32
   ``trigger_sq`` / ``mix`` / ``mix_sparse`` kernels on the fp32 routers);
   ms/step, tokens/s, peak memory, each step's ce and aux; one profiled
   dense step; one MoE layer's forward and backward twice with drops,
   bit-equal; the bf16 entries against their plain versions at the
   (4, 805306368) expert leaf and the fp32 kernels at the (4, 1572864)
   router rows (the trigger as in phase 2); the granite smoke
   configuration in bf16 on the card and on the CPU, v equal at every
   step.

15. serve_hybrid: hymba-1.5b at full size (32 layers, bf16, 1.66e9
   parameters, 3.32 GB): one prefill of 32768 tokens that launches
   ``swa_attention_tc`` once in each of the 29 windowed layers and
   ``selective_scan`` once in each of the 32 layers, the first windowed
   layer's (layer 1's) SWA output held against the plain version on heads
   (0, 5, 24) and layer 0's scan output on 256 channels, then four
   requests decoded as in 8; the decode gate (relative L2 5e-2 against
   ``forward``) holds the same weights in fp32, and the bf16 decode must
   lie within 1.1 x the bf16 forward's distance from the fp32 forward
   (hymba's bf16 noise floor is above 5e-2: ``DECODE_VS_FORWARD``); one
   more prefill under the profiler gives the device time of each block
   type and of its attention and Mamba branches (``_prefill_by_block``);

16. serve_xlstm: xlstm-125m at full size (12 layers: 8 mLSTM, 4 sLSTM,
   bf16, 1.84e8 parameters, ``mlstm_chunk`` 256): one prefill of 32768
   tokens that launches ``slstm`` once in each of the 4 sLSTM layers, the
   first sLSTM layer's (layer 2's) recurrence held against the plain loop
   on its first 4096 steps (no farther from the fp32 recurrence than 2 x
   the plain bf16 loop), then four requests decoded as in 8 (the sLSTM
   kernel over one step a layer), the decode gate in phase 15's fp32-twin
   form (xlstm's bf16 noise floor, too, is above 5e-2); the prefill's
   device time by block type from the profiler (``_prefill_by_block``:
   ``mlstm`` x8, ``slstm`` x4);
17. serve_frontends: paligemma-3b at full size (18 layers, d 2048, MQA,
   tied embeddings, bf16): one prefill of 256 seeded patch embeddings +
   7936 text tokens, logits (1, 7936, 257216) finite, then four text-only
   requests decoded as in 8 against the forward without the frontend;
   hubert-xlarge at full size (48 layers, d 1280, bidirectional, bf16): one
   encoder forward of 8192 seeded frames, logits (1, 8192, 504) finite.
   S is cut from the reference's 32768 for chip time; width and depth are
   not;
18. serve_dense: deepseek-coder-33b (62 layers, 3.334e10 parameters,
   66.69 GB in bf16) and phi3-medium-14b (40 layers, 1.466e10) at full
   size (``DENSE_SERVE``): one prefill of 8192 tokens each (the chunked
   attention path: no repo kernel runs), then four requests decoded as in
   8 against ``forward`` (relative L2 5e-2);
19. train_hybrid: EF-HC training of hymba-1.5b at full size (32 layers,
   bf16, remat) through ``repro_torch.launch.train.train``, phase 14's
   cell (``phase_train_hybrid``): exactly leaves x steps launches of each
   bf16 entry, two launches of the scan's saving forward and one of its
   backward kernel a Mamba layer, replica and step; ms/step, tokens/s,
   peak memory; one profiled dense step (the scan kernels' share of
   busy); the hymba smoke configuration in bf16 on the card and on the
   CPU, v equal at every step.  Phase 2 holds the backward kernel against
   its plain version at hymba's train shape (2, 2048, 3200, 16) and at
   (1, 8192, 3200, 16), bf16 and fp32 (``_scan_bwd_rows``: tolerance,
   fp64 gate, run-to-run bits, the saving forward's y bit-equal; the
   walk's resident blocks an SM and both kernel functions' registers).
20. train_xlstm: EF-HC training of xlstm-125m at full size (12 layers: 8
   mLSTM, 4 sLSTM, dh 192, bf16, remat) through
   ``repro_torch.launch.train.train``, phase 19's cell
   (``phase_train_xlstm``): exactly leaves x steps launches of each bf16
   entry, two launches of the sLSTM kernel's saving forward and one of its
   backward kernel an sLSTM layer, replica and step (192 and 96); ms/step,
   tokens/s, peak memory; one profiled dense step (the sLSTM kernels'
   share of busy, every sLSTM forward there the saving variant); the
   xlstm smoke configuration in bf16 on the card and on the CPU, v equal
   at every step.

Phase 10 also runs the granite-moe and deepseek-v3 smoke configurations
in fp32 on the card and on the CPU: logits within atol=rtol 1e-4 and the
top-k expert indices equal in every MoE layer; the hymba smoke
configuration (its windowed layer on the split-TF32 SWA kernel, both
layers on the selective scan); the xlstm smoke configuration (its sLSTM
layer on the sLSTM kernel); and the paligemma and hubert smoke
configurations with seeded stub embeddings; logits within atol=rtol 1e-4.

The SIMT SWA kernel has no wrapper route, so no counter: its launches are
counted from the profiler's device activities in the prefills of 8-10
and 15, beside each prefill's counted launches of the kernel that serves
it.

A line ``[t s] ... done`` after each group of phases gives the script's
time so far.  The line before the last is one JSON object
``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  It imports nothing of the
JAX package.
"""
from __future__ import annotations

import contextlib
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


def op_peak(elem_bytes: int) -> tuple[float, str]:
    """The peak FLOP/s for products of inputs of ``elem_bytes``: bf16 ones
    on the tensor cores (fp32 accumulation), fp32 ones off them."""
    return (BF16_TC_FLOPS, "bf16 tensor-core") if elem_bytes == 2 else (FP32_FLOPS, "fp32")


def mix_fp64_gate(torch, p, w, got, ref, label: str) -> dict[str, tuple[float, float]]:
    """The split-TF32 ``mix`` output ``got`` and fp32 ``torch.matmul``'s
    ``ref`` against fp64 P @ W: per side the largest error and the mean
    error signed along the exact value, relative to its mean size (a
    truncating sum shrinks).  The kernel's largest error must stay within
    MIX_FP64_ERR_VS_LIB x cuBLAS's fp32 one and its bias within one fp32
    ulp (MIX_FP64_BIAS) of the values' mean size.  (cuBLAS's own bias,
    ~1e-11, is at this measure's noise floor, so no multiple of it is a
    yardstick.)"""
    exact = p.double() @ w.double()
    err = {k: (float((x.double() - exact).abs().max()),
               float(((x.double() - exact) * exact.sign()).mean() / exact.abs().mean()))
           for k, x in (("kernel", got), ("library", ref))}
    del exact
    check(err["kernel"][0] <= MIX_FP64_ERR_VS_LIB * err["library"][0],
          f"{label}: max abs err against fp64 {err['kernel'][0]:.3g} > "
          f"{MIX_FP64_ERR_VS_LIB} x torch.matmul's {err['library'][0]:.3g}")
    check(abs(err["kernel"][1]) <= MIX_FP64_BIAS,
          f"{label}: mean relative bias against fp64 {err['kernel'][1]:.3g} "
          f"outside +-{MIX_FP64_BIAS:.3g}")
    return err


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


def _loop_count(sass: str, opcode: str) -> int:
    """Occurrences of ``opcode`` in the innermost loop of a function's SASS
    (the span from a label to the last backward branch to it) that holds
    any, or 0."""
    import re

    at: dict[str, int] = {}
    pending: list[str] = []
    code: list[tuple[int, str]] = []
    for line in sass.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if ins:
            addr = int(ins.group(1), 16)
            at.update((name, addr) for name in pending)
            pending = []
            code.append((addr, ins.group(2)))
    loops = []
    for addr, text in code:
        bra = re.search(r"\bBRA\b[^`0]*(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if bra:
            target = at.get(bra.group(1)) if bra.group(1) else int(bra.group(2), 16)
            if target is not None and target <= addr:
                loops.append((target, addr))
    pattern = re.compile(rf"\b{re.escape(opcode)}\b")
    counts = sorted((end - start, sum(1 for a, t in code if start <= a <= end
                                      and pattern.search(t)))
                    for start, end in loops)
    return next((n for _, n in counts if n), 0)


def kernel_resources(lib: Path) -> dict[str, dict]:
    """Per kernel function of the built library (mangled names shortened to
    the function's name and template argument): registers from
    ``cuobjdump -res-usage`` (and its stack frame, where spills go), the
    tensor-core instructions in its SASS (``cuobjdump -sass``), by opcode,
    and its ``MUFU.EX2`` instructions, in all and in the innermost loop
    that holds one (``_loop_count``)."""
    import re

    from repro_torch.kernels import build

    tool = str(Path(build.nvcc()).parent / "cuobjdump")

    def run(*args):
        return subprocess.run([tool, *args, str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout

    def short(mangled):
        # an identifier is mangled as its length and its name: find the
        # "<n>..._kernel" whose length prefix ends a run of digits, the
        # shortest such (an anonymous namespace's hash may hold a run of
        # digits that spans the identifier after it too); its template
        # arguments are integers (Li<n>E), flags (Lb0E, Lb1E) and, first, a
        # type (f float, t the bf16 words' unsigned short)
        found = []
        for m in re.finditer(r"\d+", mangled):
            for i in range(len(m.group())):
                end = m.end() + int(m.group()[i:])
                name = mangled[m.end():end]
                if name.endswith("_kernel") and re.fullmatch(r"[a-z_][a-z0-9_]*", name):
                    found.append((len(name), name, end))
        if not found:
            return mangled
        _, name, end = min(found)
        tmpl = re.match(r"I(?:[ft]|Li\d+E|Lb[01]E)+E", mangled[end:])
        args = [n or (["false", "true"][int(f)] if f else {"f": "float", "t": "bf16"}[t])
                for t, n, f in re.findall(r"(?<=[IE])([ft])|Li(\d+)E|Lb([01])E",
                                          tmpl.group() if tmpl else "")]
        return f"{name}<{', '.join(args)}>" if args else name

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
        facts[name]["mufu_ex2"] = len(re.findall(r"\bMUFU\.EX2\b", block))
        facts[name]["mufu_ex2_loop"] = _loop_count(block, "MUFU.EX2")
    return facts


def card_state() -> str:
    """The card's SM clock, power draw and temperature now, to read beside
    the timing that just ended (a card under sustained load clocks down)."""
    return card_line("clocks.sm,power.draw,temperature.gpu")


# the trigger kernel against its plain version: fp32 sums in another
# order; against an fp64 sum its largest relative error within this multiple
# of the plain version's, or this floor
TRIG_RTOL = 1e-5
TRIG_FP64_VS_PLAIN = 2.0
TRIG_FP64_FLOOR = 1e-6
L2_FLUSH_BYTES = 256 << 20  # written before each device-timed call (L2: 50 MB)
# a trigger row's fields that the kernels line carries for each of its
# shapes: phase 2's main one, and its fleet, cells and cnn rows, the
# router rows and the expert leaf (phase 14)
TRIGGER_FIELDS = ("shape", "max_abs_err", "max_rel_err", "fp64_rel_err", "slabs", "ms",
                  "device_ms", "device_ms_clean_l2", "plain_ms", "library_ms", "bound_ms")
TRIGGER_SUFFIXES = ("", "_fleet", "_c8", "_cnn", "_router", "_moe_leaf")
TRIGGER_KERNELS = ("trigger_sq_slab_kernel", "trigger_sq_rows_kernel")
KERNEL_SESSIONS = 5  # profiler sessions at most, until reps whole calls are recorded


def kernel_device_ms(torch, fn, kernels: tuple[str, ...] = TRIGGER_KERNELS,
                     launches: int = 1, reps: int = 20, clean: bool = False) -> float:
    """Median over ``reps`` calls of ``fn`` of the device time of the
    repo's ``kernels`` in one call, read from ``torch.profiler``'s raw
    device records: a call's ``launches`` records summed, the first name
    opening each call.  An L2_FLUSH_BYTES scratch tensor is written before
    each call, so the kernel reads its inputs from HBM with the L2 full of
    dirty lines, as after a step's writes; with ``clean``, a second one is
    read after it, so the L2 holds clean lines (no write-back to compete
    with the kernel's reads).  In a process that has profiled for minutes
    the profiler loses device records (on the H100 machine phase 11 kept
    18 of 30 calls whole), so a call counts only with all its records, and
    sessions repeat, up to KERNEL_SESSIONS, until ``reps`` calls are
    whole."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    other = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if clean else None
    fn()
    torch.cuda.synchronize()
    whole: list[float] = []
    for _ in range(KERNEL_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scratch.fill_(1.0)
                if clean:
                    other.sum()
                fn()
            torch.cuda.synchronize()
        calls: list[list[float]] = []
        for e in sorted((e for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and any(k in e.name() for k in kernels)), key=lambda e: e.start_ns()):
            if kernels[0] in e.name():
                calls.append([])
            if calls:
                calls[-1].append(e.duration_ns() / 1e6)
        whole += [sum(c) for c in calls if len(c) == launches]
        if len(whole) >= reps:
            break
    check(len(whole) >= reps // 2, f"device time of {kernels[0]}: the profiler recorded "
                                   f"{len(whole)} whole calls in {KERNEL_SESSIONS} sessions")
    return float(statistics.median(whole[:reps]))


def _fp64_sq(torch, w, h, step: int = 1 << 26):
    """sum_n (w - h)^2 of each row in fp64, over column chunks (an fp64
    copy of a train leaf would not fit)."""
    m, n = w.shape
    rows = max(1, step // n)
    out = []
    for i in range(0, m, rows):
        acc = torch.zeros(min(rows, m - i), dtype=torch.float64, device=w.device)
        for c in range(0, n, step):
            d = w[i:i + rows, c:c + step].double() - h[i:i + rows, c:c + step].double()
            acc += (d * d).sum(1)
        out.append(acc)
    return torch.cat(out)


def _trigger_row(torch, w, h, label: str, library, reps: int = 25) -> dict:
    """The trigger wrapper on (m, D) rows ``w``, ``h`` against its plain
    version: within rtol TRIG_RTOL of it, the same bits from two calls, and
    against an fp64 sum a largest relative error within
    max(TRIG_FP64_VS_PLAIN x the plain version's, TRIG_FP64_FLOOR).  With
    its event-timed ``ms`` (one wrapper call: host checks, allocation and
    the ctypes call included), ``device_ms`` and ``device_ms_clean_l2``
    (``kernel_device_ms``: the L2 left dirty and clean), the plain
    version's and ``library(w, h)``'s event-timed ms (medians of ``reps``),
    the slab plan and the byte bound."""
    from repro_torch.kernels.trigger import ops as trigger_ops
    from repro_torch.kernels.trigger.ref import trigger_sq_ref

    m, n = w.shape
    got, ref = trigger_ops.trigger_sq(w, h), trigger_sq_ref(w, h)
    same = torch.equal(got, trigger_ops.trigger_sq(w, h))
    exact = _fp64_sq(torch, w, h)
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    rel_err = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    fp64 = {k: float(((x.double() - exact).abs() / exact.abs().clamp(min=1e-300)).max())
            for k, x in (("kernel", got), ("plain", ref))}
    del exact, ref
    limit = max(TRIG_FP64_VS_PLAIN * fp64["plain"], TRIG_FP64_FLOOR)
    check(rel_err <= TRIG_RTOL, f"{label}: max rel err {rel_err:.3g} > {TRIG_RTOL}")
    check(same, f"{label}: not the same bits from run to run")
    check(fp64["kernel"] <= limit, f"{label}: max rel err against fp64 {fp64['kernel']:.3g} > "
                                   f"{limit:.3g} (plain version's {fp64['plain']:.3g})")
    cols, n_slab = trigger_ops.device_plan(m, n, w.element_size(), w.device)
    passes = 1 if n_slab == 1 else 2
    b_ms, b_by = bound(2 * m * n * w.element_size() + m * 4, 3 * m * n)
    row = {"shape": [m, n], "max_abs_err": abs_err,
           "max_rel_err": rel_err, "fp64_rel_err": fp64["kernel"],
           "fp64_rel_err_plain": fp64["plain"], "tolerance": f"rtol {TRIG_RTOL}",
           "slabs": [cols, n_slab],
           "ms": time_ms(torch, lambda: trigger_ops.trigger_sq(w, h)),
           "device_ms": kernel_device_ms(torch, lambda: trigger_ops.trigger_sq(w, h),
                                         launches=passes),
           "device_ms_clean_l2": kernel_device_ms(torch, lambda: trigger_ops.trigger_sq(w, h),
                                                  launches=passes, clean=True),
           "plain_ms": time_ms(torch, lambda: trigger_sq_ref(w, h), reps=reps),
           "library_ms": time_ms(torch, lambda: library(w, h), reps=reps),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"kernel {label} {tuple(row['shape'])} {str(w.dtype)[6:]}: max rel err "
          f"{rel_err:.3g} (tol rtol {TRIG_RTOL}), against fp64 {fp64['kernel']:.3g} (plain "
          f"{fp64['plain']:.3g}, limit {limit:.3g}), two calls bit-equal; {n_slab} slab(s) of "
          f"{cols} columns; kernel_ms {row['ms']:.4f} device_ms {row['device_ms']:.4f} (L2 "
          f"clean {row['device_ms_clean_l2']:.4f}) plain_ms {row['plain_ms']:.4f} library_ms "
          f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); device "
          f"{b_ms / row['device_ms']:.3f} of the bound (L2 clean "
          f"{b_ms / row['device_ms_clean_l2']:.3f}), event-timed {b_ms / row['ms']:.3f}",
          flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev, seed: int, variant_libs: dict[str, Path]
                  ) -> dict[str, dict]:
    import torch.nn.functional as F

    from repro_torch.core import mixing, topology, triggers
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: dict[str, dict] = {}

    # trigger_sq at the paths' rows: (1024, 50890) the paper path's (mlp),
    # (4096, 7850) the svm fleet's, (8192, 50890) the 8-cell sweeps' and
    # service A's (C m rows), (1024, 26698) the cnn run's
    def pairwise(w, h):
        return F.pairwise_distance(w, h, eps=0.0) ** 2

    for (m, n), suffix in (((1024, 50890), ""), ((4096, 7850), "_fleet"),
                           ((8192, 50890), "_c8"), ((1024, 26698), "_cnn")):
        w = torch.randn((m, n), generator=gen, device=dev)
        h = w + 0.01 * torch.randn((m, n), generator=gen, device=dev)
        row = _trigger_row(torch, w, h, "trigger_sq", pairwise)
        if suffix:
            rows["trigger_sq"].update({f"{k}{suffix}": row[k] for k in TRIGGER_FIELDS})
        else:
            rows["trigger_sq"] = {"name": "trigger_sq", **row}
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
    fp64_err = mix_fp64_gate(torch, p, w, got, ref, "mix")
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
    dev_ms = kernel_device_ms(torch, lambda: mixing_ops.mix(p, w), ("mix_kernel",))
    rows["mix"] = {"name": "mix", "shape": [m, n], "max_abs_err": abs_err,
                   "tolerance": f"atol {mix_atol}", "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib, "sass_tensor_ops": tc}
    print("kernel resources (cuobjdump -res-usage / -sass): " + "; ".join(
        f"{k} {v.get('registers')} registers, stack {v.get('stack', 'not read')} B, "
        f"tensor ops {v.get('tensor_ops') or 'none'}"
        for k, v in sorted(res.items())
        if k.startswith(("mix", "swa_tf32", "trigger", "selective_scan", "slstm"))))
    print(f"kernel mix m={m} D={n}: max abs err {abs_err:.3g} (tol atol "
          f"{mix_atol}); kernel_ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms {plain:.4f} library_ms "
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
    dev_ms = kernel_device_ms(torch, lambda: mixing_ops.mix_sparse(nl.idx, p_diag, p_off, w),
                              ("mix_sparse_kernel",))
    rows["mix_sparse"] = {
        "name": "mix_sparse", "shape": [m, n], "d_max": d_max,
        "nnz_off": nnz, "max_abs_err": abs_err, "tolerance": "exact",
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "plan_build_ms": plan.build_ms}
    print(f"kernel mix_sparse m={m} D={n} d_max={d_max} nnz_off={nnz}: max abs "
          f"err {abs_err:.3g} (tol exact); kernel_ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
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
    rows["swa_attention_tc"].update(_swa_hymba_row(torch, dev, gen))
    rows.update(_scan_rows(torch, dev, gen, res))
    rows.update(_scan_bwd_rows(torch, dev, gen, res))
    rows.update(_slstm_rows(torch, dev, gen, res, variant_libs["slstm_sync_probe"]))
    rows.update(_slstm_bwd_rows(torch, dev, gen, res, variant_libs["slstm_sync_probe"]))
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
    fp64_err = mix_fp64_gate(torch, p, w, got, ref, "mix with cells")
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


def _swa_library_call(torch, dev, qt, kt, vt, win: int = SWA_SHAPE[4]):
    """``F.scaled_dot_product_attention`` over (B, H, S, dh) inputs with the
    window as a boolean mask and GQA: the library call of the SWA rows."""
    import torch.nn.functional as F

    s = qt.shape[2]
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


HYMBA_SWA = (1, 32768, 25, 5, 64, 1024)  # hymba-1.5b's prefill: B, S, H, G, dh, window
# phase 15's heads held against the plain version: the first, the first of
# the second KV group, the last
HYMBA_HEADS = (0, 5, 24)


def _swa_hymba_row(torch, dev, gen) -> dict:
    """The bf16 tensor-core SWA kernel at hymba-1.5b's windowed layers
    (25 query heads over 5 KV heads, dh 64, window 1024, S=32768): its
    event-timed ms and device ms, the bound and
    ``F.scaled_dot_product_attention``'s time (phase 15 holds the kernel's
    output in the prefill against the plain version)."""
    from repro_torch.kernels.swa import ops as swa_ops

    b, s, h, g, dh, win = HYMBA_SWA
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=dev).to(torch.bfloat16)
               for n in (h, g, g))
    ms = time_ms(torch, lambda: swa_ops.swa_attention(q, k, v, window=win), reps=10, warmup=2)
    dev_ms = kernel_device_ms(torch, lambda: swa_ops.swa_attention(q, k, v, window=win),
                              ("swa_tc_kernel",), reps=10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(torch, _swa_library_call(torch, dev, qt, kt, vt, win), reps=3, warmup=1)
    b_ms, b_by = swa_bound(b, s, h, g, dh, win, 2)
    print(f"kernel swa_attention_tc at hymba-1.5b's heads B={b} S={s} H={h} G={g} dh={dh} "
          f"window={win} bf16: kernel_ms {ms:.4f} device_ms {dev_ms:.4f} library_ms "
          f"{lib:.4f} (F.scaled_dot_product_attention, bool mask, enable_gqa) bound_ms "
          f"{b_ms:.4f} ({b_by}), share of the bound {b_ms / ms:.3f} (device "
          f"{b_ms / dev_ms:.3f})", flush=True)
    return {"shape_hymba": list(HYMBA_SWA), "ms_hymba": ms, "device_ms_hymba": dev_ms,
            "library_ms_hymba": lib, "bound_ms_hymba": b_ms, "bound_share_hymba": b_ms / ms}


# the selective-scan kernel (hybrid blocks' Mamba heads; no TPU kernel) at
# hymba-1.5b's prefill, (B, S, d_inner, n), in bf16, and an fp32 shape;
# against its plain version within rtol SCAN_RTOL and SCAN_ATOL of the
# output's scale (the kernel's exps are MUFU.EX2's of dt a log2(e), its
# products fused, its sums in another order),
# and against an fp64 recurrence on the first SCAN_CHECK_CHANNELS channels
# within max(SCAN_FP64_VS_PLAIN x the plain version's error, SCAN_FP64_FLOOR
# of the scale)
SCAN_SHAPE = (1, 32768, 3200, 16)
SCAN_FP32_SHAPE = (1, 8192, 3200, 16)
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5
SCAN_FP64_VS_PLAIN, SCAN_FP64_FLOOR = 2.0, 1e-6
SCAN_CHECK_CHANNELS = 256
# exps a clock on an SM: MUFU.EX2 throughput of compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instructions table)
MUFU_PER_CLOCK = 16
# fp32 operations of one (t, d, j) update besides its exp: dt a, decay h,
# dtx b, the add, h c and its sum
SCAN_FLOPS = 6
SCAN_FIELDS = ("shape", "max_abs_err", "fp64_max_abs_err", "ms", "device_ms", "plain_ms",
               "bound_ms", "bound_by", "plan", "registers", "mufu_ex2_step")


def _scan_inputs(torch, dev, gen, shape, dtype):
    """x, dt (the softplus of a normal, positive as the model's), b, c and
    a_log (the model's log(1..n) on every channel) of (B, S, di, n)."""
    bsz, s, di, n = shape
    x = torch.randn((bsz, s, di), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, di), generator=gen, device=dev)
                                      - 1.0)
    b, c = torch.randn((2, bsz, s, n), generator=gen, device=dev)
    a_log = torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32)).repeat(di, 1)
    return [t.to(dtype).contiguous() for t in (x, dt, b, c, a_log)]


def scan_fp64(torch, x, dt, b, c, a_log, block: int = 256):
    """The selective scan's recurrence in fp64 (dt x rounded in the inputs'
    dtype first, as the contract rounds it), ``block`` steps' decays and
    inputs at a time: (B, S, di) fp64."""
    a = -torch.exp(a_log.double())
    dtx = (dt * x).double()
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]), dtype=torch.float64,
                    device=x.device)
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for t0 in range(0, x.shape[1], block):
        sl = slice(t0, t0 + block)
        decay = torch.exp(dt[:, sl, :, None].double() * a)
        inp = dtx[:, sl, :, None] * b[:, sl, None, :].double()
        hs = []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inp[:, t]
            hs.append(h)
        y[:, sl] = (torch.stack(hs, 1) * c[:, sl, None, :].double()).sum(-1)
    return y


def scan_bound(torch, dev, shape, elem_bytes: int) -> tuple[float, str, str]:
    """Least time in ms of one selective scan of ``shape``, and what bounds
    it, with the parts: x and dt read and y (fp32) written once, b and c
    read once, over the memory rate; S di n exps at MUFU_PER_CLOCK a clock
    on each SM at the card's maximum SM clock (read from nvidia-smi); and
    SCAN_FLOPS fp32 operations an update at the fp32 peak."""
    bsz, s, di, n = shape
    nbytes = bsz * s * (2 * di + 2 * n) * elem_bytes + bsz * s * di * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(card_line("clocks.max.sm").split()[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = bsz * s * di * n / (MUFU_PER_CLOCK * sms * mhz * 1e6) * 1e3
    t_ops = SCAN_FLOPS * bsz * s * di * n / FP32_FLOPS * 1e3
    text = (f"bytes {t_bytes:.4f}, exps {t_exp:.4f} ({MUFU_PER_CLOCK} a clock x {sms} SMs "
            f"x {mhz:.0f} MHz), fp32 operations {t_ops:.4f}")
    if t_bytes >= max(t_exp, t_ops):
        return t_bytes, "bytes", text
    return max(t_exp, t_ops), "operations", text


def _scan_row(torch, dev, gen, shape, dtype, res: dict[str, dict]) -> dict:
    """The scan wrapper at ``shape`` in ``dtype`` against its plain version
    (timed once: one launch a step and op) and an fp64 recurrence on a
    channel slice, the same bits from two calls, with its event-timed
    ``ms``, ``device_ms`` (the profiler's records of its launch), the
    bound, and from ``res`` (``kernel_resources``) its registers, stack (none
    allowed) and MUFU.EX2 count in the step loop (one a step and state
    required)."""
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.kernels.scan.ref import selective_scan_ref

    label = f"selective_scan {tuple(shape)} {str(dtype)[6:]}"
    ins = _scan_inputs(torch, dev, gen, shape, dtype)
    before = scan_ops.LAUNCHES["selective_scan"]
    got = scan_ops.selective_scan(*ins)
    check(scan_ops.LAUNCHES["selective_scan"] == before + 1, f"{label}: no launch counted")
    same = torch.equal(got, scan_ops.selective_scan(*ins))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = selective_scan_ref(*ins)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, rtol=SCAN_RTOL, atol=SCAN_ATOL * scale))
    sl = slice(0, SCAN_CHECK_CHANNELS)
    x, dt, b, c, a_log = ins
    exact = scan_fp64(torch, x[..., sl].contiguous(), dt[..., sl].contiguous(), b, c,
                      a_log[sl].contiguous())
    fp64 = {k: float((y[..., sl].double() - exact).abs().max())
            for k, y in (("kernel", got), ("plain", ref))}
    limit = max(SCAN_FP64_VS_PLAIN * fp64["plain"], SCAN_FP64_FLOOR * float(exact.abs().max()))
    del exact, ref
    check(ok, f"{label}: outside rtol {SCAN_RTOL} / atol {SCAN_ATOL} x {scale:.3g} of the "
              f"plain version (max abs err {err:.3g})")
    check(same, f"{label}: not the same bits from run to run")
    check(fp64["kernel"] <= limit, f"{label}: max abs err against fp64 {fp64['kernel']:.3g} "
                                   f"> {limit:.3g} (plain version's {fp64['plain']:.3g})")
    bsz, _, di, _ = shape
    plan = scan_ops.device_plan(bsz, di, x.element_size(), dev)
    slots = scan_ops.MAX_STATE // scan_ops.LANES
    fn = f"{scan_ops.KERNEL}<{'bf16' if dtype == torch.bfloat16 else 'float'}>"
    facts = res.get(fn, {})
    per_step = facts.get("mufu_ex2_loop", 0) / (scan_ops.TILE * slots)
    check(facts.get("stack") == 0, f"{label}: {fn} has a stack frame of {facts.get('stack')} B "
                                   f"(spills) or none was read: {facts}")
    check(per_step == 1, f"{label}: {facts.get('mufu_ex2_loop')} MUFU.EX2 in {fn}'s step loop "
                         f"of {scan_ops.TILE} steps x {slots} states, not one each")
    b_ms, b_by, b_text = scan_bound(torch, dev, shape, x.element_size())
    row = {"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
           "fp64_max_abs_err": fp64["kernel"], "fp64_max_abs_err_plain": fp64["plain"],
           "tolerance": f"rtol {SCAN_RTOL}, atol {SCAN_ATOL} x max|y|",
           "plan": list(plan), "registers": facts.get("registers"), "mufu_ex2_step": per_step,
           "ms": time_ms(torch, lambda: scan_ops.selective_scan(*ins)),
           "device_ms": kernel_device_ms(torch, lambda: scan_ops.selective_scan(*ins),
                                         (scan_ops.KERNEL,)),
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"kernel {label}: max abs err {err:.3g} of max|y| {scale:.3g} (tol rtol {SCAN_RTOL}, "
          f"atol {SCAN_ATOL} x max|y|), against fp64 on {SCAN_CHECK_CHANNELS} channels "
          f"{fp64['kernel']:.3g} (plain {fp64['plain']:.3g}, limit {limit:.3g}), two calls "
          f"bit-equal; {plan.groups} blocks a row of {plan.warps} warps, {slots} states a "
          f"lane; {fn}: {facts.get('registers')} registers, stack {facts.get('stack')} B, "
          f"{facts.get('mufu_ex2_loop')} MUFU.EX2 in the step loop ({per_step:g} a step and "
          f"state; {facts.get('mufu_ex2')} in all); kernel_ms "
          f"{row['ms']:.4f} device_ms {row['device_ms']:.4f} plain_ms {plain_ms:.1f} (one "
          f"call: a loop over S) library_ms null (no PyTorch call computes a selective scan) "
          f"bound_ms {b_ms:.4f} ({b_by}; {b_text}); device {b_ms / row['device_ms']:.3f} of "
          f"the bound; card right after (SM clock, power, temperature): {card_state()}",
          flush=True)
    return row


def _scan_rows(torch, dev, gen, res: dict[str, dict]) -> dict[str, dict]:
    """The scan kernel's row: hymba's prefill shape in bf16, and an fp32
    shape (suffix ``_fp32``)."""
    row = {"name": "selective_scan",
           **_scan_row(torch, dev, gen, SCAN_SHAPE, torch.bfloat16, res)}
    fp32 = _scan_row(torch, dev, gen, SCAN_FP32_SHAPE, torch.float32, res)
    row.update({f"{k}_fp32": fp32[k] for k in SCAN_FIELDS})
    return {"selective_scan": row}


# the backward kernel (phase 2): hymba's train shape (a replica's 2 rows of
# 2048 tokens) and a long one at full width, each in bf16 and fp32
SCAN_BWD_SHAPE = (2, 2048, 3200, 16)
SCAN_BWD_LONG = (1, 8192, 3200, 16)
# against the plain backward: fp32 each gradient within rtol and atol x its
# largest value (the exps MUFU.EX2's, the products fused, the sums over
# lanes, channels, blocks and time in other orders); bf16 one bf16 ulp and
# 2^-7 of the largest value (du and the decay's part of ddt round to bf16
# before their products and sum); against an fp64 backward within
# SCAN_FP64_VS_PLAIN x the plain backward's error, or SCAN_FP64_FLOOR of the
# scale (tests/test_torch_cuda_kernels.py holds the same)
SCAN_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
SCAN_BWD_NAMES = ("dx", "ddt", "db", "dc", "da_log")
# fp32 instructions a (t, d, j) of the gradient besides its exp, each an
# FMA or a product: the recompute of h 3 (dt a2, u b, h's fma) and the
# reverse step 9 (g's fma, g h, . decay, the carry, the fmas of du, of
# ddt's part and of da, and db's g u and dc's dy h each summed over the
# channels by an fma); as FLOPs, an FMA two, 19
SCAN_BWD_INSTRUCTIONS = 12
SCAN_BWD_FLOPS = 19
# fp32 add, multiply and FMA results a clock on an SM (compute capability
# 9.0, CUDA C++ Programming Guide, arithmetic instructions table)
FP32_LANES_PER_CLOCK = 128
SCAN_BWD_FIELDS = ("shape", "max_abs_err", "fp64_max_abs_err", "fp64_max_abs_err_plain",
                   "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                   "plan", "registers", "sum_registers", "blocks_per_sm")


def scan_bwd_bound(torch, dev, shape, elem_bytes: int, groups: int
                   ) -> tuple[float, str, str]:
    """Least time in ms of one scan backward of ``shape``, and what bounds
    it, with the parts: the bytes the function must move, x, dt
    (elem_bytes), dy (fp32), b, c and a_log read, the forward's checkpoints
    (fp32, one state a channel every TILE steps: the backward's input in
    this contract) read, and dx, ddt, db, dc and da_log written, each once,
    over the memory rate; B S di n exps at MUFU_PER_CLOCK a clock on each
    SM at the card's maximum SM clock; SCAN_BWD_INSTRUCTIONS fp32
    instructions a (t, d, j) at FP32_LANES_PER_CLOCK a clock on each SM at
    that clock, and SCAN_BWD_FLOPS FLOPs at the fp32 peak, the larger of
    the two.  The blocks' partials of db and dc (2 x ``groups`` B S n fp32,
    written and read again) are this design's scratch: named in the text,
    not counted."""
    from repro_torch.kernels.scan import ops as scan_ops

    bsz, s, di, n = shape
    tiles = -(-s // scan_ops.TILE)
    nbytes = (bsz * s * di * (4 * elem_bytes + 4) + 4 * bsz * s * n * elem_bytes
              + 2 * di * n * elem_bytes + bsz * tiles * di * n * 4)
    scratch = 2 * 2 * groups * bsz * s * n * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hz = float(card_line("clocks.max.sm").split()[0]) * 1e6
    cells = bsz * s * di * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = cells / (MUFU_PER_CLOCK * sms * hz) * 1e3
    t_issue = SCAN_BWD_INSTRUCTIONS * cells / (FP32_LANES_PER_CLOCK * sms * hz) * 1e3
    t_flops = SCAN_BWD_FLOPS * cells / FP32_FLOPS * 1e3
    t_ops = max(t_exp, t_issue, t_flops)
    text = (f"bytes {t_bytes:.4f} ({nbytes / 1e9:.4f} GB; the partials of {groups} blocks a "
            f"row, {scratch / 1e9:.4f} GB written and read, not counted), exps {t_exp:.4f}, "
            f"fp32 instructions {t_issue:.4f}, FLOPs {t_flops:.4f}")
    if t_bytes >= t_ops:
        return t_bytes, "bytes", text
    return t_ops, "operations", text


def _scan_bwd_row(torch, dev, gen, shape, dtype, res: dict[str, dict]) -> dict:
    """The backward wrapper (``scan_ops._launch_bwd``) at ``shape`` in
    ``dtype`` from the saving forward's checkpoints (its y bit-equal to
    the no-grad launch's): each gradient against the plain backward (timed
    once) within SCAN_BWD_TOL and against its fp64 mode within
    SCAN_FP64_VS_PLAIN x the plain backward's error, the same bits from two
    calls and through autograd of the wrapper, with its event-timed ``ms``,
    ``device_ms`` (the profiler's records of its two launches), the bound,
    the registers of its two kernel functions (no stack allowed in the
    walk) and the walk's resident blocks an SM (the CUDA occupancy API)."""
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.kernels.scan.ref import selective_scan_bwd_ref

    name = str(dtype)[6:]
    label = f"selective_scan_bwd {tuple(shape)} {name}"
    ins = _scan_inputs(torch, dev, gen, shape, dtype)
    dy = torch.randn(shape[:3], generator=gen, device=dev)
    y0 = scan_ops.selective_scan(*ins)
    y, ckpt = scan_ops._launch(*ins, save=True)
    check(torch.equal(y, y0), f"{label}: the saving forward's y is not the no-grad forward's")
    del y, y0
    before = scan_ops.LAUNCHES["selective_scan_bwd"]
    got = scan_ops._launch_bwd(*ins, dy, ckpt)
    check(scan_ops.LAUNCHES["selective_scan_bwd"] == before + 1, f"{label}: no launch counted")
    same = all(torch.equal(a, b) for a, b in zip(got, scan_ops._launch_bwd(*ins, dy, ckpt)))
    leaves = [t.detach().requires_grad_() for t in ins]
    wired = all(torch.equal(a, b) for a, b in zip(got, torch.autograd.grad(
        scan_ops.selective_scan(*leaves), leaves, dy)))
    del leaves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = selective_scan_bwd_ref(*ins, dy)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    exact = selective_scan_bwd_ref(*ins, dy, acc=torch.float64)
    rtol, atol = SCAN_BWD_TOL[name]
    errs, fp64, fp64_plain, texts = {}, {}, {}, []
    for gname, g, w, e in zip(SCAN_BWD_NAMES, got, want, exact):
        scale = float(w.float().abs().max())
        errs[gname] = float((g.float() - w.float()).abs().max())
        ok = bool(torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol * scale))
        check(ok, f"{label}: {gname} outside rtol {rtol:.3g} / atol {atol:.3g} x {scale:.3g} of "
                  f"the plain backward (max abs err {errs[gname]:.3g})")
        fp64[gname], fp64_plain[gname] = (float((t.double() - e).abs().max()) for t in (g, w))
        limit = max(SCAN_FP64_VS_PLAIN * fp64_plain[gname],
                    SCAN_FP64_FLOOR * float(e.abs().max()))
        check(fp64[gname] <= limit, f"{label}: {gname} against fp64 {fp64[gname]:.3g} > "
                                    f"{limit:.3g} (the plain backward's {fp64_plain[gname]:.3g})")
        texts.append(f"{gname} {errs[gname]:.3g} of {scale:.3g} (fp64: {fp64[gname]:.3g}, "
                     f"plain {fp64_plain[gname]:.3g})")
    del want, exact
    check(same, f"{label}: not the same bits from run to run")
    check(wired, f"{label}: autograd of the wrapper gave other bits than the backward wrapper")
    bsz, _, di, _ = shape
    plan = scan_ops.device_plan(bsz, di, ins[0].element_size(), dev, backward=True)
    targ = "bf16" if dtype == torch.bfloat16 else "float"
    # the walk's two instances: n = 16 (hymba's, the one timed here) and any n
    fn, other = (f"{scan_ops.BWD_KERNEL}<{targ}, {whole}>" for whole in (1, 0))
    facts, other_facts = res.get(fn, {}), res.get(other, {})
    sum_regs = res.get(f"{scan_ops.BWD_SUM_KERNEL}<{targ}>", {}).get("registers")
    for kname, f in ((fn, facts), (other, other_facts)):
        check(f.get("stack") == 0, f"{label}: {kname} has a stack frame of {f.get('stack')} B "
                                   f"(spills) or none was read: {f}")
    blocks_sm = scan_ops.bwd_blocks_per_sm(plan.warps, ins[0].element_size())
    built = scan_ops.built_bwd_layout(plan.warps, ins[0].element_size())
    check(built == scan_ops.bwd_layout(plan.warps, ins[0].element_size()),
          f"{label}: the built layout {built} is not ops' mirror "
          f"{scan_ops.bwd_layout(plan.warps, ins[0].element_size())}")
    b_ms, b_by, b_text = scan_bwd_bound(torch, dev, shape, ins[0].element_size(), plan.groups)

    def call():
        return scan_ops._launch_bwd(*ins, dy, ckpt)

    row = {"shape": list(shape), "dtype": name, "max_abs_err": max(errs.values()),
           "max_abs_err_by_gradient": errs, "fp64_max_abs_err": max(fp64.values()),
           "fp64_max_abs_err_plain": max(fp64_plain.values()),
           "tolerance": f"rtol {rtol:.3g}, atol {atol:.3g} x max|gradient|",
           "plan": list(plan), "registers": facts.get("registers"),
           "sum_registers": sum_regs, "blocks_per_sm": blocks_sm, "ms": time_ms(torch, call),
           "device_ms": kernel_device_ms(torch, call, (scan_ops.BWD_KERNEL,
                                                        scan_ops.BWD_SUM_KERNEL), launches=2),
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    row["bound_share"] = b_ms / row["device_ms"]
    print(f"kernel {label}: the saving forward's y bit-equal to the no-grad one; max abs err "
          f"against the plain backward (tol rtol {rtol:.3g}, atol {atol:.3g} x max|gradient|; "
          f"fp64 limit {SCAN_FP64_VS_PLAIN:g} x the plain's or {SCAN_FP64_FLOOR:g} x max): "
          + "; ".join(texts) + f"; two calls and autograd of the wrapper bit-equal; "
          f"{plan.groups} blocks a row of {plan.warps} warps, {blocks_sm} resident an SM "
          f"({blocks_sm * plan.warps} warps); {fn}: {facts.get('registers')} registers, "
          f"stack {facts.get('stack')} B ({other}: {other_facts.get('registers')}, "
          f"{other_facts.get('stack')} B); {scan_ops.BWD_SUM_KERNEL}<{targ}>: "
          f"{sum_regs} registers; kernel_ms {row['ms']:.4f} device_ms "
          f"{row['device_ms']:.4f} plain_ms {plain_ms:.1f} (one call: loops over S) "
          f"library_ms null (no PyTorch call computes a selective scan's gradient) bound_ms "
          f"{b_ms:.4f} ({b_by}; {b_text}); device {row['bound_share']:.3f} of the bound; card "
          f"right after (SM clock, power, temperature): {card_state()}", flush=True)
    return row


def _scan_bwd_rows(torch, dev, gen, res: dict[str, dict]) -> dict[str, dict]:
    """The backward kernel's row: hymba's train shape in bf16 (the main
    path's), in fp32 (suffix ``_fp32``), and the long shape in both
    (``_long``, ``_long_fp32``)."""
    row = {"name": "selective_scan_bwd",
           **_scan_bwd_row(torch, dev, gen, SCAN_BWD_SHAPE, torch.bfloat16, res)}
    for suffix, shape, dtype in (("_fp32", SCAN_BWD_SHAPE, torch.float32),
                                 ("_long", SCAN_BWD_LONG, torch.bfloat16),
                                 ("_long_fp32", SCAN_BWD_LONG, torch.float32)):
        other = _scan_bwd_row(torch, dev, gen, shape, dtype, res)
        row.update({f"{k}{suffix}": other[k] for k in SCAN_BWD_FIELDS})
    return {"selective_scan_bwd": row}


SLSTM_SHAPE = (1, 4096, 4, 192)  # xlstm-125m's sLSTM heads: B, S, H, dh
# the sLSTM kernel against an fp64 recurrence (fp32) or the fp32 one (bf16):
# its largest error on hs within this multiple of the plain loop's, or the
# floor
SLSTM_FP64_VS_PLAIN, SLSTM_FLOOR = 2.0, 1e-6
SLSTM_FIELDS = ("shape", "max_abs_err", "fp64_max_abs_err", "fp64_max_abs_err_plain", "ms",
                "device_ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
                "serial_floor_ms", "sync_loop_ms", "serial_floor_ms_design",
                "sync_loop_ms_design")
# the serial floor's yardstick, fixed across designs: the first sLSTM
# kernel's launch shape at dh 192, a cluster of 4 CTAs of 12 warps meeting
# at a block barrier a step (the kernel's own shape gives
# serial_floor_ms_design beside it)
SLSTM_FLOOR_CLUSTER, SLSTM_FLOOR_WARPS = 4, 12


def _slstm_inputs(torch, dev, gen, shape, dtype):
    """pre_x (B, S, 4, H, dh) normal, R of the model's 1/sqrt(dh) scale, a
    zero bias (the model's init) and the model's initial state (zeros, m =
    -1e30), the first three in ``dtype``."""
    bsz, s, h, dh = shape
    pre = torch.randn((bsz, s, 4, h, dh), generator=gen, device=dev).to(dtype)
    r = (torch.randn((4, h, dh, dh), generator=gen, device=dev) / dh ** 0.5).to(dtype)
    b = torch.zeros((4, h, dh), device=dev).to(dtype)
    z = torch.zeros((bsz, h, dh), device=dev)
    return pre, r, b, (z, z.clone(), z.clone(), torch.full_like(z, -1e30))


def slstm_fp64(torch, pre, r, b, st):
    """The sLSTM recurrence in fp64 on the inputs' values (no rounding of h
    or of the sums): hs (B, S, H, dh) fp64."""
    c, n, h, m = (t.double() for t in st)
    rd, bd = r.double(), b.double()
    hs = torch.empty((pre.shape[0], pre.shape[1], *pre.shape[3:]), dtype=torch.float64,
                     device=pre.device)
    for t in range(pre.shape[1]):
        i, f, z, o = (pre[:, t].double() + torch.einsum("bhk,ghkj->bghj", h, rd) + bd
                      ).unbind(1)
        log_f = torch.nn.functional.logsigmoid(f)
        m_new = torch.maximum(log_f + m, i)
        i_s, f_s = torch.exp(i - m_new), torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(z)
        n = f_s * n + i_s
        m = m_new
        h = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
        hs[:, t] = h
    return hs


def slstm_bound(torch, dev, shape, elem_bytes: int, clusters: tuple[int, ...]
                ) -> tuple[float, str, list[float], str]:
    """The sLSTM kernel's two bounds at ``shape``: (bound_ms, bound_by), the
    bytes (pre_x, R and the bias read once, hs and the state written once,
    the state read once) over the memory rate against 2 x 4 H dh^2 S B
    operations at the peak of the inputs' type (``op_peak``); and the
    serial floor's product part for each cluster size in ``clusters``: S
    times one step's product on one CTA of the cluster, 4 dh (dh / cluster)
    FMAs at one SM's share of the fp32 peak, the design's CUDA-core product
    (the signalling part is timed)."""
    bsz, s, h, dh = shape
    nbytes = (bsz * s * 4 * h * dh + 4 * h * dh * dh + 4 * h * dh) * elem_bytes \
        + bsz * s * h * dh * 4 + 2 * 4 * bsz * h * dh * 4
    flops = 2 * 4 * h * dh * dh * s * bsz
    peak, peak_name = op_peak(elem_bytes)
    b_ms, b_by = bound(nbytes, flops, peak)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_step = [2 * 4 * dh * (dh // nc) / (FP32_FLOPS / sms) * 1e3 for nc in clusters]
    text = (f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f}, operations "
            f"{flops / peak * 1e3:.4f} at the {peak_name} peak; serial product floor "
            + ", ".join(f"{s} x {ps * 1e3:.4f} us (4 x {dh} x {dh // nc} FMAs at 1/{sms} of "
                        f"the fp32 peak, a cluster of {nc})"
                        for nc, ps in zip(clusters, per_step)))
    return b_ms, b_by, [s * ps for ps in per_step], text


def _timed_plain(torch, ins):
    """The plain sLSTM loop on ``ins`` (timed once, host clock to a sync:
    ~20 launches a step): (hs, ms)."""
    from repro_torch.kernels.slstm.ref import slstm_scan_ref

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs, _ = slstm_scan_ref(*ins)
    torch.cuda.synchronize()
    return hs, (time.perf_counter() - t0) * 1e3


def _slstm_sync_ms(torch, dev, path: Path, shape, cluster: int, warps: int,
                   per_warp: bool) -> float:
    """Event-timed ms of a launch shape (``cluster`` CTAs of ``warps`` warps
    for each (row, head) of ``shape``) running S steps of a per-step
    synchronisation alone, no arithmetic (a serial floor's signalling part):
    ``repro_slstm_sync_loop`` of ``slstm.cu`` built with -DSLSTM_SYNC_PROBE
    (``VARIANT_BUILDS``) at ``path``.  ``per_warp`` False: the yardstick's
    protocol (a block barrier, then one thread sends a value to every
    CTA); True: this kernel's (each warp waits, then for each of its 4
    units one lane a CTA sends 4 bytes to that CTA)."""
    import ctypes

    bsz, s, h, _ = shape
    fn = ctypes.CDLL(str(path)).repro_slstm_sync_loop
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = torch.empty((bsz * h * cluster,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(scratch.data_ptr(), bsz, s, h, cluster, warps, int(per_warp), stream)
        check(err == 0, f"slstm sync probe: launch error {err}")

    return time_ms(torch, launch, reps=10)


def _slstm_row(torch, dev, ins, res: dict, sync_lib: Path, plain=None, exact=None
               ) -> dict:
    """The sLSTM wrapper on ``ins`` (pre_x, R, the bias, the state) against
    its plain loop (``plain``: its hs and ms, else run here), the same bits
    from two calls, and the fp64 gate: fp32, the kernel's error on hs
    against an fp64 recurrence within SLSTM_FP64_VS_PLAIN x the plain fp32
    loop's; bf16, its distance from the fp32 recurrence (``exact``) within
    that multiple of the plain bf16 loop's.  Event-timed ``ms``,
    ``device_ms`` from the profiler, the bound and two serial floors (S x
    one step's product + a per-step synchronisation alone, timed on the
    probe build at ``sync_lib``: ``_slstm_sync_ms``): the fixed yardstick
    (``serial_floor_ms``: SLSTM_FLOOR_CLUSTER CTAs of SLSTM_FLOOR_WARPS
    warps, a block barrier a step) and this design's own
    (``serial_floor_ms_design``: its cluster and warps, its per-warp
    sends)."""
    from repro_torch.kernels.slstm import ops as slstm_ops

    pre, r, b, st = ins
    dtype = pre.dtype
    shape = (pre.shape[0], pre.shape[1], pre.shape[3], pre.shape[4])
    label = f"slstm {tuple(shape)} {str(dtype)[6:]}"
    before = slstm_ops.LAUNCHES["slstm"]
    got, out = slstm_ops.slstm_scan(pre, r, b, st)
    check(slstm_ops.LAUNCHES["slstm"] == before + 1, f"{label}: no launch counted")
    again, out2 = slstm_ops.slstm_scan(pre, r, b, st)
    same = torch.equal(got, again) and all(torch.equal(x, y) for x, y in zip(out, out2))
    del again, out2
    plain, plain_ms = plain or _timed_plain(torch, ins)
    err = float((got - plain).abs().max())
    if dtype == torch.float32:
        exact, kind = slstm_fp64(torch, pre, r, b, st), "fp64"
    else:
        exact, kind = exact.double(), "fp32"
    dist = {k: float((y.double() - exact).abs().max()) for k, y in (("kernel", got),
                                                                    ("plain", plain))}
    limit = max(SLSTM_FP64_VS_PLAIN * dist["plain"], SLSTM_FLOOR)
    del exact, plain
    check(same, f"{label}: not the same bits from run to run")
    check(dist["kernel"] <= limit, f"{label}: max abs err against the {kind} recurrence "
                                   f"{dist['kernel']:.3g} > {limit:.3g} (plain loop's "
                                   f"{dist['plain']:.3g})")
    bsz, s, h, dh = shape
    built = slstm_ops.built_layout(dh)  # the design floor's shape, as the kernel is built
    check(built == slstm_ops.layout(dh), f"{label}: the built layout {built} is not ops' "
                                         f"mirror {slstm_ops.layout(dh)}")
    nc, warps = built[:2]
    b_ms, b_by, (floor_ms, floor_design), b_text = slstm_bound(
        torch, dev, shape, pre.element_size(), (SLSTM_FLOOR_CLUSTER, nc))
    sync_ms = _slstm_sync_ms(torch, dev, sync_lib, shape, SLSTM_FLOOR_CLUSTER,
                             SLSTM_FLOOR_WARPS, per_warp=False)
    sync_design = _slstm_sync_ms(torch, dev, sync_lib, shape, nc, warps, per_warp=True)
    fn = lambda: slstm_ops.slstm_scan(pre, r, b, st)  # noqa: E731
    row = {"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
           "fp64_max_abs_err": dist["kernel"], "fp64_max_abs_err_plain": dist["plain"],
           "fp64_reference": kind,
           "tolerance": f"against the {kind} recurrence within {SLSTM_FP64_VS_PLAIN} x the "
                        f"plain loop's error",
           "ms": time_ms(torch, fn, reps=10, warmup=2),
           "device_ms": kernel_device_ms(torch, fn, (slstm_ops.KERNEL,), reps=10),
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "serial_floor_ms": floor_ms + sync_ms, "sync_loop_ms": sync_ms,
           "serial_floor_ms_design": floor_design + sync_design,
           "sync_loop_ms_design": sync_design, "library_ms": None}
    row["us_per_step"] = row["device_ms"] / s * 1e3
    regs = {k: v for k, v in res.items() if k.startswith("slstm_kernel")}
    print(f"kernel {label}: max abs err on hs against the plain loop {err:.3g}; against "
          f"the {kind} recurrence {dist['kernel']:.3g} (plain loop {dist['plain']:.3g}, "
          f"limit {limit:.3g}); two calls bit-equal; a cluster of "
          f"{nc} CTAs of {warps} + 1 warps for each of {bsz * h} (row, "
          f"head); kernel_ms {row['ms']:.4f} device_ms {row['device_ms']:.4f} "
          f"({row['us_per_step']:.3f} us a step) plain_ms {plain_ms:.1f} (one call: a "
          f"loop over S) library_ms null (no PyTorch call computes an sLSTM: nn.LSTM has "
          f"sigmoid gates and no normalizer) "
          f"bound_ms {b_ms:.4f} ({b_by}; {b_text}); serial floor {row['serial_floor_ms']:.4f} "
          f"ms at the yardstick shape (product {floor_ms:.4f} at a cluster of "
          f"{SLSTM_FLOOR_CLUSTER} + "
          f"its per-step synchronisation alone {sync_ms:.4f}); this design's floor "
          f"{row['serial_floor_ms_design']:.4f} ms (product {floor_design:.4f} at a cluster of "
          f"{nc} + its synchronisation alone {sync_design:.4f}); device "
          f"{b_ms / row['device_ms']:.4f} of the bound, "
          f"{row['serial_floor_ms'] / row['device_ms']:.3f} of the serial floor "
          f"({row['serial_floor_ms_design'] / row['device_ms']:.3f} of its own); registers "
          f"{ {k: v.get('registers') for k, v in regs.items()} }; card right after (SM "
          f"clock, power, temperature): {card_state()}", flush=True)
    return row


def _slstm_rows(torch, dev, gen, res: dict, sync_lib: Path) -> dict[str, dict]:
    """The sLSTM kernel's row: xlstm-125m's heads at S=4096 in bf16, and in
    fp32 (suffix ``_fp32``) on the same values widened, whose plain loop is
    the bf16 row's fp32 recurrence."""
    pre, r, b, st = _slstm_inputs(torch, dev, gen, SLSTM_SHAPE, torch.bfloat16)
    ins32 = (pre.float(), r.float(), b.float(), st)
    plain32 = _timed_plain(torch, ins32)
    row = {"name": "slstm", **_slstm_row(torch, dev, (pre, r, b, st), res, sync_lib,
                                         exact=plain32[0])}
    fp32 = _slstm_row(torch, dev, ins32, res, sync_lib, plain=plain32)
    row.update({f"{k}_fp32": fp32[k] for k in SLSTM_FIELDS})
    return {"slstm": row}


SLSTM_BWD_SHAPE = (2, 2048, 4, 192)  # xlstm-125m's train step a replica: B, S, H, dh
SLSTM_BWD_NAMES = ("d pre_x", "dR", "db", "dc0", "dn0", "dh0", "dm0")
# the backward kernel against its plain version on the same inputs (the
# reverse walk over the saving forward's rows): each gradient within rtol
# and atol x its largest value (the gates on ex2.approx / rcp.approx, the
# recurrent sums in another order, carried over S steps); bf16 two bf16
# ulps, a sum rounding the other way moving later steps' dpre by an ulp.
# The whole path (saving forward + backward) against fp64 (fp32): each
# gradient's largest error within SLSTM_FP64_VS_PLAIN x the plain path's, or
# SLSTM_BWD_FLOOR of the scale; against the fp32 backward (bf16): each
# gradient's relative L2 distance within SLSTM_FP64_VS_PLAIN x the plain
# bf16 path's, and its largest error within SLSTM_BWD_MAX_VS_PLAIN x the
# plain path's (the largest error of a bf16 gradient is one element's
# rounding history: two bf16 paths' differ by up to 2.41x where their L2
# distances differ by at most 1.32x; the readings of
# ``tools/slstm_bwd_bf16_readings.py``, PERF.md §6)
SLSTM_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -6)}
SLSTM_BWD_MAX_VS_PLAIN = 4.0
SLSTM_BWD_FLOOR = 1e-6
SLSTM_BWD_FIELDS = ("shape", "max_abs_err", "fp64_max_abs_err", "fp64_max_abs_err_plain", "ms",
                    "device_ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
                    "serial_floor_ms", "sync_loop_ms", "registers", "stack", "fwd_ms",
                    "fwd_save_ms", "fwd_device_ms", "fwd_save_device_ms", "fwd_us_per_step")


def slstm_bwd_bound(torch, dev, shape, elem_bytes: int, cluster: int
                    ) -> tuple[float, str, float, str]:
    """The sLSTM backward kernel's bound at ``shape``: (bound_ms, bound_by)
    of the bytes it must move (the saved rows, 7 fp32 a unit and step, and
    d hs read once, R read once, d pre_x written once in the model's dtype,
    the final state's gradients read and the initial state's written once)
    against its 2 x 4 H dh^2 S B operations (the transposed recurrent
    product) at the peak of the inputs' type (``op_peak``); and the serial
    floor's product part, S times one step's product on one CTA of the
    cluster, 4 dh (dh / cluster) FMAs at one SM's share of the fp32 peak,
    the design's CUDA-core product."""
    bsz, s, h, dh = shape
    nbytes = (bsz * s * h * dh * (8 * 4 + 4 * elem_bytes) + 4 * h * dh * dh * elem_bytes
              + 2 * 4 * bsz * h * dh * 4)
    flops = 2 * 4 * h * dh * dh * s * bsz
    peak, peak_name = op_peak(elem_bytes)
    b_ms, b_by = bound(nbytes, flops, peak)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_step = 2 * 4 * dh * (dh // cluster) / (FP32_FLOPS / sms) * 1e3
    text = (f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ({nbytes / 1e9:.4f} GB), "
            f"operations {flops / peak * 1e3:.4f} at the {peak_name} peak; serial product "
            f"floor {s} x {per_step * 1e3:.4f} us (4 x {dh} x {dh // cluster} FMAs at 1/{sms} "
            f"of the fp32 peak, a cluster of {cluster})")
    return b_ms, b_by, s * per_step, text


def _slstm_bwd_grads(torch, ops, r, h0, hs, saved, dhs, dtype):
    """The backward kernel's gradients, as the Function gives them: d pre_x
    and the initial state's from the walk, dR and db from its rows."""
    from repro_torch.kernels.slstm.ref import weight_grads

    zeros = tuple(torch.zeros_like(h0) for _ in range(4))
    dpx, d0 = ops._launch_bwd(r, saved, dhs, zeros, dtype)
    return (dpx, *weight_grads(h0, hs, dpx, dtype), *d0)


def _slstm_bwd_row(torch, dev, ins, res: dict, sync_lib: Path, plain32=None
                   ) -> tuple[dict, tuple]:
    """The sLSTM backward kernel (``slstm_ops._launch_bwd``) on ``ins``
    (pre_x, R, the bias, the state, d hs), from the saving
    forward's rows (its hs and final state bit-equal to the no-grad
    launch's): each gradient against the plain reverse walk over the same
    rows (timed) within SLSTM_BWD_TOL; the fp64 gate on the whole path
    against the plain one (the plain forward and walk): fp32, each
    gradient's error against the fp64 backward within SLSTM_FP64_VS_PLAIN x
    the plain path's; bf16, its relative L2 distance from the fp32 backward
    on the same values, ``plain32``, within that multiple of the plain bf16
    path's; the same bits from two calls and through
    autograd of the wrapper; registers and stack; event-timed ``ms``, the
    profiler's ``device_ms`` with the L2 written before each call, the bound
    and the serial floor (S x one step's product + the cluster's per-step
    signalling alone, the forward's design probe); the saving forward's time
    beside the no-grad launch's.  Returns the row and the plain gradients
    (an fp32 row's serve as the bf16 row's reference)."""
    from repro_torch.kernels.slstm import ops as slstm_ops
    from repro_torch.kernels.slstm.ref import slstm_bwd_walk_ref, slstm_scan_bwd_ref
    from repro_torch.kernels.slstm.ref import slstm_scan_save_ref

    pre, r, b, st, dhs = ins
    dtype = pre.dtype
    name = str(dtype)[6:]
    bsz, s, h, dh = shape = (pre.shape[0], pre.shape[1], pre.shape[3], pre.shape[4])
    label = f"slstm_bwd {tuple(shape)} {name}"
    hs0, out0 = slstm_ops.slstm_scan(pre, r, b, st)
    before = slstm_ops.LAUNCHES["slstm"]
    hs, out, saved = slstm_ops._launch(pre, r, b, st, save=True)
    check(slstm_ops.LAUNCHES["slstm"] == before + 1, f"{label}: no saving launch counted")
    check(torch.equal(hs, hs0) and all(torch.equal(x, y) for x, y in zip(out, out0)),
          f"{label}: the saving forward's hs is not the no-grad launch's")
    del hs0, out0
    before = slstm_ops.LAUNCHES["slstm_bwd"]
    got = _slstm_bwd_grads(torch, slstm_ops, r, st[2], hs, saved, dhs, dtype)
    check(slstm_ops.LAUNCHES["slstm_bwd"] == before + 1, f"{label}: no backward launch counted")
    same = all(torch.equal(x, y) for x, y in zip(
        got, _slstm_bwd_grads(torch, slstm_ops, r, st[2], hs, saved, dhs, dtype)))
    leaves = [t.detach().clone().requires_grad_() for t in (pre, r, b, *st)]
    wired = all(torch.equal(x, y) for x, y in zip(got, torch.autograd.grad(
        slstm_ops.slstm_scan(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]))[0], leaves,
        dhs)))
    del leaves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = slstm_bwd_walk_ref(r, st[2], saved, hs, dhs, None, dtype)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same_in = (walk[0], walk[1], walk[2], *walk[3])
    p_hs, _, p_saved = slstm_scan_save_ref(pre, r, b, st)
    walk = slstm_bwd_walk_ref(r, st[2], p_saved, p_hs, dhs, None, dtype)
    plain = (walk[0], walk[1], walk[2], *walk[3])
    del p_hs, p_saved, walk
    if dtype == torch.float32:
        ex = slstm_scan_bwd_ref(pre, r, b, st, dhs, acc=torch.float64)
        exact, kind, metric = (ex[0], ex[1], ex[2], *ex[3]), "fp64", "max abs err"
    else:
        exact, kind, metric = plain32, "fp32", "relative L2 distance"

    def largest(t, e):
        return float((t.double() - e.double()).abs().max())

    def distance(t, e):
        t, e = t.double(), e.double()
        if dtype == torch.float32:
            return largest(t, e)
        return float((t - e).norm() / e.norm().clamp(min=1e-300))

    rtol, atol = SLSTM_BWD_TOL[name]
    errs, dist, dist_plain, texts = {}, {}, {}, []
    for gname, g, w, p, e in zip(SLSTM_BWD_NAMES, got, same_in, plain, exact):
        scale = float(w.float().abs().max())
        errs[gname] = float((g.float() - w.float()).abs().max())
        ok = bool(torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol * scale))
        check(ok, f"{label}: {gname} outside rtol {rtol:.3g} / atol {atol:.3g} x {scale:.3g} of "
                  f"the plain walk over the same rows (max abs err {errs[gname]:.3g})")
        dist[gname], dist_plain[gname] = distance(g, e), distance(p, e)
        floor = SLSTM_BWD_FLOOR * (float(e.double().abs().max()) if dtype == torch.float32
                                   else 1.0)
        limit = max(SLSTM_FP64_VS_PLAIN * dist_plain[gname], floor)
        check(dist[gname] <= limit, f"{label}: {gname}'s {metric} from the {kind} backward "
                                    f"{dist[gname]:.3g} > {limit:.3g} (the plain path's "
                                    f"{dist_plain[gname]:.3g})")
        extra = ""
        if dtype != torch.float32:
            big, big_plain = largest(g, e), largest(p, e)
            limit = max(SLSTM_BWD_MAX_VS_PLAIN * big_plain, SLSTM_BWD_FLOOR * scale)
            check(big <= limit, f"{label}: {gname}'s largest error from the fp32 backward "
                                f"{big:.3g} > {limit:.3g} (the plain path's {big_plain:.3g})")
            extra = f"; largest {big:.3g}, plain path {big_plain:.3g}"
        texts.append(f"{gname} {errs[gname]:.3g} of {scale:.3g} ({kind}: {dist[gname]:.3g}, "
                     f"plain path {dist_plain[gname]:.3g}{extra})")
    del exact, same_in
    check(same, f"{label}: not the same bits from run to run")
    check(wired, f"{label}: autograd of the wrapper gave other bits than the backward wrapper")
    layout = slstm_ops.built_bwd_layout(dh)
    check(layout == slstm_ops.bwd_layout(dh), f"{label}: the built layout {layout} is not ops' "
                                              f"mirror {slstm_ops.bwd_layout(dh)}")
    nc, warps = layout[:2]
    targ = "bf16" if dtype == torch.bfloat16 else "float"
    facts = res.get(f"{slstm_ops.BWD_KERNEL}<{targ}, {dh}>", {})
    check(facts.get("stack") == 0, f"{label}: {slstm_ops.BWD_KERNEL}<{targ}, {dh}> has a stack "
                                   f"frame of {facts.get('stack')} B (spills) or none was read")
    b_ms, b_by, floor_ms, b_text = slstm_bwd_bound(torch, dev, shape, pre.element_size(), nc)
    sync_ms = _slstm_sync_ms(torch, dev, sync_lib, shape, nc, warps, per_warp=True)
    zeros = tuple(torch.zeros_like(st[0]) for _ in range(4))

    def call():
        return slstm_ops._launch_bwd(r, saved, dhs, zeros, dtype)

    def fwd(save):
        return lambda: slstm_ops._launch(pre, r, b, st, save=save)

    row = {"shape": list(shape), "dtype": name, "max_abs_err": max(errs.values()),
           "max_abs_err_by_gradient": errs, "fp64_max_abs_err": max(dist.values()),
           "fp64_max_abs_err_plain": max(dist_plain.values()), "fp64_reference": kind,
           "fp64_metric": metric, "fp64_distance_by_gradient": dist,
           "tolerance": f"rtol {rtol:.3g}, atol {atol:.3g} x max|gradient|",
           "registers": facts.get("registers"), "stack": facts.get("stack"),
           "ms": time_ms(torch, call, reps=10, warmup=2),
           "device_ms": kernel_device_ms(torch, call, (slstm_ops.BWD_KERNEL,), reps=10),
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "serial_floor_ms": floor_ms + sync_ms, "sync_loop_ms": sync_ms, "library_ms": None,
           "fwd_ms": time_ms(torch, fwd(False), reps=10, warmup=2),
           "fwd_save_ms": time_ms(torch, fwd(True), reps=10, warmup=2),
           "fwd_device_ms": kernel_device_ms(torch, fwd(False), (slstm_ops.KERNEL,), reps=10),
           "fwd_save_device_ms": kernel_device_ms(torch, fwd(True), (slstm_ops.KERNEL,),
                                                  reps=10)}
    row["us_per_step"] = row["device_ms"] / s * 1e3
    row["fwd_us_per_step"] = row["fwd_device_ms"] / s * 1e3
    print(f"kernel {label}: the saving forward's hs and state bit-equal to the no-grad launch's; "
          f"max abs err against the plain walk over the same rows (tol rtol {rtol:.3g}, atol "
          f"{atol:.3g} x max|gradient|), the path's {metric} from the {kind} backward (limit "
          f"{SLSTM_FP64_VS_PLAIN:g} x the plain path's or {SLSTM_BWD_FLOOR:g}"
          + (f"; bf16 also the largest error within {SLSTM_BWD_MAX_VS_PLAIN:g} x the plain "
             f"path's" if dtype != torch.float32 else "") + "): " + "; ".join(texts)
          + f"; two calls and autograd of the wrapper bit-equal; a cluster of {nc} CTAs of {warps} + 1 warps for each of "
          f"{bsz * h} (row, head); {slstm_ops.BWD_KERNEL}<{targ}, {dh}>: "
          f"{facts.get('registers')} registers, stack {facts.get('stack')} B; kernel_ms "
          f"{row['ms']:.4f} device_ms {row['device_ms']:.4f} ({row['us_per_step']:.3f} us a "
          f"step, the no-grad forward's {row['fwd_us_per_step']:.3f}) plain_ms {plain_ms:.1f} "
          f"(the plain walk over the same rows, one call: a loop "
          f"over S) library_ms "
          f"null (no PyTorch call computes an sLSTM's gradient) bound_ms {b_ms:.4f} ({b_by}; "
          f"{b_text}); serial floor {row['serial_floor_ms']:.4f} ms (product {floor_ms:.4f} + "
          f"the cluster's per-step signalling alone {sync_ms:.4f}, the forward's 4-byte "
          f"sends); device {b_ms / row['device_ms']:.4f} of the bound, "
          f"{row['serial_floor_ms'] / row['device_ms']:.3f} of the serial floor; the forward "
          f"at this shape: no-grad {row['fwd_ms']:.4f} ms (device {row['fwd_device_ms']:.4f}), "
          f"saving {row['fwd_save_ms']:.4f} (device {row['fwd_save_device_ms']:.4f}); card "
          f"right after (SM clock, power, temperature): {card_state()}", flush=True)
    return row, plain


def _slstm_bwd_rows(torch, dev, gen, res: dict, sync_lib: Path) -> dict[str, dict]:
    """The backward kernel's row: xlstm-125m's train shape a replica in
    bf16 (the main path's) and fp32 (suffix ``_fp32``), and phase 2's
    forward shape SLSTM_SHAPE in both (``_long``, ``_long_fp32``), from the
    model's initial state and a zero bias; each fp32 row runs first, on the
    bf16 row's values widened, its plain backward the bf16 row's fp32
    reference."""
    row = {"name": "slstm_bwd"}
    for suffix, shape in (("", SLSTM_BWD_SHAPE), ("_long", SLSTM_SHAPE)):
        pre, r, b, st = _slstm_inputs(torch, dev, gen, shape, torch.bfloat16)
        dhs = torch.randn((shape[0], shape[1], *shape[2:]), generator=gen, device=dev)
        fp32, plain32 = _slstm_bwd_row(torch, dev, (pre.float(), r.float(), b.float(), st, dhs),
                                       res, sync_lib)
        main, _ = _slstm_bwd_row(torch, dev, (pre, r, b, st, dhs), res, sync_lib,
                                 plain32=plain32)
        del plain32
        row.update({f"{k}{suffix}": main[k] for k in main if k != "dtype"})
        row.update({f"{k}{suffix}_fp32": fp32[k] for k in SLSTM_BWD_FIELDS})
    return {"slstm_bwd": row}


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


# every build of a kernel's source with a macro, a library of its own each:
# the SWA profile builds, the split-TF32 kernel with lo rounded to nearest
# (phase 2's A/B of the split), and the sLSTM kernel's synchronisation
# probe (its serial floors' signalling parts)
VARIANT_BUILDS = {**{name: (source, macro) for name, (source, macro, *_)
                     in PROFILE_BUILDS.items()},
                  "swa_attention_tf32_rna_lo": ("swa_attention_tf32.cu", "SWA_TF32_RNA_LO"),
                  "slstm_sync_probe": ("slstm.cu", "SLSTM_SYNC_PROBE")}


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
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.kernels.slstm import ops as slstm_ops
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.kernels.trigger import ops as trigger_ops
    return (trigger_ops.LAUNCHES, mixing_ops.LAUNCHES, swa_ops.LAUNCHES, scan_ops.LAUNCHES,
            slstm_ops.LAUNCHES)


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
    ``torch.profiler``, which records the device's activities only: the
    host ops' records would triple the events to parse (on the H100
    machine the cnn cell's 1.04 M events took 77-99 s in
    ``prof.events()``, its 0.35 M device ones 23 s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def _op_kernels(torch, run, accept) -> tuple[int, int, float, float]:
    """One ``run()`` under ``torch.profiler`` with the host's ops and their
    input shapes: the number of host ops that ``accept(name, shapes)``
    takes, the number of device activities they launched themselves, their
    device time and that of every device activity of the run (ms).  Read
    from the profiler's raw events, each device activity tied to its
    launching op by its correlation id: ``prof.events()`` took 61 s over a
    granite train step's host and device events on the H100 machine."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results.events()
    ops = {e.correlation_id() for e in raw if e.device_type() == torch.autograd.DeviceType.CPU
           and e.linked_correlation_id() == 0 and accept(e.name(), e.shapes())}
    dev = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA]
    mine = [e for e in dev if e.linked_correlation_id() in ops]
    return (len(ops), len(mine), sum(e.duration_ns() for e in mine) / 1e6,
            sum(e.duration_ns() for e in dev) / 1e6)


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
        # every cell ran earlier in the process, and T=4 and T=8 each build
        # their own engine, so its one-time work cancels in the difference.
        # The cnn's main-path run (5d) is its first in the process, slower
        # than later ones: time a later one too
        t_cell = time.perf_counter()
        warm = None
        if name == "cnn":
            warm = cell(8).timing["ms_per_step"]
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
              + f"; {res8.timing['ms_per_step']:.3f} ms/iteration under it; the cell's "
              f"profile took {time.perf_counter() - t_cell:.1f} s of script")
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
    def own(prefix):
        return sum(ms for name, ms in per_name.items()
                   if (_repo_kernel(name) or "").startswith(prefix))

    scan, slstm = own("selective_scan"), own("slstm")
    print(f"{label} profile: {n_act / n:.0f} device activities per call, device "
          f"busy {busy / n:.2f} ms of {wall_ms:.2f} ms (idle share "
          f"{1 - busy / n / wall_ms:.3f}); swa_attention {own('swa_') / n:.2f} ms"
          + (f", selective_scan {scan / n:.2f} ms" if scan else "")
          + (f", slstm {slstm / n:.2f} ms" if slstm else ""))
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{label} profile:   {ms / n:9.3f} ms per call  {name[:90]}")
    return _repo_counts(count)


def _layer_indices(cfg, keep) -> list[int]:
    """The indices of the model's layers whose block type ``keep`` takes,
    in order."""
    types = [bt for cycle, repeat in cfg.layer_plan for _ in range(repeat) for bt in cycle]
    return [i for i, bt in enumerate(types) if keep(bt)]


def serve_layers(cfg) -> tuple[list[int], list[int]]:
    """The layers whose attention runs the SWA kernel at a prefill longer
    than the window (a windowed attention block), and those that run the
    selective scan (a Mamba branch)."""
    from repro_torch.models import blocks

    windowed = _layer_indices(cfg, lambda bt: blocks._has_attn(bt)
                              and blocks.block_window(cfg, bt) is not None)
    return windowed, _layer_indices(cfg, blocks._has_mamba)


def phase_serve(torch, dev, cfg=None, seq: int = 32768, n_req: int = 4,
                prompt: int = 16, new: int = 16, cache_len: int = 4096,
                heads=(0, 23, 47), seed: int = 0, twin: str | None = None,
                fp32_twin: bool = False
                ) -> tuple[dict[str, int], dict[str, int] | None]:
    """starcoder2-15b (or ``cfg``) with ``attn_impl="pallas_swa"``: one
    prefill of ``seq`` tokens (the prefill_32k length, batch cut from 32
    to 1), its logits within atol=rtol 1e-4 of the same prefill with
    ``attn_impl=twin`` where ``twin`` is given, then ``n_req`` requests
    decoded token by token.  The prefill must launch the SWA kernel that
    serves the model's dtype (the tensor-core kernel in bf16, the
    split-TF32 one in fp32) once in each windowed layer and no other SWA
    kernel, and the selective scan once in each layer with a Mamba branch
    (``serve_layers``), and the sLSTM kernel once in each sLSTM layer; the
    first windowed layer's SWA output is held against the plain version on
    ``heads``, the first Mamba layer's scan output on SCAN_CHECK_CHANNELS
    channels, the first sLSTM layer's recurrence on its first
    SLSTM_CHECK_STEPS steps (``_slstm_check``).  The decoded logits must lie
    within relative L2 5e-2 of ``forward``'s on the same tokens; with
    ``fp32_twin`` that gate holds the same weights in fp32 (decode and
    forward), and the bf16 decode's relative L2 against the fp32 forward
    must stay within DECODE_VS_FORWARD x the bf16 forward's own
    (``_decode_fp32_twin``).  A model with Mamba or
    sLSTM layers also gets its prefill's device time by block
    (``_prefill_by_block``).  Returns the
    prefill's launch counts and the device activities of each repo kernel
    in a profiled prefill (None off the card or when the profiler saw
    none)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.kernels.scan.ref import selective_scan_ref
    from repro_torch.kernels.slstm import ops as slstm_ops
    from repro_torch.kernels.swa import ops as swa_ops
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

    # (a) prefill: count the kernels' launches, keep the first call's
    # inputs and output of each wrapper for the check against the plain
    # versions
    windowed, mamba = serve_layers(cfg)
    slstm = _layer_indices(cfg, lambda bt: bt == "slstm")
    first: list = []
    first_scan: list = []
    first_slstm: list = []
    real, real_scan = swa_ops.swa_attention, scan_ops.selective_scan
    real_slstm = slstm_ops.slstm_scan

    def capture(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if not first:
            first.append((q, k, v, out, kw["window"]))
        return out

    def capture_scan(*ins):
        out = real_scan(*ins)
        if not first_scan:
            first_scan.append((ins, out))
        return out

    def capture_slstm(pre_x, r, b, st):
        out = real_slstm(pre_x, r, b, st)
        if not first_slstm:  # the inputs' first SLSTM_CHECK_STEPS steps, the output's
            first_slstm.append((pre_x[:, :SLSTM_CHECK_STEPS].clone(), r, b, st,
                                out[0][:, :SLSTM_CHECK_STEPS].clone()))
        return out

    swa_ops.swa_attention, scan_ops.selective_scan = capture, capture_scan
    slstm_ops.slstm_scan = capture_slstm
    try:
        _reset_launches()
        logits = prefill(params, {"tokens": tokens})
        _sync(torch, dev)
        counts = _launches()
    finally:
        swa_ops.swa_attention, scan_ops.selective_scan = real, real_scan
        slstm_ops.slstm_scan = real_slstm
    check(bool(first) == bool(windowed),
          f"serve prefill: the SWA wrapper was called {len(first)} times, the model has "
          f"{len(windowed)} windowed layers")
    # the kernel that serves q's dtype
    route = swa_route(torch, first[0][0].dtype) if first else None
    launches = counts[route] if route else 0
    other = sum(counts[k] for k in swa_ops.LAUNCHES if k != route)
    check(launches == len(windowed) and other == 0,
          f"serve prefill: expected {len(windowed)} SWA launches (the windowed "
          f"layers), all on {route}, got {counts}")
    check(counts["selective_scan"] == len(mamba),
          f"serve prefill: expected {len(mamba)} selective_scan launches (the Mamba "
          f"layers), got {counts}")
    check(counts["slstm"] == len(slstm),
          f"serve prefill: expected {len(slstm)} slstm launches (the sLSTM layers), "
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
    swa_text = ""
    if first:
        swa_text = _swa_heads_check(torch, cfg, first.pop(), heads, windowed[0])
    scan_text = ""
    if mamba:
        (x, dt, b, c, a_log), y = first_scan.pop()
        sl = slice(0, SCAN_CHECK_CHANNELS)
        ref = selective_scan_ref(x[..., sl].contiguous(), dt[..., sl].contiguous(), b, c,
                                 a_log[sl].contiguous())
        scale = float(ref.abs().max())
        scan_err = float((y[..., sl] - ref).abs().max())
        check(bool(torch.allclose(y[..., sl], ref, rtol=SCAN_RTOL, atol=SCAN_ATOL * scale)),
              f"serve prefill: layer {mamba[0]}'s selective scan outside rtol {SCAN_RTOL} / "
              f"atol {SCAN_ATOL} x max|y| of the plain version (max abs err {scan_err:.3g})")
        scan_text = (f"; {counts['selective_scan']} selective_scan launches, layer "
                     f"{mamba[0]}'s scan on {SCAN_CHECK_CHANNELS} of {x.shape[2]} channels vs "
                     f"plain: max abs err {scan_err:.3g} of max|y| {scale:.3g} (tol rtol "
                     f"{SCAN_RTOL}, atol {SCAN_ATOL} x max|y|)")
        del x, dt, b, c, a_log, y, ref
    if slstm:
        scan_text += _slstm_check(torch, first_slstm.pop(), slstm[0], counts["slstm"])

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
    swa_launches = f"{launches} {route} launches" if route else "no windowed layer"
    print(f"serve prefill {cfg.name} B=1 S={seq}: {swa_launches}; logits "
          f"finite{swa_text}{scan_text}{twin_text}; "
          f"{prefill_ms:.1f} ms "
          f"({seq / prefill_ms * 1e3:.0f} tokens/s, host clock to a sync, second "
          f"run); peak memory {peak:.2f} GB; card right after (SM clock, power, "
          f"temperature): {state}")
    seen = None
    if on_card:
        seen = _profile_line(torch, "serve prefill", prefill_ms, 1,
                             lambda: prefill(params, {"tokens": tokens}))
        if mamba or slstm:
            _prefill_by_block(torch, cfg, lambda: prefill(params, {"tokens": tokens}),
                              prefill_ms)

    # (b) decode: prompts replayed into the ring-buffer cache, then greedy
    serve = steps.make_serve_step(cfg)
    fed, dec, cache, replay_ms, step_ms = _decode_requests(
        torch, dev, cfg, params, serve, n_req, prompt, new, cache_len, seed)
    fwd = prefill(params, {"tokens": fed}).float()
    rel = float(_rel_l2(dec, fwd).max())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    check(bool(torch.isfinite(dec).all()), "serve decode: decode logits not finite")
    twin_text = _decode_gate(torch, dev, cfg, params, fed, cache_len, dec, fwd, rel, fp32_twin)
    print(f"serve decode B={n_req} cache_len={cache_len}: {prompt} prompt tokens "
          f"replayed in {replay_ms:.2f} ms/step, {new} greedy steps "
          f"at {step_ms:.2f} ms/step ({n_req * 1e3 / step_ms:.1f} tokens/s); "
          f"logits at {prompt + new} positions vs forward: max relative L2 "
          f"{rel:.3g} ({'see the fp32 twin' if twin_text else 'tol 5e-2'}), argmax "
          f"agreement {agree:.3f}{twin_text}")
    if on_card:
        _profile_line(torch, "serve decode", step_ms, 4, lambda: [
            serve(params, cache, fed[:, -1], t)
            for t in range(prompt + new, prompt + new + 4)])
    del params, cache, dec, fwd
    if on_card:
        torch.cuda.empty_cache()
    return counts, seen


def _decode_requests(torch, dev, cfg, params, serve, n_req: int, prompt: int, new: int,
                     cache_len: int, seed: int):
    """n_req requests through ``serve`` (``launch.steps.make_serve_step``):
    ``prompt`` seeded tokens each replayed one at a time into a fresh cache,
    then ``new`` greedy tokens.  Returns the tokens fed (n_req, prompt +
    new), the decode logits at every position (fp32), the cache, and the
    ms a step of the replay and of the greedy steps (host clock to a sync)."""
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.models import model as M

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
    return (fed, torch.stack(dec, 1).float(), cache, (t1 - t0) * 1e3 / prompt,
            (t2 - t1) * 1e3 / new)


def _swa_heads_check(torch, cfg, captured, heads, layer: int) -> str:
    """The first windowed layer's SWA kernel output (``captured``: its q, k,
    v, output and window) against the plain version on ``heads``; returns
    the line's text."""
    from repro_torch.kernels.swa.ref import swa_ref

    q, k, v, out, win = captured
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
        check(ok, f"serve prefill: layer {layer} head {hh} outside "
                  f"{swa_tol_text(tol)} of the plain version (max abs err {err:.3g}, "
                  f"rel L2 {rel:.3g})")
        del ref
    return (f"; layer {layer} heads {list(heads)} vs plain: max abs err {max(errs):.3g}, "
            f"rel L2 {max(rels):.3g}, output std {min(scales):.3g}-{max(scales):.3g} (tol "
            f"{swa_tol_text(tol)})")


SLSTM_CHECK_STEPS = 4096  # phase 16: the first sLSTM layer's steps held against the plain loop


def _slstm_check(torch, captured, layer: int, launches: int) -> str:
    """The first sLSTM layer's kernel output on its first SLSTM_CHECK_STEPS
    steps (``captured``: that slice of pre_x, R, the bias, the initial
    state and the kernel's hs) against the plain loop in the model's dtype
    and in fp32: the kernel no farther from the fp32 recurrence than
    SLSTM_FP64_VS_PLAIN x the plain loop in the model's dtype (phase 2's
    gate).  Returns the line's text."""
    from repro_torch.kernels.slstm.ref import slstm_scan_ref

    pre, r, b, st, hs = captured
    plain = slstm_scan_ref(pre, r, b, st)[0]
    exact = slstm_scan_ref(pre.float(), r.float(), b.float(), st)[0]
    d_kernel = float((hs - exact).abs().max())
    d_plain = float((plain - exact).abs().max())
    err = float((hs - plain).abs().max())
    limit = max(SLSTM_FP64_VS_PLAIN * d_plain, SLSTM_FLOOR)
    check(d_kernel <= limit,
          f"serve prefill: layer {layer}'s sLSTM on its first {pre.shape[1]} steps: max abs "
          f"err against the fp32 recurrence {d_kernel:.3g} > {limit:.3g} (the plain "
          f"{str(pre.dtype)[6:]} loop's {d_plain:.3g})")
    return (f"; {launches} slstm launches, layer {layer}'s sLSTM on its first "
            f"{pre.shape[1]} steps: max abs err vs the plain {str(pre.dtype)[6:]} loop {err:.3g}, "
            f"vs the fp32 recurrence {d_kernel:.3g} (plain loop {d_plain:.3g}, limit "
            f"{limit:.3g}), max|h| {float(exact.abs().max()):.3g}")


def _decode_gate(torch, dev, cfg, params, fed, cache_len, dec, fwd, rel: float,
                 fp32_twin: bool) -> str:
    """The decode check: relative L2 ``rel`` of the decode logits against
    ``forward``'s within 5e-2 (phase 8's gate), or, with ``fp32_twin``, the
    fp32 twin's form (``_decode_fp32_twin``).  Returns the twin's text, ""
    without it."""
    if fp32_twin:
        return _decode_fp32_twin(torch, dev, cfg, params, fed, cache_len, dec, fwd)
    check(rel <= 5e-2, f"serve decode: decode logits vs forward relative L2 {rel:.3g} > 5e-2")
    return ""


BY_BLOCK = "by block: "  # the prefix of _prefill_by_block's profiler ranges


def _prefill_by_block(torch, cfg, run, prefill_ms: float) -> None:
    """One more prefill, ``run()``, under ``torch.profiler`` (host ops and
    device activities) with a ``record_function`` range around every block
    and around each block's attention and Mamba branches: the device time
    of each block type and of its branches, summed over its layers, and of
    what lies outside the blocks (embedding, final norm, head).  A device
    activity counts in every range that holds the host op that launched it
    (tied by correlation id, as in ``_op_kernels``), so a host-bound
    prefill's blocks get their device time, not their dispatch time.  The
    repo's kernels, launched through ctypes, are tied to no host op: on the
    one stream an activity tied to none takes the host op of the activity
    before it (the ops that make a kernel's inputs run in its range)."""
    import bisect
    import itertools

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import attention, blocks, ssm

    def ranged(label_of, fn):
        def call(*args, **kw):
            with record_function(BY_BLOCK + label_of(*args, **kw)):
                return fn(*args, **kw)
        return call

    real = blocks.block_seq, attention.attention_seq, ssm.mamba_seq
    blocks.block_seq = ranged(lambda cfg, bt, *a, **kw: bt, real[0])
    attention.attention_seq = ranged(
        lambda *a, layer_window=None, **kw: "attention " + (
            "global" if layer_window is None else f"window {layer_window}"), real[1])
    ssm.mamba_seq = ranged(lambda *a, **kw: "mamba", real[2])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        blocks.block_seq, attention.attention_seq, ssm.mamba_seq = real
    raw = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(BY_BLOCK):])
             for e in raw if e.device_type() == cpu and e.name().startswith(BY_BLOCK)]
    host = {e.correlation_id(): e.start_ns() for e in raw
            if e.device_type() == cpu and e.linked_correlation_id() == 0}
    dev = [e for e in raw if e.device_type() == cuda and not e.name().startswith(BY_BLOCK)]
    tied, placed, last = [], 0, None
    for e in sorted(dev, key=lambda e: e.start_ns()):
        t = host.get(e.linked_correlation_id())
        if t is None and last is not None:
            t, placed = last, placed + e.duration_ns()
        if t is not None:
            tied.append((t, e.duration_ns()))
            last = t
    tied.sort()
    starts = [t for t, _ in tied]
    cum = list(itertools.accumulate((d for _, d in tied), initial=0))
    busy = sum(e.duration_ns() for e in dev) / 1e6
    ms: dict[str, float] = {}
    calls: dict[str, int] = {}
    for a, b, label in spans:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        ms[label] = ms.get(label, 0.0) + (cum[hi] - cum[lo]) / 1e6
        calls[label] = calls.get(label, 0) + 1
    types = {bt for cycle, _ in cfg.layer_plan for bt in cycle}
    in_blocks = sum(v for k, v in ms.items() if k in types)
    untied = busy - cum[-1] / 1e6
    print(f"serve prefill by block ({cfg.name}, device time from the profiler's records, "
          f"each activity in the ranges of the host op that launched it; device busy "
          f"{busy:.1f} ms, of which {busy - untied - in_blocks:.1f} ms outside the blocks, "
          f"{placed / 1e6:.1f} ms tied through the activity before it and {untied:.1f} ms "
          f"not at all; the timed prefill {prefill_ms:.1f} ms on the host clock): " + ", ".join(
              f"{k} x{calls[k]} {v:.1f} ms" for k, v in sorted(ms.items(), key=lambda kv: -kv[1])))


# phase 15's bf16 decode against a forward of the same weights in fp32: its
# relative L2 within this multiple of the bf16 forward's own.  hymba's bf16
# noise floor, bf16 forward against fp32 forward, is 0.080-0.093 at full
# size on the H100, and the bf16 decode and forward differ by 0.051-0.052,
# over phase 8's 5e-2, while the fp32 decode equals the fp32 forward to
# 1e-5; the ratio reads 1.022 there.  On the smoke model on the CPU it
# reads 1.014, and 1.59-1.84 with the Mamba branch's bf16 decode output
# scaled by 1 + 2^-5 (tests/test_torch_ssm.py holds this gate to both)
DECODE_VS_FORWARD = 1.1


def _rel_l2(a, b):
    """Relative L2 distance of each request's (positions, vocab) logits."""
    return (a - b).norm(dim=(1, 2)) / b.norm(dim=(1, 2))


def _decode_fp32_twin(torch, dev, cfg, params, fed, cache_len, dec, fwd) -> str:
    """The decode check of a bf16 model whose bf16 noise floor is above
    phase 8's 5e-2: the same weights in fp32 decode ``fed`` (the bf16
    run's prompts and greedy tokens) token by token within relative L2 5e-2
    of the fp32 ``forward`` (phase 8's gate), and the bf16 decode ``dec``
    lies within DECODE_VS_FORWARD x the bf16 forward ``fwd``'s relative L2
    of the fp32 forward.  Returns the line's text."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.tree_map(lambda t: t.float(), params)
    serve = steps.make_serve_step(cfg32)
    cache = M.init_cache(cfg32, fed.shape[0], cache_len, device=dev)
    dec32 = torch.stack([serve(p32, cache, fed[:, t], t)[0] for t in range(fed.shape[1])], 1)
    fwd32 = steps.make_prefill_step(cfg32)(p32, {"tokens": fed})
    del p32, cache
    rel32 = float(_rel_l2(dec32, fwd32).max())
    check(bool(torch.isfinite(dec32).all()) and rel32 <= 5e-2,
          f"serve decode fp32 twin: decode logits vs forward relative L2 {rel32:.3g} > 5e-2")
    floor, err = _rel_l2(fwd, fwd32), _rel_l2(dec, fwd32)
    ratio = float((err / floor).max())
    check(ratio <= DECODE_VS_FORWARD,
          f"serve decode: the bf16 decode's relative L2 against the fp32 forward "
          f"{[round(float(x), 4) for x in err]} over {DECODE_VS_FORWARD} x the bf16 "
          f"forward's {[round(float(x), 4) for x in floor]}")
    return (f"; fp32 twin (the same weights): decode vs forward max relative L2 {rel32:.3g} "
            f"(tol 5e-2); against the fp32 forward, bf16 decode "
            f"{float(err.min()):.4f}-{float(err.max()):.4f} and bf16 forward "
            f"{float(floor.min()):.4f}-{float(floor.max()):.4f}, at most {ratio:.3f} x "
            f"(tol {DECODE_VS_FORWARD} x)")


def _frontend_batch(torch, cfg, tokens, seed: int) -> dict:
    """The prefill batch of ``tokens`` (B, S): with a modality frontend, the
    stub's embeddings beside them, seeded normal fp32 (B, T, dim) on the
    tokens' device (T the vision patches, or S audio frames)."""
    batch = {"tokens": tokens}
    if cfg.frontend is not None:
        nt = cfg.frontend.tokens if cfg.frontend.kind == "vision" else tokens.shape[1]
        gen = torch.Generator(device=tokens.device).manual_seed(seed)
        batch["frontend"] = torch.randn((tokens.shape[0], nt, cfg.frontend.dim),
                                        generator=gen, device=tokens.device)
    return batch


def phase_serve_cpu(torch, dev, arch: str = "starcoder2-15b", seq: int = 128,
                    seed: int = 0) -> tuple[dict[str, int], dict[str, int] | None]:
    """The smoke configuration of ``arch`` (fp32, pallas_swa) on the card
    (the split-TF32 SWA kernel in each windowed layer; hymba's selective
    scan in each layer; xlstm's sLSTM kernel in each sLSTM layer; for a
    model with a modality frontend, seeded stub embeddings beside the
    tokens) and on the CPU (plain versions), one set of weights, logits
    within atol=rtol 1e-4.  Returns the card prefill's launch counts and
    the device activities of each repo kernel in that prefill, which runs
    under the profiler (None off the card or when the profiler saw
    none)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(smoke_config(arch), attn_impl="pallas_swa")
    windowed, mamba = serve_layers(cfg)
    slstm = _layer_indices(cfg, lambda bt: bt == "slstm")
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    card_params = M.tree_map(lambda t: t.to(dev), cpu_params)
    tokens = torch.as_tensor(token_dataset(2 * seq, vocab=cfg.vocab, seed=seed),
                             dtype=torch.int64).reshape(2, seq)
    batch = _frontend_batch(torch, cfg, tokens, seed)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    prefill = steps.make_prefill_step(cfg)
    _reset_launches()
    if torch.device(dev).type == "cuda":
        out: dict = {}
        n_act, _, _, count = _device_activity(torch, lambda: out.setdefault(
            "logits", prefill(card_params, card_batch)))
        card, seen = out["logits"], _repo_counts(count) if n_act else None
    else:
        card, seen = prefill(card_params, card_batch), None
    counts = _launches()
    launches = counts["swa_attention_tf32"]  # fp32: the split-TF32 kernel
    check(launches == len(windowed) and counts["swa_attention_tc"] == 0
          and counts["selective_scan"] == len(mamba) and counts["slstm"] == len(slstm),
          f"serve_cpu {cfg.name}: expected {len(windowed)} swa_attention_tf32 launches, no "
          f"swa_attention_tc launch, {len(mamba)} selective_scan and {len(slstm)} slstm "
          f"launches, got {counts}")
    cpu = prefill(cpu_params, batch)
    check(tuple(cpu.shape) == (2, seq, cfg.vocab),
          f"serve_cpu {cfg.name}: logits {tuple(cpu.shape)}, expected {(2, seq, cfg.vocab)}")
    err = float((card.cpu() - cpu).abs().max())
    check(bool(torch.allclose(card.cpu(), cpu, atol=1e-4, rtol=1e-4)),
          f"serve_cpu {cfg.name}: card vs cpu logits outside atol=rtol 1e-4 (max abs err "
          f"{err:.3g})")
    fe = (f", {cfg.frontend.kind} frontend ({tuple(batch['frontend'].shape)} stub "
          f"embeddings)" if cfg.frontend is not None else "")
    print(f"serve card vs cpu {cfg.name} fp32 S={seq}{fe}: {launches} swa_attention_tf32, "
          f"{counts['selective_scan']} selective_scan and {counts['slstm']} slstm launches on "
          f"the card, logits max abs err {err:.3g} (tol atol=rtol 1e-4)")
    return counts, seen


# phase 17's cells: S cut from the reference's prefill_32k for chip time
# (width and depth are not cut); paligemma's 256 patches + 7936 text tokens
FRONTEND_SEQ = {"paligemma-3b": 8192, "hubert-xlarge": 8192}


def phase_serve_frontends(torch, dev, arch: str, seq: int | None = None, n_req: int = 4,
                          prompt: int = 16, new: int = 16, cache_len: int = 4096,
                          seed: int = 0, cfg=None) -> None:
    """A model with a modality frontend at full size (``arch``'s config, or
    ``cfg``), bf16, B=1: one prefill of ``seq`` positions through
    ``launch.steps`` (vision: the config's patches of seeded stub
    embeddings, then seq - patches text tokens, logits over the text;
    audio: seq frames, logits over all), finite, timed (second run) with
    peak memory and one profiled run; then, where the model decodes, n_req
    text-only requests decoded as in phase 8 (prompt tokens replayed, new
    greedy tokens), held against the backbone's forward on the same tokens
    without the frontend (the config with ``frontend=None``: the reference's
    ``forward`` drops the logits of the first patches' positions even
    without patches) at relative L2 5e-2, or in the fp32 twin's form where
    the bf16 decode misses that (``_decode_gate``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or get_config(arch)
    seq = seq or FRONTEND_SEQ[arch]
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
    vision = cfg.frontend.kind == "vision"
    n_text = seq - cfg.frontend.tokens if vision else seq
    tokens = torch.as_tensor(token_dataset(n_text, vocab=cfg.vocab, seed=seed),
                             dtype=torch.int64, device=dev)[None]
    batch = _frontend_batch(torch, cfg, tokens, seed)
    prefill = steps.make_prefill_step(cfg)
    _reset_launches()
    logits = prefill(params, batch)
    _sync(torch, dev)
    counts = {k: n for k, n in _launches().items() if n}
    want = (1, n_text, cfg.vocab)
    check(tuple(logits.shape) == want and bool(torch.isfinite(logits).all()),
          f"serve prefill {cfg.name}: logits {tuple(logits.shape)} (expected {want}) not "
          f"finite or misshaped")
    std = float(logits.float().std())
    del logits
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    _sync(torch, dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    state = card_state() if on_card else "not measured"
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    del logits
    what = (f"{cfg.frontend.tokens} patch embeddings + {n_text} text tokens" if vision
            else f"{seq} frames")
    print(f"serve prefill {cfg.name} B=1 S={seq} ({what}, dim {cfg.frontend.dim}): logits "
          f"{want} finite, std {std:.3g}; repo kernel launches {counts or 'none'} (attention "
          f"through the chunked path: {'a prefix' if vision else 'bidirectional'}); "
          f"{prefill_ms:.1f} ms ({seq / prefill_ms * 1e3:.0f} positions/s, host clock to a "
          f"sync, second run); peak memory {peak:.2f} GB; card right after (SM clock, power, "
          f"temperature): {state}")
    if on_card:
        _profile_line(torch, f"serve prefill {cfg.name}", prefill_ms, 1,
                      lambda: prefill(params, batch))
    if cfg.supports_decode:
        fed, dec, cache, replay_ms, step_ms = _decode_requests(
            torch, dev, cfg, params, steps.make_serve_step(cfg), n_req, prompt, new, cache_len,
            seed)
        text_cfg = dataclasses.replace(cfg, frontend=None)
        fwd = steps.make_prefill_step(text_cfg)(params, {"tokens": fed}).float()
        rel = float(_rel_l2(dec, fwd).max())
        check(bool(torch.isfinite(dec).all()), "serve decode: decode logits not finite")
        twin_text = _decode_gate(torch, dev, text_cfg, params, fed, cache_len, dec, fwd, rel,
                                 fp32_twin=False)
        print(f"serve decode {cfg.name} B={n_req} cache_len={cache_len} (text-only "
              f"prompts): {prompt} prompt tokens replayed in {replay_ms:.2f} ms/step, {new} greedy steps at {step_ms:.2f} ms/step "
              f"({n_req * 1e3 / step_ms:.1f} tokens/s); logits at {prompt + new} positions "
              f"vs the forward without the frontend: max relative L2 {rel:.3g} "
              f"({'see the fp32 twin' if twin_text else 'tol 5e-2'}){twin_text}")
        del cache, dec, fwd
    del params
    if on_card:
        torch.cuda.empty_cache()


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


# ---------------------------------------------------------------------------
# phase 11: EF-HC training of starcoder2-15b
# ---------------------------------------------------------------------------

# bf16 train-step parameters, card against CPU: one bf16 ulp (rtol 2^-7) and
# a floor of 4 bf16 ulps of the leaf's largest value, the model's own bf16
# rounding in two implementations (tests/test_torch_train.py states why)
TRAIN_BF16_RTOL, TRAIN_LEAF_ULPS = 2.0 ** -7, 4
# the train cell: m replicas on a ring over 2 pods (personalized rho), the
# global batch, dense steps (checkpointed at their end), then neighbor steps
TRAIN_M, TRAIN_PODS, TRAIN_BATCH, TRAIN_DENSE, TRAIN_NEIGHBOR, TRAIN_SEED = 4, 2, 8, 4, 2, 0
# the replica that comes back with another seed's weights in the firing leg
TRAIN_FIRE_REPLICA = 1
# the xlstm twin's one leaf held to a yardstick (phase 20): the mLSTM
# block's zero-initialised pre-norm bias.  Every leaf's bf16 gradient lies
# ~2% (relative L2) from the fp32 one on the card and on the CPU alike, and
# the two devices' fp32 gradients agree to ~3e-6 (``tools/
# xlstm_twin_probe.py``, PERF.md §6); a zero-initialised leaf holds
# nothing but such gradients, and this one's share of the allowance is
# past 1 on the card with the sLSTM kernels and with their plain versions
# alike.  It passes within the plain-versions run's share; every other
# leaf within the allowance
TWIN_HELD_LEAF = "stages/0/0_mlstm/norm1/bias"


def starcoder2_train(n_layers: int = 2):
    """starcoder2-15b at its full width in its own bf16 (``attn_impl``
    auto: ``xla`` at S=2048; remat on), its depth cut from 40 to
    ``n_layers`` layers as ``starcoder2_fp32`` cuts it: 1.372e9 parameters
    a replica."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("starcoder2-15b"), n_layers=n_layers,
                               layer_plan=((("attn",), n_layers),))


def _trees_equal(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _leaf_paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path ("stages/0/0_mlstm/norm1/bias") in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, item in enumerate(tree) for p in _leaf_paths(item, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _leaf_shares(torch, got, want) -> list[float]:
    """Each leaf's worst share of the bf16 allowance (TRAIN_BF16_RTOL of
    each value + TRAIN_LEAF_ULPS x that of the leaf's largest), compared on
    ``want``'s device a replica's rows at a time."""
    from repro_torch.tree import tree_leaves

    shares = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach(), w.detach()
        floor = TRAIN_LEAF_ULPS * TRAIN_BF16_RTOL * float(w.abs().max())
        worst = 0.0
        for gi, wi in zip(g, w):
            gi, wi = gi.to(wi.device).float(), wi.float()
            allow = TRAIN_BF16_RTOL * wi.abs() + floor
            worst = max(worst, float(((gi - wi).abs() / allow.clamp(min=1e-30)).max()))
        shares.append(worst)
    return shares


def _trees_close(torch, got, want, label: str, limits=None) -> float:
    """bf16 trees within TRAIN_BF16_RTOL and TRAIN_LEAF_ULPS (``limits``:
    each leaf's multiple of that allowance, 1 where None); returns the
    worst share of the allowance used."""
    shares = _leaf_shares(torch, got, want)
    for i, share in enumerate(shares):
        limit = 1.0 if limits is None else limits[i]
        check(share <= limit, f"{label}: leaf {i} outside {limit:.3g} x (rtol "
                              f"{TRAIN_BF16_RTOL} + {TRAIN_LEAF_ULPS} ulps of its scale) "
                              f"({share:.3g} of it)")
    return max(shares)


def _ring_p(torch, dev, m: int):
    """The Metropolis P of the m-replica ring with the odd replicas
    triggered (a real Event-3 matrix), its neighbor schedule's ELL slots,
    diagonal and weights."""
    from repro_torch.core import mixing
    from repro_torch.core.consensus import edge_coloring
    from repro_torch.core.topology import ring_adjacency
    from repro_torch.launch.steps import neighbor_slots

    adj = ring_adjacency(m)
    v = torch.arange(m, device=dev) % 2 == 1
    adj_t = torch.as_tensor(adj, device=dev)
    p = mixing.build_p(adj_t, (v[:, None] | v[None, :]) & adj_t)
    idx = torch.as_tensor(neighbor_slots(edge_coloring(adj), m), device=dev)
    rows = torch.arange(m, device=dev)[:, None]
    p_off = torch.where(idx != rows, p[rows, idx], 0.0).contiguous()
    return p, idx, torch.diagonal(p).contiguous(), p_off


def _train_rows(torch, dev, params, w_hat) -> dict[str, dict]:
    """The three bf16 entries against their plain versions at the train
    cell's largest leaf (each parameter tree's stacked (m, 3.0e8) rows):
    the trigger as ``_trigger_row`` holds it (with its device time), both
    mixes bit for bit; with each one's time, the plain version's, a library
    call's and the byte bound."""
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ordered_ref, mix_sparse_ref
    from repro_torch.tree import tree_leaves

    leaves_w, leaves_h = tree_leaves(params), tree_leaves(w_hat)
    big = max(range(len(leaves_w)), key=lambda i: leaves_w[i].numel())
    m = leaves_w[big].shape[0]
    w = leaves_w[big].reshape(m, -1)
    h = leaves_h[big].reshape(m, -1)
    n = w.shape[1]
    rows: dict[str, dict] = {}

    rows["trigger_sq_bf16"] = _trigger_row(
        torch, w, h, "trigger_sq_bf16 at the train cell's largest leaf",
        lambda w, h: ((w.float() - h.float()) ** 2).sum(1), reps=10)

    p, idx, p_diag, p_off = _ring_p(torch, dev, m)
    got, ref = mixing_ops.mix(p, w), mix_ordered_ref(p, w)
    torch.cuda.synchronize()
    abs_err = float((got.float() - ref.float()).abs().max())
    check(torch.equal(got, ref), f"mix_bf16: not bit-equal to its plain version "
                                 f"(max abs err {abs_err:.3g})")
    b_ms, b_by = bound(2 * m * n * 2 + m * m * 4, 2 * m * m * n)
    rows["mix_bf16"] = {
        "name": "mix_bf16", "shape": [m, n], "max_abs_err": abs_err, "tolerance": "exact",
        "ms": time_ms(torch, lambda: mixing_ops.mix(p, w)),
        "plain_ms": time_ms(torch, lambda: mix_ordered_ref(p, w), reps=10),
        "library_ms": time_ms(torch, lambda: torch.matmul(p, w.float()).to(w.dtype), reps=10),
        "bound_ms": b_ms, "bound_by": b_by}
    del got, ref

    got = mixing_ops.mix_sparse(idx, p_diag, p_off, w)
    ref = mix_sparse_ref(idx, p_diag, p_off, w)
    torch.cuda.synchronize()
    abs_err = float((got.float() - ref.float()).abs().max())
    check(torch.equal(got, ref), f"mix_sparse_bf16: not bit-equal to its plain "
                                 f"version (max abs err {abs_err:.3g})")
    csr = _csr(torch, idx, p_diag, p_off)
    nnz = int((p_off != 0).sum())
    b_ms, b_by = bound(2 * m * n * 2 + m * idx.shape[1] * (8 + 4) + m * 4,
                       (2 * nnz + m) * n)
    rows["mix_sparse_bf16"] = {
        "name": "mix_sparse_bf16", "shape": [m, n], "d_max": idx.shape[1],
        "nnz_off": nnz, "max_abs_err": abs_err, "tolerance": "exact",
        "ms": time_ms(torch, lambda: mixing_ops.mix_sparse(idx, p_diag, p_off, w)),
        "plain_ms": time_ms(torch, lambda: mix_sparse_ref(idx, p_diag, p_off, w), reps=10),
        "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, w.float()).to(w.dtype),
                              reps=10),
        "bound_ms": b_ms, "bound_by": b_by}
    del got, ref
    for name, row in rows.items():
        if name == "trigger_sq_bf16":  # printed by _trigger_row
            continue
        print(f"kernel {name} at the train cell's largest leaf {tuple(row['shape'])} bf16: "
              f"max abs err {row['max_abs_err']:.3g} (tol {row['tolerance']}); kernel_ms "
              f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
              f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound")
    print(f"card after the train kernel rows: {card_state()}")
    return rows


def _router_rows(torch, dev, w, h) -> dict[str, dict]:
    """The fp32 kernels at the train cell's own router rows ``w`` and
    their w_hat ``h`` (m, D), with the ring's real Event-3 P, at phase 2's
    fp32 tolerances: ``trigger_sq`` as ``_trigger_row`` holds it, ``mix``
    (split TF32) within atol 1e-5 of fp32 ``torch.matmul`` and within
    phase 2's limits against fp64, ``mix_sparse`` bit for bit; with each
    one's time, device time, the plain version's, a library call's and the
    bound.  The mix must move the rows by more than its tolerance, or a
    kernel that copies its input would pass."""
    import torch.nn.functional as F

    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref

    m, n = w.shape
    mix_atol = 1e-5
    rows: dict[str, dict] = {}

    rows["trigger_sq"] = _trigger_row(
        torch, w, h, "trigger_sq at the router rows",
        lambda w, h: F.pairwise_distance(w, h, eps=0.0) ** 2)

    p, idx, p_diag, p_off = _ring_p(torch, dev, m)
    got, ref = mixing_ops.mix(p, w), mix_ref(p, w)
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    moved = float((ref - w).abs().max())
    check(abs_err <= mix_atol < moved, f"mix at the router rows: max abs err {abs_err:.3g} "
                                       f"(tol {mix_atol}); the mix moves the rows by {moved:.3g}")
    fp64 = mix_fp64_gate(torch, p, w, got, ref, "mix at the router rows")
    b_ms, b_by = bound((m * m + 2 * m * n) * 4, 3 * 2 * m * m * n, TF32_TC_FLOPS)
    rows["mix"] = {
        "shape": [m, n], "max_abs_err": abs_err, "tolerance": f"atol {mix_atol}",
        "moved": moved, "fp64_max_abs_err": fp64["kernel"][0], "fp64_bias": fp64["kernel"][1],
        "ms": time_ms(torch, lambda: mixing_ops.mix(p, w)),
        "device_ms": kernel_device_ms(torch, lambda: mixing_ops.mix(p, w), ("mix_kernel",)),
        "plain_ms": time_ms(torch, lambda: mix_ref(p, w)),
        "library_ms": time_ms(torch, lambda: torch.matmul(p, w)),
        "bound_ms": b_ms, "bound_by": b_by}

    got = mixing_ops.mix_sparse(idx, p_diag, p_off, w)
    ref = mix_sparse_ref(idx, p_diag, p_off, w)
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    check(abs_err == 0.0, f"mix_sparse at the router rows: max abs err {abs_err:.3g}, "
                          f"expected 0")
    csr = _csr(torch, idx, p_diag, p_off)
    nnz = int((p_off != 0).sum())
    b_ms, b_by = _sparse_bound(nnz, m, m, idx.shape[1], n)
    rows["mix_sparse"] = {
        "shape": [m, n], "max_abs_err": abs_err, "tolerance": "exact",
        "ms": time_ms(torch, lambda: mixing_ops.mix_sparse(idx, p_diag, p_off, w)),
        "device_ms": kernel_device_ms(torch, lambda: mixing_ops.mix_sparse(idx, p_diag, p_off, w),
                                      ("mix_sparse_kernel",)),
        "plain_ms": time_ms(torch, lambda: mix_sparse_ref(idx, p_diag, p_off, w)),
        "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, w)),
        "bound_ms": b_ms, "bound_by": b_by}
    del got, ref
    for name, row in rows.items():
        if name == "trigger_sq":  # printed by _trigger_row
            continue
        extra = (f"; rows moved by {row['moved']:.3g}, against fp64 max abs err "
                 f"{row['fp64_max_abs_err']:.3g} (torch.matmul's {fp64['library'][0]:.3g}), "
                 f"mean relative bias {row['fp64_bias']:.3g}" if name == "mix" else "")
        print(f"kernel {name} at the train cell's fp32 router rows {tuple(row['shape'])}, ring "
              f"P: max abs err {row['max_abs_err']:.3g} (tol {row['tolerance']}{extra}); "
              f"kernel_ms {row['ms']:.4f} device_ms {row['device_ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound")
    return rows


def _train_twin(torch, dev, arch: str = "starcoder2-15b", plain_card=None,
                held: str | None = None) -> None:
    """``arch``'s smoke configuration in bf16 (m=4 on a ring, pods=2, S=64)
    on the card (the bf16 entries; a MoE's fp32 routers through the fp32
    kernels) and on the CPU (their plain versions) from one set of weights,
    3 dense steps then 2 neighbor steps: each step's v, trigger rate and
    alpha equal, the loss within rtol 2^-7, the parameters and w_hat
    within the bf16 allowance (a bf16 model's fp32 router too: its
    gradient comes through the model's bf16 arithmetic).  With
    ``plain_card`` (a context in which the card runs some kernels' plain
    versions) a third run on the card in it, its v equal too, is the
    yardstick of the leaf at path ``held``: it passes within the plain card
    run's own share of the allowance where that is past 1."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_map

    dense, neighbor = 3, 2
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    cpu_state = T.init_state(cfg, TRAIN_M, TRAIN_SEED, "cpu")
    card_state_ = tuple(tree_map(lambda t: t.to(dev, copy=True), s) for s in cpu_state)
    runs = {}
    legs = [("card", dev, card_state_, contextlib.nullcontext), ("cpu", "cpu", cpu_state,
                                                                  contextlib.nullcontext)]
    if plain_card is not None:
        legs.append(("plain card", dev, tuple(tree_map(lambda t: t.to(dev, copy=True), s)
                                              for s in cpu_state), plain_card))
    for where, device, state, ctx in legs:
        kw = dict(m=TRAIN_M, batch=TRAIN_BATCH, seq=64, pods=TRAIN_PODS, seed=TRAIN_SEED,
                  device=device, log=lambda s: None)
        with ctx():
            a = T.train(cfg, steps=dense, state=(*state, 0), **kw)
            b = T.train(cfg, steps=neighbor, mix="neighbor", state=(a.params, a.w_hat, a.step),
                        **kw)
        runs[where] = (a.records + b.records, b.params, b.w_hat)
    (rec_g, pg, hg), (rec_c, pc, hc) = runs["card"], runs["cpu"]
    for where, (rec, _, _) in runs.items():
        for g, c in zip(rec, rec_c):
            check(g["v"] == c["v"] and g["trigger_rate"] == c["trigger_rate"],
                  f"train twin step {g['k']}: v {g['v']} on the {where}, {c['v']} on the CPU")
            check(abs(g["alpha"] - c["alpha"]) <= RTOL * abs(c["alpha"]),
                  f"train twin step {g['k']}: alpha {g['alpha']} vs {c['alpha']} ({where})")
            check(abs(g["loss"] - c["loss"]) <= TRAIN_BF16_RTOL * abs(c["loss"]),
                  f"train twin step {g['k']}: loss {g['loss']} vs {c['loss']} ({where})")
    limits, text = {"params": None, "w_hat": None}, ""
    if plain_card is not None:
        _, pp, hp = runs["plain card"]
        idx = _leaf_paths(pc).index(held)
        limits, text = {}, f"; {held} (leaf {idx}) within the plain card run's share:"
        for k, (got, plain, want) in {"params": (pg, pp, pc), "w_hat": (hg, hp, hc)}.items():
            shares, yard = _leaf_shares(torch, got, want), _leaf_shares(torch, plain, want)[idx]
            limits[k] = [max(1.0, yard) if i == idx else 1.0 for i in range(len(shares))]
            text += (f" {k} {shares[idx]:.4f} (plain card {yard:.4f}; the card's worst other "
                     f"leaf {max(x for i, x in enumerate(shares) if i != idx):.4f})")
    used = max(_trees_close(torch, pg, pc, "train twin params", limits["params"]),
               _trees_close(torch, hg, hc, "train twin w_hat", limits["w_hat"]))
    print(f"train card vs cpu {cfg.name} bf16 m={TRAIN_M} S=64, {dense} dense + {neighbor} "
          f"neighbor steps: v equal at every step (trigger rates "
          f"{[r['trigger_rate'] for r in rec_c]}), losses within rtol 2^-7, parameters and "
          f"w_hat within rtol 2^-7 + {TRAIN_LEAF_ULPS} ulps of each leaf's scale{text} "
          f"(worst share {used:.3f})")


@contextlib.contextmanager
def _plain_train_kernels():
    """The train step's Events 2-3 through the kernels' plain versions,
    wherever its tensors lie: ``launch.steps``' three tree wrappers swapped
    for leaf-wise ``trigger_sq_ref``, ``mix_ordered_ref`` and
    ``mix_sparse_ref`` (a step made and run inside the block)."""
    from repro_torch.kernels.mixing import ops as mixing_ops
    from repro_torch.kernels.mixing.ref import mix_ordered_ref, mix_sparse_ref
    from repro_torch.kernels.trigger.ref import trigger_sq_ref
    from repro_torch.launch import steps as steps_mod
    from repro_torch.tree import tree_leaves

    def trigger(w_tree, h_tree):
        tot = None
        for w, h in zip(tree_leaves(w_tree), tree_leaves(h_tree), strict=True):
            s = trigger_sq_ref(w.reshape(w.shape[0], -1), h.reshape(h.shape[0], -1))
            tot = s if tot is None else tot + s
        return tot

    def dense(p, tree, *, out=None):
        return mixing_ops._tree(lambda rows: mix_ordered_ref(p, rows), tree, out)

    def sparse(idx, p_diag, p_off, tree, *, out=None):
        return mixing_ops._tree(lambda rows: mix_sparse_ref(idx, p_diag, p_off, rows),
                                tree, out)

    saved = steps_mod.trigger_sq_tree, steps_mod.mix_tree, steps_mod.mix_sparse_tree
    steps_mod.trigger_sq_tree, steps_mod.mix_tree, steps_mod.mix_sparse_tree = (
        trigger, dense, sparse)
    try:
        yield
    finally:
        steps_mod.trigger_sq_tree, steps_mod.mix_tree, steps_mod.mix_sparse_tree = saved


def _train_firing(torch, dev, cfg, params, w_hat, k: int, seq: int, label: str) -> None:
    """Consensus at work on the main path at full width.  Replica
    TRAIN_FIRE_REPLICA's parameters are replaced by another seed's random
    weights, as a replica that comes back with fresh weights since its last
    broadcast (w_hat stays as it was): its deviation is of the weights' own
    scale, so under the reference's r, rho and alpha it fires (the others,
    a few steps from their w_hat, stay silent at full width; each one's
    margin is printed).  Then one dense step and one neighbor step, each
    from one state through the bf16 entries and again through their plain
    versions (``_plain_train_kernels``): v equal (the dense step's the
    replicas past their margin, the fresh one among them), every entry launched
    once a leaf, the triggered rows of w_hat the parameters before the
    step and the others untouched (bit for bit), and the two runs' losses,
    parameters and w_hat within the bf16 allowance."""
    import dataclasses

    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim.schedules import paper_diminishing
    from repro_torch.tree import tree_leaves, tree_map

    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    fresh = M.init_params(cfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1), dev)
    for dst, src in zip(tree_leaves(params), tree_leaves(fresh), strict=True):
        dst[TRAIN_FIRE_REPLICA].copy_(src)
    del fresh
    batches = T._batches(cfg, TRAIN_M, TRAIN_BATCH, seq, TRAIN_SEED, dev)
    for _ in range(k):
        next(batches)
    setup = steps_mod.make_setup(cfg, TRAIN_M, pods=TRAIN_PODS)
    n_leaves = len(tree_leaves(params))
    with _plain_train_kernels():  # each replica's Event-2 margin, as the step will see it
        sq = steps_mod.trigger_sq_tree(params, w_hat).cpu().numpy()
    alpha = float(paper_diminishing(setup.alpha0, gamma=1.0, theta=0.5)(torch.tensor(k)))
    rho = setup.bandwidths.mean() / setup.bandwidths
    ratio = np.sqrt(sq / cfg.n_params) / (setup.r * rho * alpha)
    print(f"{label} firing leg: replica {TRAIN_FIRE_REPLICA} given seed {TRAIN_SEED + 1}'s "
          f"weights; each replica's sqrt(sq / N) over its threshold r rho gamma at k={k}: "
          f"{[float(f'{x:.4g}') for x in ratio]}", flush=True)
    plain = tree_map(torch.clone, (params, w_hat))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for mix, entry in (("dense", "mix_bf16"), ("neighbor", "mix_sparse_bf16")):
        s = dataclasses.replace(setup, mix=mix)
        make = steps_mod.make_neighbor_train_step if mix == "neighbor" else \
            steps_mod.make_train_step
        b = next(batches)
        _reset_launches()
        params, w_hat, got = make(s, n_model_params=cfg.n_params)(params, w_hat, b, k)
        counts = {name: n for name, n in _launches().items() if n}
        want = {"trigger_sq_bf16": n_leaves, entry: n_leaves}
        check(counts == want, f"{label} firing {mix} step: launches {counts}, expected {want}")
        v = got["v"].tolist()
        check(any(v), f"{label} firing {mix} step: no replica fired")
        if mix == "dense":
            check(v == (ratio > 1).tolist() and v[TRAIN_FIRE_REPLICA],
                  f"{label} firing dense step: v {v}, margins {ratio}")
        # plain holds the state before the step
        for h, h0, w0 in zip(tree_leaves(w_hat), tree_leaves(plain[1]),
                             tree_leaves(plain[0]), strict=True):
            for i, fired in enumerate(v):
                check(torch.equal(h[i], (w0 if fired else h0)[i]),
                      f"{label} firing {mix} step: w_hat row {i} is not the "
                      f"{'parameters before the step' if fired else 'w_hat before it'}")
        with _plain_train_kernels():
            p_params, p_w_hat, p_got = make(s, n_model_params=cfg.n_params)(*plain, b, k)
        check({name: n for name, n in _launches().items() if n} == counts,
              f"{label} firing {mix} step: the plain run launched a kernel")
        check(p_got["v"].tolist() == v, f"{label} firing {mix} step: v {v} through the "
                                        f"entries, {p_got['v'].tolist()} through the plain versions")
        loss, p_loss = float(got["loss"]), float(p_got["loss"])
        check(float(got["alpha"]) == float(p_got["alpha"]) and np.isfinite(loss)
              and abs(loss - p_loss) <= TRAIN_BF16_RTOL * abs(p_loss),
              f"{label} firing {mix} step: loss {loss} vs {p_loss} plain")
        used = max(_trees_close(torch, params, p_params, f"{label} firing {mix} params"),
                   _trees_close(torch, w_hat, p_w_hat, f"{label} firing {mix} w_hat"))
        exact = _trees_equal(torch, params, p_params) and _trees_equal(torch, w_hat, p_w_hat)
        print(f"{label} firing {mix} step k={k}: v {v} the same through the bf16 entries and "
              f"their plain versions ({n_leaves} launches each of trigger_sq_bf16 and {entry}); "
              f"w_hat rows of the fired replicas the parameters before the step, the others "
              f"untouched, bit for bit; loss {loss:.6f} vs {p_loss:.6f} plain; parameters and "
              f"w_hat within rtol 2^-7 + {TRAIN_LEAF_ULPS} ulps of each leaf's scale (worst "
              f"share {used:.3g}; {'bit-equal' if exact else 'not bit-equal'})", flush=True)
        for dst, src in zip(tree_leaves(plain), tree_leaves((params, w_hat)), strict=True):
            dst.copy_(src)  # the next step starts both runs from one state
        del p_params, p_w_hat
        k += 1
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else float("nan")
    print(f"{label} firing leg: {time.perf_counter() - t0:.1f} s, peak memory allocated "
          f"{peak:.2f} GiB (two copies of the state)")


def phase_train(torch, dev, cfg=None, seq: int = 2048
                ) -> tuple[dict[str, int], dict[str, dict]]:
    """EF-HC training of starcoder2-15b (``starcoder2_train``, or ``cfg``)
    through ``repro_torch.launch.train.train``: TRAIN_M replicas on a ring
    over TRAIN_PODS pods (personalized rho), global batch TRAIN_BATCH at
    ``seq`` tokens, TRAIN_DENSE dense steps with a checkpoint at their end,
    then TRAIN_NEIGHBOR neighbor steps continuing in memory: the main path,
    whose launches of the three bf16 entries must be leaves x steps.  Then
    a run that resumes from the checkpoint and takes the same neighbor
    steps, bit-equal to the in-memory one.  On the card, then: the entries
    against their plain versions at the largest leaf; one profiled dense
    step; the firing leg (``_train_firing``), since no replica of the main
    path fires at this width; and the smoke configuration's card-vs-CPU
    twin.  Returns the main path's launches and the kernel rows."""
    import dataclasses
    import shutil

    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    m, dense, neighbor = TRAIN_M, TRAIN_DENSE, TRAIN_NEIGHBOR
    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or starcoder2_train()
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    label = f"train {cfg.name} {cfg.n_layers}L m={m} pods={TRAIN_PODS} B={TRAIN_BATCH} S={seq}"

    def log(line: str) -> None:
        print(f"{label}: {line}", flush=True)

    kw = dict(m=m, batch=TRAIN_BATCH, seq=seq, pods=TRAIN_PODS, seed=TRAIN_SEED, device=dev,
              log=log)
    _reset_launches()
    if on_card:
        torch.zeros(1, device=dev)  # the allocator's stats exist once it has run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = T.train(cfg, steps=dense, ckpt=str(ckpt), ckpt_every=dense + neighbor + 1, **kw)
    t1 = time.perf_counter()
    run = T.train(cfg, steps=neighbor, mix="neighbor",
                  state=(first.params, first.w_hat, first.step), **kw)
    if on_card:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: n for k, n in _launches().items() if n}
    n_leaves = len(tree_leaves(run.params))
    want = {"trigger_sq_bf16": n_leaves * (dense + neighbor), "mix_bf16": n_leaves * dense,
            "mix_sparse_bf16": n_leaves * neighbor}
    check(counts == want, f"{label}: launches {counts}, expected {want} ({n_leaves} leaves)")
    records = first.records + run.records
    for r in records:
        check(np.isfinite(r["loss"]) and 0.0 <= r["trigger_rate"] <= 1.0,
              f"{label}: step {r['k']} loss {r['loss']}, trigger_rate {r['trigger_rate']}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else float("nan")
    warm = first.step_ms[1:] + run.step_ms  # the first step warms the libraries
    ms = {"dense": statistics.median(first.step_ms[1:]) if dense > 1 else float("nan"),
          "neighbor": statistics.median(run.step_ms)}
    n_par = cfg.n_params
    print(f"{label}: {n_par} parameters a replica ({n_par * 2 / 1e9:.3f} GB in bf16), "
          f"{n_leaves} leaves; step ms {[round(x, 1) for x in first.step_ms + run.step_ms]} "
          f"(first includes warm-up); median ms/step dense {ms['dense']:.1f}, neighbor "
          f"{ms['neighbor']:.1f}; tokens/s {run.tokens_per_step / statistics.median(warm) * 1e3:.0f}"
          f" ({run.tokens_per_step} tokens a step); peak memory allocated {peak:.2f} GiB; "
          f"dense leg {t1 - t0:.1f} s (init, {dense} steps, checkpoint), neighbor leg "
          f"{t2 - t1:.1f} s; launches {counts}; trigger rates "
          f"{[r['trigger_rate'] for r in records]}; card {card_state()}")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.glob("step_*.msgpack"))

    # the resume: from the checkpoint in a run of its own, bit-equal
    t3 = time.perf_counter()
    resumed = T.train(cfg, steps=neighbor, mix="neighbor", ckpt=str(ckpt), **kw)
    t4 = time.perf_counter()
    check(resumed.records == run.records, f"{label}: the resumed steps' metrics differ "
                                          f"from the run they continue")
    check(_trees_equal(torch, resumed.params, run.params)
          and _trees_equal(torch, resumed.w_hat, run.w_hat),
          f"{label}: the resumed state differs from the run it continues")
    print(f"{label}: resumed from the step-{dense} checkpoint ({ckpt_bytes / 1e9:.2f} GB), "
          f"{neighbor} neighbor steps bit-equal to the uninterrupted run (params, w_hat, "
          f"every metric); resume leg {t4 - t3:.1f} s (restore, steps, checkpoint)")
    del resumed, first
    shutil.rmtree(ckpt, ignore_errors=True)
    if not on_card:
        return counts, {}
    torch.cuda.empty_cache()
    rows = _train_rows(torch, dev, run.params, run.w_hat)

    # one dense step under the profiler
    step = steps_mod.make_train_step(dataclasses.replace(run.setup, mix="dense"),
                                     n_model_params=n_par)
    b = next(T._batches(cfg, m, TRAIN_BATCH, seq, TRAIN_SEED, dev))
    params, w_hat = run.params, run.w_hat
    n_act, busy, per_name, count = _device_activity(
        torch, lambda: step(params, w_hat, b, run.step))
    if not n_act:
        print(f"{label} profile: the profiler saw no device activity; busy share not measured")
    else:
        own, seen = {}, _repo_counts(count)
        for name, t in per_name.items():
            if fn := _repo_kernel(name):
                own[fn] = own.get(fn, 0.0) + t
        events = sum(own.values())
        print(f"{label} profile: one dense step, {n_act} device activities, device busy "
              f"{busy:.1f} ms of {ms['dense']:.1f} ms/step without the profiler (idle share "
              f"{1 - busy / ms['dense']:.3f}); Events 2-3 kernels {events:.3f} ms "
              f"({events / busy:.4f} of busy): " + ", ".join(
                  f"{k} {v:.3f} ({seen.get(k, 0)} activities)" for k, v in sorted(own.items())))
        for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{label} profile:   {t:9.3f} ms ({t / busy:.3f} of busy)  {name[:90]}")
    k = run.step + 1
    del run, b, step
    _train_firing(torch, dev, cfg, params, w_hat, k, seq, label)
    del params, w_hat
    torch.cuda.empty_cache()
    _train_twin(torch, dev)
    return counts, rows


# ---------------------------------------------------------------------------
# phases 12-14: the MLA and MoE architectures
# ---------------------------------------------------------------------------

# one MoE layer's scatter against its dense oracle: the tokens, and the
# bf16 outputs' tolerance (the two impls sum in different orders)
MOE_SCATTER_VS_DENSE_TOKENS = 512
MOE_BF16_REL_L2 = 1e-2
# the MoE phases' weights and tokens
MOE_SEED = 0
# phases 12-13: the requests decoded, their prompt and greedy tokens, the
# cache's length, and the prefill that warms the libraries first
SERVE_MOE_REQUESTS, SERVE_MOE_PROMPT, SERVE_MOE_NEW, SERVE_MOE_CACHE_LEN = 4, 16, 16, 64
SERVE_MOE_WARM = 1024
# phase 10's MoE smoke configurations: tokens a row (two rows), and the
# capacity factor of the scatter leg, at which pairs drop
SERVE_CPU_MOE_SEQ = 128
SERVE_CPU_MOE_DROP_CF = 0.5


def deepseek_serve():
    """deepseek-v3-671b at its full width in bf16, its depth cut from 61 to
    2 layers with the reference's smoke block mix (an ``mla`` layer with the
    dense FFN, an ``mla_moe`` layer with 256 routed experts and the shared
    one), the MTP head's parameters kept."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=2,
                               layer_plan=((("mla",), 1), (("mla_moe",), 1)))


def _dtype_of(cfg):
    from repro_torch.models.layers import torch_dtype

    return torch_dtype(cfg.dtype)


def _no_drop(cfg):
    """``cfg`` with a MoE capacity that holds every token of any batch:
    capacity_factor = n_experts / top_k makes each expert's queue as long
    as the batch.  Decode is held against a forward at this capacity
    (its own steps of B <= 4 tokens drop none: the capacity's floor is 4)."""
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


@contextlib.contextmanager
def _moe_drops():
    """The (pairs, dropped) counts of every MoE capacity decision while the
    block runs (``moe._queue_slots`` wrapped; device tensors, no sync)."""
    from repro_torch.models import moe

    real, seen = moe._queue_slots, []

    def counted(idx, n_experts, cap):
        slot, keep = real(idx, n_experts, cap)
        seen.append((keep.numel(), (~keep).sum()))
        return slot, keep

    moe._queue_slots = counted
    try:
        yield seen
    finally:
        moe._queue_slots = real


@contextlib.contextmanager
def _moe_routing():
    """Every MoE layer's routing while the block runs, on the host in call
    order: the top-k indices (``moe.router_probs``) and, where the impl
    queues its pairs, the slots and keep masks (``moe._queue_slots``)."""
    from repro_torch.models import moe

    real_probs, real_slots, seen = moe.router_probs, moe._queue_slots, []

    def probs(m, p, x):
        vals, idx, aux = real_probs(m, p, x)
        seen.append(("top-k indices", idx.cpu()))
        return vals, idx, aux

    def slots(idx, n_experts, cap):
        slot, keep = real_slots(idx, n_experts, cap)
        seen.extend((("slots", slot.cpu()), ("keep masks", keep.cpu())))
        return slot, keep

    moe.router_probs, moe._queue_slots = probs, slots
    try:
        yield seen
    finally:
        moe.router_probs, moe._queue_slots = real_probs, real_slots


def _drop_share(seen) -> tuple[float, int]:
    pairs = sum(n for n, _ in seen)
    return (float(sum(int(d) for _, d in seen)) / pairs if pairs else 0.0), len(seen)


def _moe_scatter_vs_dense(torch, dev, cfg, ffn, label: str) -> None:
    """One MoE layer's ``scatter`` against its ``dense`` oracle on
    MOE_SCATTER_VS_DENSE_TOKENS random bf16 tokens, at a capacity that
    drops none."""
    import dataclasses

    from repro_torch.models import moe

    tokens = MOE_SCATTER_VS_DENSE_TOKENS
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev).to(_dtype_of(cfg))
    base = _no_drop(cfg)
    out = {}
    with _moe_drops() as seen:
        for impl in ("scatter", "dense"):
            c = dataclasses.replace(base, moe=dataclasses.replace(base.moe, impl=impl))
            with torch.no_grad():
                out[impl] = moe.moe_ffn(c, ffn, x)[0].float()
    share, _ = _drop_share(seen)
    rel = float((out["scatter"] - out["dense"]).norm() / out["dense"].norm())
    err = float((out["scatter"] - out["dense"]).abs().max())
    check(share == 0.0, f"{label}: the no-drop capacity dropped {share:.3g} of the pairs")
    check(bool(torch.isfinite(out["scatter"]).all()) and rel <= MOE_BF16_REL_L2,
          f"{label}: scatter vs dense rel L2 {rel:.3g} > {MOE_BF16_REL_L2}")
    print(f"{label}: MoE scatter vs dense oracle on {tokens} tokens, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k}, no drops: rel L2 {rel:.3g}, max abs err {err:.3g} "
          f"(tol rel L2 {MOE_BF16_REL_L2}, bf16)")


def phase_serve_moe(torch, dev, cfg, seq: int) -> None:
    """An MLA / MoE architecture (``cfg``, bf16, seeded weights): one
    prefill of ``seq`` tokens at B=1 (after one of SERVE_MOE_WARM tokens
    that warms the libraries) with its MoE capacity drops counted and,
    where the model has MLA, the chunked MLA path's calls; then
    SERVE_MOE_REQUESTS requests decoded token by token (SERVE_MOE_PROMPT
    tokens replayed into a SERVE_MOE_CACHE_LEN cache, SERVE_MOE_NEW greedy
    ones) against ``forward`` on the same tokens at a capacity that drops
    none (the decode steps drop none at the model's own); then one MoE
    layer's ``scatter`` against its ``dense`` oracle."""
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    n_req, prompt, new = SERVE_MOE_REQUESTS, SERVE_MOE_PROMPT, SERVE_MOE_NEW
    cache_len, warm, seed = SERVE_MOE_CACHE_LEN, SERVE_MOE_WARM, MOE_SEED
    on_card = torch.device(dev).type == "cuda"
    label = f"serve {cfg.name} {cfg.n_layers}L"
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    _sync(torch, dev)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{label}: {n_params} parameters ({n_bytes / 1e9:.2f} GB, {cfg.dtype} with fp32 "
          f"routers{', the MTP head included' if cfg.mtp else ''}) drawn on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    prefill = steps.make_prefill_step(cfg)
    tokens = torch.as_tensor(token_dataset(seq, vocab=cfg.vocab, seed=seed),
                             dtype=torch.int64, device=dev)[None]
    prefill(params, {"tokens": tokens[:, :warm]})
    chunked = []
    real_chunked = attn_mod._mla_chunked
    attn_mod._mla_chunked = lambda *a: chunked.append(1) or real_chunked(*a)
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        with _moe_drops() as seen:
            t1 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            _sync(torch, dev)
            prefill_ms = (time.perf_counter() - t1) * 1e3
    finally:
        attn_mod._mla_chunked = real_chunked
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else float("nan")
    drop, n_moe = _drop_share(seen)
    n_mla = sum(bt in ("mla", "mla_moe") for cyc, rep in cfg.layer_plan for bt in cyc
                for _ in range(rep))
    check(tuple(logits.shape) == (1, seq, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{label} prefill: logits {tuple(logits.shape)} not finite or misshaped")
    check(n_moe == sum(bt in ("moe", "mla_moe") for cyc, rep in cfg.layer_plan
                       for bt in cyc for _ in range(rep)),
          f"{label} prefill: {n_moe} MoE capacity decisions")
    if n_mla:
        check(len(chunked) == n_mla, f"{label} prefill: the chunked MLA path ran "
                                     f"{len(chunked)} times for {n_mla} MLA layers")
    del logits
    print(f"{label} prefill B=1 S={seq}: logits finite; {prefill_ms:.1f} ms "
          f"({seq / prefill_ms * 1e3:.0f} tokens/s, host clock to a sync, after a "
          f"{warm}-token warm-up); peak memory allocated {peak:.2f} GiB; MoE "
          f"capacity dropped {drop:.4f} of the (token, expert) pairs over {n_moe} "
          f"layers{f'; the chunked MLA path in all {n_mla} MLA layers' if n_mla else ''}; "
          f"card {card_state() if on_card else 'not measured'}", flush=True)

    serve = steps.make_serve_step(cfg)
    with _moe_drops() as seen:
        fed, dec, cache, replay_ms, step_ms = _decode_requests(
            torch, dev, cfg, params, serve, n_req, prompt, new, cache_len, seed)
    dec_drop, _ = _drop_share(seen)
    check(dec_drop == 0.0, f"{label} decode: capacity dropped {dec_drop:.3g} of the pairs")
    fwd = steps.make_prefill_step(_no_drop(cfg))(params, {"tokens": fed}).float()
    rel = float(((dec - fwd).norm(dim=(1, 2)) / fwd.norm(dim=(1, 2))).max())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    check(bool(torch.isfinite(dec).all()) and rel <= 5e-2,
          f"{label} decode: decode logits vs forward relative L2 {rel:.3g} > 5e-2")
    attn_kind = "absorbed MLA" if n_mla else "KV"
    print(f"{label} decode B={n_req} cache_len={cache_len} ({attn_kind} cache): {prompt} "
          f"prompt tokens replayed in {replay_ms:.2f} ms/step, {new} greedy "
          f"steps at {step_ms:.2f} ms/step ({n_req * 1e3 / step_ms:.1f} "
          f"tokens/s), no pair dropped; logits at {prompt + new} positions vs forward "
          f"(no-drop capacity): max relative L2 {rel:.3g} (tol 5e-2), argmax agreement "
          f"{agree:.3f}", flush=True)
    del cache, dec, fwd

    stage, block = next((si, f"{bi}_{bt}") for si, (cyc, _) in enumerate(cfg.layer_plan)
                        for bi, bt in enumerate(cyc) if bt in ("moe", "mla_moe"))
    ffn = {k: v[0] for k, v in params["stages"][stage][block]["ffn"].items()}
    _moe_scatter_vs_dense(torch, dev, cfg, ffn, label)
    del params, ffn
    if on_card:
        torch.cuda.empty_cache()


def phase_serve_cpu_moe(torch, dev) -> None:
    """The granite-moe and deepseek-v3 smoke configurations (fp32) on the
    card and on the CPU, one set of weights, through the dense MoE oracle
    and through the scatter at capacity factor SERVE_CPU_MOE_DROP_CF, where
    pairs drop: the logits within atol=rtol 1e-4, and in every MoE layer
    the top-k expert indices, and the scatter's slots and keep masks,
    equal."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    seq = SERVE_CPU_MOE_SEQ
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        base = smoke_config(arch)
        cpu_params = M.init_params(base, torch.Generator().manual_seed(MOE_SEED), "cpu")
        card_params = M.tree_map(lambda t: t.to(dev), cpu_params)
        tokens = torch.as_tensor(token_dataset(2 * seq, vocab=base.vocab, seed=MOE_SEED),
                                 dtype=torch.int64).reshape(2, seq)
        scatter = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, impl="scatter", capacity_factor=SERVE_CPU_MOE_DROP_CF))
        for cfg in (base, scatter):
            prefill = steps.make_prefill_step(cfg)
            label = f"serve_cpu {cfg.name} {cfg.moe.impl}"
            with _moe_routing() as on_card:
                card = prefill(card_params, {"tokens": tokens.to(dev)}).cpu()
            with _moe_routing() as on_cpu:
                cpu = prefill(cpu_params, {"tokens": tokens})
            kinds = [kind for kind, _ in on_card]
            check(kinds and kinds == [kind for kind, _ in on_cpu],
                  f"{label}: routing decisions {kinds} on the card, "
                  f"{[kind for kind, _ in on_cpu]} on the CPU")
            for (kind, a), (_, b) in zip(on_card, on_cpu):
                check(torch.equal(a, b), f"{label}: {kind} differ between the card and the CPU")
            keep = [k for kind, k in on_card if kind == "keep masks"]
            dropped = sum(int((~k).sum()) for k in keep) / max(sum(k.numel() for k in keep), 1)
            check(cfg.moe.impl == "dense" or dropped > 0,
                  f"{label}: no pair dropped at capacity factor {cfg.moe.capacity_factor}")
            err = float((card - cpu).abs().max())
            check(bool(torch.allclose(card, cpu, atol=1e-4, rtol=1e-4)),
                  f"{label}: card vs cpu logits outside atol=rtol 1e-4 (max abs err {err:.3g})")
            n_layers = kinds.count("top-k indices")
            print(f"serve card vs cpu {cfg.name} fp32 S={seq} {cfg.moe.impl}"
                  f"{f' capacity factor {cfg.moe.capacity_factor}' if keep else ''}: logits max "
                  f"abs err {err:.3g} (tol atol=rtol 1e-4); top-{cfg.moe.top_k} expert indices"
                  f"{', slots and keep masks' if keep else ''} equal in all {n_layers} MoE "
                  f"layers ({on_card[0][1].numel()} picks each"
                  f"{f'; {dropped:.4f} of them dropped' if keep else ''})")


def _moe_repeats(torch, dev, cfg, tokens: int) -> float:
    """One MoE layer (random weights) forward and backward twice on the
    same ``tokens`` tokens at capacity factor 0.5, so that pairs drop to
    the overflow slot: the output and every gradient bit-equal, as the
    resume and the twins need.  Returns the share of (token, expert)
    pairs dropped."""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    p = moe.init_moe(cfg, gen, _dtype_of(cfg), dev)
    leaves = [p[k].requires_grad_() for k in sorted(p)]
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev).to(_dtype_of(cfg))
    x.requires_grad_()
    g = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev).to(x.dtype)
    runs = []
    with _moe_drops() as seen:
        for _ in range(2):
            out, aux = moe.moe_ffn(cfg, p, x)
            runs.append((out, *torch.autograd.grad((out * g).sum() + aux, leaves + [x])))
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{cfg.name}: the MoE layer's output or gradients differ between two runs")
    drop = _drop_share(seen[:1])[0]
    check(drop > 0, f"{cfg.name}: no pair dropped at capacity factor 0.5")
    return drop


def _train_legs(torch, dev, cfg, seq: int, label: str):
    """Phases 14 and 19's run: TRAIN_DENSE dense then TRAIN_NEIGHBOR
    neighbor steps of ``cfg`` through ``repro_torch.launch.train.train``
    (TRAIN_M replicas, TRAIN_PODS pods, global batch TRAIN_BATCH at ``seq``
    tokens), the launches and the peak memory counted from zero.  Returns
    the two runs, the launches, the legs' wall seconds, the peak GiB (nan
    off the card) and the median ms/step of each schedule (the first step,
    which warms the libraries, left out)."""
    from repro_torch.launch import train as T

    def log(line: str) -> None:
        print(f"{label}: {line}", flush=True)

    kw = dict(m=TRAIN_M, batch=TRAIN_BATCH, seq=seq, pods=TRAIN_PODS, seed=TRAIN_SEED,
              device=dev, log=log, log_every=1)
    _reset_launches()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.zeros(1, device=dev)  # the allocator's stats exist once it has run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = T.train(cfg, steps=TRAIN_DENSE, **kw)
    t1 = time.perf_counter()
    run = T.train(cfg, steps=TRAIN_NEIGHBOR, mix="neighbor",
                  state=(first.params, first.w_hat, first.step), **kw)
    _sync(torch, dev)
    t2 = time.perf_counter()
    counts = {k: n for k, n in _launches().items() if n}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else float("nan")
    ms = {"dense": statistics.median(first.step_ms[1:]) if TRAIN_DENSE > 1 else float("nan"),
          "neighbor": statistics.median(run.step_ms)}
    return first, run, counts, (t1 - t0, t2 - t1), peak, ms


def phase_train_moe(torch, dev, cfg=None, seq: int = 2048
                    ) -> tuple[dict[str, int], dict[str, dict]]:
    """EF-HC training of granite-moe-3b-a800m at full width and depth (32
    layers, bf16 with fp32 routers, the scatter MoE) through
    ``repro_torch.launch.train.train``, phase 11's cell without its
    checkpoint round: TRAIN_M replicas on a ring over TRAIN_PODS pods,
    global batch TRAIN_BATCH at ``seq`` tokens, TRAIN_DENSE dense then
    TRAIN_NEIGHBOR neighbor steps.  Each entry of the trigger and mixing
    wrappers must launch once a leaf of its dtype a step: the bf16 entries
    on the bf16 leaves, the fp32 kernels on the routers.  Then one profiled
    dense step (busy, idle, the kernels' and the MoE scatter / gather
    kernels' shares, and the expert products' from the kernels of the
    trace's ``aten::bmm`` calls on the experts' slabs), one MoE layer's
    forward and backward twice with drops, bit-equal (``_moe_repeats``);
    after the rest of the state is freed, the bf16 entries against their
    plain versions at the (4, 805306368) expert leaf and the fp32 kernels
    at the (4, 1572864) router rows (``_router_rows``); and the smoke
    configuration's card-vs-CPU twin.  Returns the launches and the
    kernel rows' ``*_moe_leaf`` and ``*_router`` fields."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    m, dense, neighbor = TRAIN_M, TRAIN_DENSE, TRAIN_NEIGHBOR
    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or get_config("granite-moe-3b-a800m")
    label = (f"train_moe {cfg.name} {cfg.n_layers}L m={m} pods={TRAIN_PODS} "
             f"B={TRAIN_BATCH} S={seq}")
    first, run, counts, (leg1, leg2), peak, ms = _train_legs(torch, dev, cfg, seq, label)
    leaves = tree_leaves(run.params)
    n16 = sum(t.dtype == torch.bfloat16 for t in leaves)
    n32 = sum(t.dtype == torch.float32 for t in leaves)
    check(n16 + n32 == len(leaves) and n32 == sum(
        bt in ("moe", "mla_moe") for cyc, _ in cfg.layer_plan for bt in cyc),
        f"{label}: {n16} bf16 and {n32} fp32 leaves of {len(leaves)}")
    steps = dense + neighbor
    want = {"trigger_sq_bf16": n16 * steps, "trigger_sq": n32 * steps,
            "mix_bf16": n16 * dense, "mix": n32 * dense,
            "mix_sparse_bf16": n16 * neighbor, "mix_sparse": n32 * neighbor}
    check(counts == want, f"{label}: launches {counts}, expected {want} ({n16} bf16 and "
                          f"{n32} fp32 leaves)")
    records = first.records + run.records
    for r in records:
        check(np.isfinite(r["loss"]) and r["aux"] > 0 and 0.0 <= r["trigger_rate"] <= 1.0,
              f"{label}: step {r['k']} loss {r['loss']}, aux {r['aux']}, trigger_rate "
              f"{r['trigger_rate']}")
    warm = first.step_ms[1:] + run.step_ms  # the first step warms the libraries
    n_par = cfg.n_params
    print(f"{label}: {n_par} parameters a replica ({sum(t[0].numel() * t.element_size() for t in leaves) / 1e9:.3f} GB), "
          f"{n16} bf16 + {n32} fp32 leaves, the largest {tuple(max(leaves, key=torch.numel).shape)}; "
          f"step ms {[round(x, 1) for x in first.step_ms + run.step_ms]} (first includes "
          f"warm-up); median ms/step dense {ms['dense']:.1f}, neighbor {ms['neighbor']:.1f}; "
          f"tokens/s {run.tokens_per_step / statistics.median(warm) * 1e3:.0f} "
          f"({run.tokens_per_step} tokens a step); peak memory allocated {peak:.2f} GiB "
          f"(params and w_hat {2 * sum(t.numel() * t.element_size() for t in leaves) / 2 ** 30:.2f} GiB); "
          f"dense leg {leg1:.1f} s (init, {dense} steps), neighbor leg {leg2:.1f} s; "
          f"launches {counts}, exactly leaves x steps per dtype; trigger rates "
          f"{[r['trigger_rate'] for r in records]}; ce {[round(r['ce'], 4) for r in records]}; "
          f"aux {[round(r['aux'], 4) for r in records]}; card "
          f"{card_state() if on_card else 'not measured'}", flush=True)
    if not on_card:
        return counts, {}

    # one dense step under the profiler
    step = steps_mod.make_train_step(dataclasses.replace(run.setup, mix="dense"),
                                     n_model_params=n_par)
    b = next(T._batches(cfg, m, TRAIN_BATCH, seq, TRAIN_SEED, dev))
    params, w_hat = run.params, run.w_hat
    n_act, busy, per_name, count = _device_activity(
        torch, lambda: step(params, w_hat, b, run.step))
    moe = cfg.moe
    layers = sum(rep * len(cyc) for cyc, rep in cfg.layer_plan)

    def expert_bmm(name, shapes):  # _expert_ffn's products and their gradients'
        return (name == "aten::bmm" and len(shapes) == 2
                and all(len(x) == 3 and x[0] == moe.n_experts for x in shapes)
                and any(moe.d_expert in x[1:] for x in shapes))

    # a second dense step, with the host's ops: the expert products' kernels
    t3 = time.perf_counter()
    n_bmm, n_bmm_k, bmm_ms, busy_ops = _op_kernels(
        torch, lambda: step(params, w_hat, b, run.step), expert_bmm)
    t_ops = time.perf_counter() - t3
    # three products a layer and replica forward (two without a gate), twice
    # as many backward, and the forward again under remat
    per_layer = (3 if cfg.act in ("swiglu", "geglu") else 2) * (3 + bool(cfg.remat))
    check(n_bmm == m * layers * per_layer and n_bmm_k >= n_bmm,
          f"{label} profile: {n_bmm} expert products traced ({n_bmm_k} device activities), "
          f"expected {m * layers * per_layer}")
    if not n_act:
        print(f"{label} profile: the profiler saw no device activity; busy share not measured")
    else:
        own = {}
        for name, t in per_name.items():
            if fn := _repo_kernel(name):
                own[fn] = own.get(fn, 0.0) + t
        events = sum(own.values())
        index = sum(t for name, t in per_name.items() if "index" in name.lower()
                    or "radix" in name.lower() or "sort" in name.lower())
        print(f"{label} profile: one dense step, {n_act} device activities, device busy "
              f"{busy:.1f} ms of {ms['dense']:.1f} ms/step without the profiler (idle share "
              f"{1 - busy / ms['dense']:.3f}); Events 2-3 kernels {events:.3f} ms "
              f"({events / busy:.4f} of busy): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(own.items()))
              + f"; index_put / gather / sort kernels (the MoE scatter and gather, forward "
              f"and backward, and the embedding's) {index:.1f} ms ({index / busy:.3f} of "
              f"busy)", flush=True)
        print(f"{label} profile: a second dense step with the host's ops and shapes "
              f"({t_ops:.1f} s with the parse): device busy {busy_ops:.1f} ms; the expert "
              f"products (the {n_bmm_k} device activities of its {n_bmm} aten::bmm calls on "
              f"the experts' (E, ., .) slabs: forward, backward and the remat forward) "
              f"{bmm_ms:.1f} ms ({bmm_ms / busy_ops:.3f} of busy)", flush=True)
        for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{label} profile:   {t:9.3f} ms ({t / busy:.3f} of busy)  {name[:90]}")

    drop = _moe_repeats(torch, dev, cfg, TRAIN_BATCH // m * seq)
    print(f"{label}: one MoE layer's forward and backward twice on {TRAIN_BATCH // m * seq} "
          f"tokens at capacity factor 0.5 ({drop:.4f} of the pairs dropped): output and "
          f"every gradient bit-equal", flush=True)

    # the bf16 entries at the expert leaf and the fp32 kernels at the
    # router's rows, the rest of the state freed
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    router = next(i for i, t in enumerate(leaves) if t.dtype == torch.float32)
    w, h = leaves[big], tree_leaves(w_hat)[big]
    rw, rh = (ls[router].reshape(m, -1) for ls in (leaves, tree_leaves(w_hat)))
    del first, run, params, w_hat, leaves, step, b
    torch.cuda.empty_cache()
    rows = {name: {f"{k}_moe_leaf": row[k] for k in TRIGGER_FIELDS if k in row}
            for name, row in _train_rows(torch, dev, {"w": w}, {"w": h}).items()}
    del w, h
    torch.cuda.empty_cache()
    rows.update({name: {f"{k}_router": row[k] for k in TRIGGER_FIELDS if k in row}
                 for name, row in _router_rows(torch, dev, rw, rh).items()})
    del rw, rh
    _train_twin(torch, dev, "granite-moe-3b-a800m")
    return counts, rows


# ---------------------------------------------------------------------------
# phases 18-19: the dense configs' serving, hymba's training
# ---------------------------------------------------------------------------

# phase 18's cells: full-attention configs at full width and depth, S cut
# from the reference's prefill_32k (PERF.md section 4 reckons the memory)
DENSE_SERVE = {"deepseek-coder-33b": 8192, "phi3-medium-14b": 8192}


def _train_recurrent(torch, dev, cfg, seq: int, kernels: dict[str, int], share: str,
                     twin_arch: str, plain_card=None, held=None, profile_check=None
                     ) -> tuple[dict[str, int], dict[str, float]]:
    """Phases 19 and 20: EF-HC training of ``cfg`` through
    ``repro_torch.launch.train.train``, phase 14's cell (TRAIN_M replicas on
    a ring over TRAIN_PODS pods, global batch TRAIN_BATCH at ``seq`` tokens,
    TRAIN_DENSE dense then TRAIN_NEIGHBOR neighbor steps): each bf16 entry of
    the trigger and mixing wrappers must launch once a leaf a step (by
    schedule) and the recurrence's kernels exactly ``kernels`` times
    (counts a layer, replica and step: the saving forward's, twice under
    remat, and the backward's); then one profiled dense step (busy, idle,
    the share of the repo kernels whose names start with ``share``, and
    Events 2-3's; ``profile_check(per_name, label)`` on its records) and the
    smoke configuration's card-vs-CPU twin (``_train_twin``, ``plain_card``
    and ``held`` its yardstick).  Returns the
    launches and the step's figures."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    m, dense, neighbor = TRAIN_M, TRAIN_DENSE, TRAIN_NEIGHBOR
    on_card = torch.device(dev).type == "cuda"
    label = (f"train {cfg.name} {cfg.n_layers}L m={m} pods={TRAIN_PODS} "
             f"B={TRAIN_BATCH} S={seq}")
    first, run, counts, (leg1, leg2), peak, ms = _train_legs(torch, dev, cfg, seq, label)
    leaves = tree_leaves(run.params)
    check(all(t.dtype == torch.bfloat16 for t in leaves), f"{label}: a leaf not in bf16")
    steps = dense + neighbor
    n = len(leaves)
    want = {"trigger_sq_bf16": n * steps, "mix_bf16": n * dense, "mix_sparse_bf16": n * neighbor,
            **{k: v * m * steps for k, v in kernels.items()}}
    check(counts == want, f"{label}: launches {counts}, expected {want} ({n} bf16 leaves; "
                          f"{kernels} a replica and step)")
    records = first.records + run.records
    for r in records:
        check(np.isfinite(r["loss"]) and 0.0 <= r["trigger_rate"] <= 1.0,
              f"{label}: step {r['k']} loss {r['loss']}, trigger_rate {r['trigger_rate']}")
    warm = first.step_ms[1:] + run.step_ms  # the first step warms the libraries
    tokens_s = run.tokens_per_step / statistics.median(warm) * 1e3
    rep_bytes = sum(t[0].numel() * t.element_size() for t in leaves)
    print(f"{label}: {cfg.n_params} parameters a replica ({rep_bytes / 1e9:.3f} GB), {n} bf16 "
          f"leaves; step ms {[round(x, 1) for x in first.step_ms + run.step_ms]} (first "
          f"includes warm-up); median ms/step dense {ms['dense']:.1f}, neighbor "
          f"{ms['neighbor']:.1f}; tokens/s {tokens_s:.0f} ({run.tokens_per_step} tokens a "
          f"step); peak memory allocated {peak:.2f} GiB (params and w_hat "
          f"{2 * m * rep_bytes / 2 ** 30:.2f} GiB); dense leg {leg1:.1f} s (init, {dense} "
          f"steps), neighbor leg {leg2:.1f} s; launches {counts}, as expected; trigger "
          f"rates {[r['trigger_rate'] for r in records]}; loss "
          f"{[round(r['loss'], 4) for r in records]}; card "
          f"{card_state() if on_card else 'not measured'}", flush=True)
    figures = {"ms_per_step": ms["dense"], "tokens_per_s": tokens_s, "peak_gib": peak}
    if not on_card:
        return counts, figures

    step = steps_mod.make_train_step(run.setup, n_model_params=cfg.n_params)
    b = next(T._batches(cfg, m, TRAIN_BATCH, seq, TRAIN_SEED, dev))
    params, w_hat = run.params, run.w_hat
    n_act, busy, per_name, _ = _device_activity(torch, lambda: step(params, w_hat, b, run.step))
    if not n_act:
        print(f"{label} profile: the profiler saw no device activity; busy share not measured")
    else:
        if profile_check is not None:
            profile_check(per_name, label)
        own: dict[str, float] = {}
        for name, t in per_name.items():
            if fn := _repo_kernel(name):
                own[fn] = own.get(fn, 0.0) + t
        rec = sum(t for fn, t in own.items() if fn.startswith(share))
        events = sum(t for fn, t in own.items() if fn.startswith(("trigger", "mix")))
        figures.update(busy_ms=busy, kernel_share=rec / busy)
        print(f"{label} profile: one dense step, {n_act} device activities, device busy "
              f"{busy:.1f} ms of {ms['dense']:.1f} ms/step without the profiler (idle share "
              f"{1 - busy / ms['dense']:.3f}); the {share} kernels {rec:.1f} ms "
              f"({rec / busy:.3f} of busy), Events 2-3 kernels {events:.3f} ms "
              f"({events / busy:.4f} of busy): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(own.items())), flush=True)
        for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{label} profile:   {t:9.3f} ms ({t / busy:.3f} of busy)  {name[:90]}")
    del first, run, params, w_hat, leaves, step, b
    torch.cuda.empty_cache()
    _train_twin(torch, dev, twin_arch, plain_card=plain_card, held=held)
    return counts, figures


def phase_train_hybrid(torch, dev, cfg=None, seq: int = 2048
                       ) -> tuple[dict[str, int], dict[str, float]]:
    """EF-HC training of hymba-1.5b at full width and depth (32 layers,
    bf16, remat on, attention through ``xla`` at S=2048), ``_train_recurrent``:
    the scan's saving forward twice a Mamba layer, replica and step (the
    forward and remat's recompute) and its backward once, and no SWA kernel;
    the scan kernels' share of the profiled step."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("hymba-1.5b")
    mamba = len(serve_layers(cfg)[1])
    return _train_recurrent(torch, dev, cfg, seq, {
        "selective_scan": mamba * (1 + bool(cfg.remat)), "selective_scan_bwd": mamba},
        "selective_scan", "hymba-1.5b")


def phase_train_xlstm(torch, dev, cfg=None, seq: int = 2048
                      ) -> tuple[dict[str, int], dict[str, float]]:
    """EF-HC training of xlstm-125m at full width and depth (12 layers: 8
    mLSTM, 4 sLSTM, dh 192, bf16, remat on), ``_train_recurrent``: the
    sLSTM kernel's saving forward twice an sLSTM layer, replica and step
    (the forward and remat's recompute) and its backward once; the sLSTM
    kernels' share of the profiled step, every sLSTM forward there the
    saving variant; the twin's TWIN_HELD_LEAF held to the card run with the
    sLSTM kernels' plain versions."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("xlstm-125m")
    slstm = len(_layer_indices(cfg, lambda bt: bt == "slstm"))

    def saving_only(per_name, label):
        serving = [name for name in per_name
                   if _repo_kernel(name) == "slstm_kernel" and "true>" not in name]
        check(not serving, f"{label} profile: the serving sLSTM forward ran in training: "
                           f"{serving}")

    return _train_recurrent(torch, dev, cfg, seq, {
        "slstm": slstm * (1 + bool(cfg.remat)), "slstm_bwd": slstm}, "slstm", "xlstm-125m",
        plain_card=_plain_slstm, held=TWIN_HELD_LEAF, profile_check=saving_only)


@contextlib.contextmanager
def _plain_slstm():
    """The sLSTM wrapper's launches on the card swapped for the kernels'
    plain versions (the saving forward for ``slstm_scan_save_ref``, the
    backward for ``slstm_bwd_walk_ref``), as ``_plain_train_kernels`` swaps
    Events 2-3's: the yardstick run of phase 20's twin."""
    from repro_torch.kernels.slstm import ops as slstm_ops
    from repro_torch.kernels.slstm import ref as slstm_ref

    def launch(pre, r, b, st, *, save):
        hs, out, saved = slstm_ref.slstm_scan_save_ref(pre, r, b, st)
        return hs, out, saved if save else None

    def launch_bwd(r, saved, dhs, dfinal, dtype):
        zeros = dfinal[0].new_zeros  # h0 and hs: read for dR and db alone, taken elsewhere
        dpx, _, _, d0 = slstm_ref.slstm_bwd_walk_ref(r, zeros(dfinal[0].shape), saved,
                                                     zeros(dhs.shape), dhs, dfinal, dtype)
        return dpx, d0

    held = slstm_ops._launch, slstm_ops._launch_bwd
    slstm_ops._launch, slstm_ops._launch_bwd = launch, launch_bwd
    try:
        yield
    finally:
        slstm_ops._launch, slstm_ops._launch_bwd = held


# kernel functions of csrc/ (the names the profiler shows)
REPO_KERNELS = ("trigger_sq_slab_kernel", "trigger_sq_rows_kernel", "mix_kernel",
                "mix_sparse_kernel", "compact_slots_kernel", "mix_sparse_wide_kernel",
                "row_finite_kernel", "mix_sparse_direct_kernel", "swa_kernel",
                "swa_tc_kernel", "swa_tf32_kernel", "mix_bf16_kernel",
                "mix_sparse_bf16_kernel", "selective_scan_kernel", "selective_scan_save_kernel",
                "selective_scan_bwd_kernel", "selective_scan_bwd_sum_kernel", "slstm_kernel",
                "slstm_bwd_kernel")

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
    "trigger_sq_bf16": ("src/repro_torch/kernels/csrc/trigger_sq.cu",
                        "src/repro/kernels/trigger/kernel.py:39"),
    "mix_bf16": ("src/repro_torch/kernels/csrc/mix.cu",
                 "src/repro/kernels/mixing/kernel.py:32"),
    "mix_sparse_bf16": ("src/repro_torch/kernels/csrc/mix_sparse.cu",
                        "src/repro/kernels/mixing/kernel.py:74"),
    # no TPU kernel: the reference's XLA associative scan
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/models/ssm.py:87"),
    # no TPU kernel: the reference's lax.scan over time
    "slstm": ("src/repro_torch/kernels/csrc/slstm.cu", "none: src/repro/models/ssm.py:336"),
    # no TPU kernel: jax.grad through the reference's XLA associative scan
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                           "none: jax.grad of src/repro/models/ssm.py:87"),
    # no TPU kernel: jax.grad through the reference's lax.scan over time
    "slstm_bwd": ("src/repro_torch/kernels/csrc/slstm_bwd.cu",
                  "none: jax.grad of src/repro/models/ssm.py:336"),
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
        counts, seen_bf16 = phase_serve(torch, dev)
        launches["swa_attention_tc"] = counts["swa_attention_tc"]
        lap("phase 8")
        counts, seen_fp32 = phase_serve(torch, dev, cfg=starcoder2_fp32(), seq=8192,
                                        twin="chunked")
        launches["swa_attention_tf32"] = counts["swa_attention_tf32"]
        lap("phase 9")
        smoke, seen_smoke = phase_serve_cpu(torch, dev)
        hymba_smoke, seen_hymba_smoke = phase_serve_cpu(torch, dev, "hymba-1.5b")
        rows["slstm"]["serve_cpu_launches"] = phase_serve_cpu(torch, dev, "xlstm-125m")[0][
            "slstm"]
        phase_serve_cpu(torch, dev, "paligemma-3b")
        phase_serve_cpu(torch, dev, "hubert-xlarge")
        phase_serve_cpu_moe(torch, dev)
        lap("phase 10")
        torch.cuda.empty_cache()  # the serve phases' weights are gone
        train_launches, train_rows = phase_train(torch, dev)
        launches.update(train_launches)
        rows.update(train_rows)
        lap("phase 11")
        from repro_torch.configs import get_config
        phase_serve_moe(torch, dev, deepseek_serve(), seq=8192)
        lap("phase 12")
        phase_serve_moe(torch, dev, get_config("granite-moe-3b-a800m"), seq=32768)
        lap("phase 13")
        moe_launches, moe_rows = phase_train_moe(torch, dev)
        for name, n in moe_launches.items():
            rows[name]["train_moe_launches"] = n
        for name, row in moe_rows.items():
            rows[name].update(row)
        lap("phase 14")
        hybrid, seen_hybrid = phase_serve(torch, dev, get_config("hymba-1.5b"),
                                          heads=HYMBA_HEADS, fp32_twin=True)
        launches["selective_scan"] = hybrid["selective_scan"]
        rows["swa_attention_tc"]["hybrid_launches"] = hybrid["swa_attention_tc"]
        lap("phase 15")
        xlstm, _ = phase_serve(torch, dev, get_config("xlstm-125m"), fp32_twin=True)
        launches["slstm"] = xlstm["slstm"]
        lap("phase 16")
        phase_serve_frontends(torch, dev, "paligemma-3b")
        phase_serve_frontends(torch, dev, "hubert-xlarge")
        lap("phase 17")
        torch.cuda.empty_cache()  # 62.1 GiB of deepseek-coder's weights come next
        for arch, seq in DENSE_SERVE.items():
            phase_serve(torch, dev, get_config(arch), seq=seq)
        lap("phase 18")
        hybrid_train, _ = phase_train_hybrid(torch, dev)
        launches["selective_scan_bwd"] = hybrid_train["selective_scan_bwd"]
        rows["selective_scan"]["train_hybrid_launches"] = hybrid_train["selective_scan"]
        lap("phase 19")
        xlstm_train, _ = phase_train_xlstm(torch, dev)
        launches["slstm_bwd"] = xlstm_train["slstm_bwd"]
        rows["slstm"]["train_xlstm_launches"] = xlstm_train["slstm"]
        lap("phase 20")
        launches["swa_attention"] = simt_launches({
            "serve prefill bf16": (launches["swa_attention_tc"], "swa_tc_kernel", seen_bf16),
            "serve prefill fp32": (launches["swa_attention_tf32"], "swa_tf32_kernel",
                                   seen_fp32),
            "serve card vs cpu": (smoke["swa_attention_tf32"], "swa_tf32_kernel", seen_smoke),
            "serve card vs cpu hymba": (hymba_smoke["swa_attention_tf32"], "swa_tf32_kernel",
                                        seen_hymba_smoke),
            "serve prefill hybrid": (hybrid["swa_attention_tc"], "swa_tc_kernel",
                                     seen_hybrid)})
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
                                   "library_ms_m4096_r04", "sass_tensor_ops",
                                   "train_moe_launches", "shape_moe_leaf",
                                   "max_abs_err_moe_leaf", "ms_moe_leaf",
                                   "plain_ms_moe_leaf", "library_ms_moe_leaf",
                                   "bound_ms_moe_leaf", "shape_router",
                                   "max_abs_err_router", "ms_router", "plain_ms_router",
                                   "library_ms_router", "bound_ms_router",
                                   "shape_hymba", "ms_hymba", "device_ms_hymba",
                                   "library_ms_hymba", "bound_ms_hymba",
                                   "bound_share_hymba", "hybrid_launches", "plan",
                                   "registers", "sum_registers", "blocks_per_sm",
                                   "mufu_ex2_step",
                                   "serial_floor_ms", "sync_loop_ms", "fp64_reference",
                                   "serial_floor_ms_design", "sync_loop_ms_design",
                                   "us_per_step", "serve_cpu_launches", "device_ms",
                                   "bound_share", "train_hybrid_launches",
                                   "train_xlstm_launches", "stack", "fwd_ms", "fwd_save_ms",
                                   "fwd_device_ms", "fwd_save_device_ms", "fwd_us_per_step",
                                   *(f"{k}{suffix}" for suffix in ("_long", "_long_fp32")
                                     for k in SLSTM_BWD_FIELDS),
                                   *(f"{k}{suffix}" for suffix in ("_long", "_long_fp32")
                                     for k in SCAN_BWD_FIELDS),
                                   *(f"{k}{suffix}" for suffix in TRIGGER_SUFFIXES
                                     for k in TRIGGER_FIELDS),
                                   *(f"{k}_fp32" for k in SCAN_FIELDS + SLSTM_FIELDS
                                     + SCAN_BWD_FIELDS + SLSTM_BWD_FIELDS))
               if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
