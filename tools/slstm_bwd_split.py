#!/usr/bin/env python3
"""Where a step of the sLSTM backward kernel goes, and the kernel against an
earlier tree's, on one GPU.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    PYTHONPATH=src python3 tools/slstm_bwd_split.py --parent build/parent --out OUT

Builds, beside each other (nvcc, sm_90a, into build/slstm_bwd_split/):
``slstm_bwd.cu`` of this tree and of the earlier one (``--parent``), this
tree's with ``__fdiv_rn`` in place of ``div_rn``, and copies of both kernels
stamped with ``clock64()`` (written here from the sources, never kept).
At chip_smoke.py's phase-2 shapes, in bf16 and fp32 on the same inputs
(the saving forward of this tree's library), it prints for each build the
gradients' bits against this tree's, their largest error against the plain
walk, and device ms from the profiler in turns (earlier, this, variant,
variant, this, earlier); at the train shape each stamped kernel's clocks a
step by phase (mean, least, most, by consumer warp).  Then div_rn against
``__fdiv_rn`` over 2^28 pairs inside its guard and 2^28 random bit
patterns.  SASS (``cuobjdump -sass``) and ptxas' reports go to OUT.

Phases of a step, each ended by storing its last values to shared memory
(so a stamp follows their completion; stamped kernels run ~1.1x slower):
wait (for d pre_{t+1}), product (with its shuffles), row (the earlier
kernel: the step's row-only work after the product; this one: the step's
terms loaded ahead of the wait), chain (the derivatives that dh_rec
feeds), send (st.async and the store of d pre_x), tile (ring or terms
handshakes a tile, spread over its steps).
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.slstm import ops  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_bwd_walk_ref  # noqa: E402

WORK = ROOT / "build" / "slstm_bwd_split"
PHASES = ("wait", "product", "row", "chain", "send", "tile", "total")
STAMPS = '''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
#define SINK(v) (sinkbuf[threadIdx.x] = (v))
'''
WRITE = '''
    if (lane == 0 && g_stamps) {
      unsigned long long* o = g_stamps + ((int64_t)(bh * NC + rank) * W + warp) * 8;
      o[0] = a_wait; o[1] = a_prod; o[2] = a_row; o[3] = a_chain; o[4] = a_send;
      o[5] = a_tile; o[6] = stamp() - t_begin; o[7] = (unsigned long long)S;
    }
'''
DIVTEST = '''
#include "slstm_bwd.cu"
__global__ void divtest_kernel(const float* a, const float* b, float* fast, float* ieee,
                               int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    fast[i] = div_rn(a[i], b[i], rcp(b[i]));
    ieee[i] = __fdiv_rn(a[i], b[i]);
  }
}
extern "C" int repro_divtest(const void* a, const void* b, void* fast, void* ieee, int64_t n) {
  divtest_kernel<<<1056, 256>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                static_cast<float*>(fast), static_cast<float*>(ieee), n);
  return (int)cudaGetLastError();
}
'''


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the stamp point is not in the source once: {old!r}")
    return src.replace(old, new)


def _stamped(src: str, this_tree: bool) -> str:
    """The kernel source with clock64 stamps around a step's phases."""
    src = _sub(src, '#include "slstm.cuh"\n', '#include "slstm.cuh"\n' + STAMPS)
    src = _sub(src, "  extern __shared__ __align__(128) unsigned char smem[];\n",
               "  extern __shared__ __align__(128) unsigned char smem[];\n"
               "  __shared__ volatile float sinkbuf[256];\n")
    src = _sub(src, "    int64_t u = 0;  // exchange steps so far: u = S - 1 - t\n",
               "    int64_t u = 0;  // exchange steps so far: u = S - 1 - t\n"
               "    unsigned long long a_wait = 0, a_prod = 0, a_row = 0, a_chain = 0,"
               " a_send = 0, a_tile = 0, tt;\n    const unsigned long long t_begin = stamp();\n")
    src = _sub(src, "    if (owner) {\n      dc0[sidx] = gc;", WRITE + "    if (owner) {\n"
               "      dc0[sidx] = gc;")
    src += ('extern "C" int repro_stamp_set(void* p) {\n'
            "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")
    src = _sub(src, "          dh_rec = product(cur);\n        }\n",
               "          const unsigned long long s1 = stamp();\n          a_wait += s1 - s0;\n"
               "          dh_rec = product(cur);\n          SINK(dh_rec);\n"
               "          s0 = stamp();\n          a_prod += s0 - s1;\n        }\n")
    src = _sub(src, "        const int cur = (int)(u & 1);\n",
               "        const int cur = (int)(u & 1);\n        unsigned long long s0 = stamp();\n")
    chain_end = ("        SINK(q0); SINK(q1); SINK(q2); SINK(q3); SINK(gc); SINK(gn);\n"
                 "        const unsigned long long s4 = stamp();\n        a_chain += s4 - s3;\n")
    if this_tree:
        wait, release = ("      mbar_wait(ready + 8 * tb, (uint32_t)((k >> 1) & 1));\n",
                         "      if (lane == 0) mbar_arrive(freed + 8 * tb);")
        src = _sub(src, "        if (u > 0) {\n          // dpre_{t+1}",
                   "        SINK(rt[kDhs]); SINK(rt[kH]); SINK(rt[kRn]); SINK(rt[kZz]);"
                   " SINK(rt[kDlogf]);\n        { const unsigned long long s = stamp();"
                   " a_row += s - s0; s0 = s; }\n        if (u > 0) {\n          // dpre_{t+1}")
        src = _sub(src, "        if (part < NC)\n          st_async4",
                   "        const unsigned long long s3 = s0;\n" + chain_end +
                   "        if (part < NC)\n          st_async4")
        src = _sub(src, "        dp -= 4 * gate_stride;\n      }\n",
                   "        dp -= 4 * gate_stride;\n        a_send += stamp() - s4;\n      }\n")
    else:
        wait, release = ("      mbar_wait(landed + 8 * s, (uint32_t)((k / kStages) & 1));\n",
                         "      if (lane == 0) mbar_arrive(empty + 8 * s);")
        src = _sub(src, "        const float g_n = __fadd_rn(gn,",
                   "        SINK(h); SINK(gq);\n        const unsigned long long s3 = stamp();\n"
                   "        a_row += s3 - s0;\n        const float g_n = __fadd_rn(gn,")
        src = _sub(src, "        if ((part & 1) == 0)\n", chain_end + "        if ((part & 1) == 0)\n")
        src = _sub(src, "bar + 8 * (cur ^ 1));\n      }\n",
                   "bar + 8 * (cur ^ 1));\n        a_send += stamp() - s4;\n      }\n")
    src = _sub(src, wait, "      tt = stamp();\n" + wait + "      a_tile += stamp() - tt;\n")
    return _sub(src, "      __syncwarp();\n" + release,
                "      tt = stamp();\n      __syncwarp();\n" + release + "\n"
                "      a_tile += stamp() - tt;")


def _with_fdiv(src: str) -> str:
    """This tree's kernel with __fdiv_rn itself for gh / N."""
    return _sub(src, "  float q = __fmul_rn(a, y);\n", "  return __fdiv_rn(a, b);\n"
                "  float q = __fmul_rn(a, y);\n")


def _build(parent: Path, out: Path) -> dict[str, Path]:
    this_cu = build.CSRC / "slstm_bwd.cu"
    parent_csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {"parent": (parent_csrc / "slstm_bwd.cu", parent_csrc),
               "this": (this_cu, build.CSRC)}
    for name, text, inc in (
            ("fdiv", _with_fdiv(this_cu.read_text()), build.CSRC),
            ("stamp_parent", _stamped((parent_csrc / "slstm_bwd.cu").read_text(), False),
             parent_csrc),
            ("stamp_this", _stamped(this_cu.read_text(), True), build.CSRC),
            ("divtest", DIVTEST, build.CSRC)):
        (WORK / f"{name}.cu").write_text(text)
        sources[name] = (WORK / f"{name}.cu", inc)
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(inc), "-o",
         str(WORK / f"lib{name}.so"), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, (cu, inc) in sources.items()}
    tool = str(Path(build.nvcc()).parent / "cuobjdump")
    for name, proc in procs.items():
        report = proc.communicate()[0]
        (out / f"ptxas_{name}.txt").write_text(report)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{report[-4000:]}")
        (out / f"sass_{name}.txt").write_text(subprocess.run(
            [tool, "-sass", str(WORK / f"lib{name}.so")], capture_output=True, text=True,
            check=True).stdout)
    return {name: WORK / f"lib{name}.so" for name in sources}


def _libraries(paths: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    sig = (*(ctypes.c_void_p,) * 12, *(ctypes.c_longlong,) * 4, ctypes.c_void_p)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        if name != "divtest":
            for fn in ("repro_slstm_bwd_f32", "repro_slstm_bwd_bf16"):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = sig, ctypes.c_int
        if name.startswith("stamp"):
            lib.repro_stamp_set.argtypes = (ctypes.c_void_p,)
        libs[name] = lib
    return libs


def _bwd(libs, name, args):
    """``ops._launch_bwd`` through library ``name``."""
    def call():
        keep, build._LIB = build._LIB, libs[name]
        try:
            return ops._launch_bwd(*args)
        finally:
            build._LIB = keep
    return call


def _flat(out):
    return (out[0], *out[1])


def _split(lib, call, shape) -> dict:
    bsz, s, h, dh = shape
    w = ops.consumer_warps(dh)
    st = torch.zeros(bsz * h * ops.CLUSTER[dh] * w * 8, dtype=torch.int64, device="cuda")
    build.check(lib.repro_stamp_set(st.data_ptr()), "stamp set")
    call()
    call()
    torch.cuda.synchronize()
    build.check(lib.repro_stamp_set(None), "stamp set")
    a = st.view(-1, w, 8).cpu().numpy().astype(np.float64) / s
    return {p: {"mean": float(a[..., e].mean()), "least": float(a[..., e].min()),
                "most": float(a[..., e].max()),
                "by_warp": [round(float(a[:, j, e].mean()), 1) for j in range(w)]}
            for e, p in enumerate(PHASES)}


def _shape_rows(libs, shape, dtype, seed) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pre, r, b, st = cs._slstm_inputs(torch, dev, gen, shape, torch.bfloat16)
    dhs = torch.randn((shape[0], shape[1], *shape[2:]), generator=gen, device=dev)
    if dtype == torch.float32:
        pre, r, b = pre.float(), r.float(), b.float()
    hs, _, saved = ops._launch(pre, r, b, st, save=True)
    args = (r, saved, dhs, tuple(torch.zeros_like(st[0]) for _ in range(4)), dtype)
    walk = slstm_bwd_walk_ref(r, st[2], saved, hs, dhs, None, dtype)
    plain = (walk[0], *walk[3])
    names = ("parent", "this", "fdiv", "stamp_parent", "stamp_this")
    outs = {n: _flat(_bwd(libs, n, args)()) for n in names}
    row = {"bits_equal_to_this": {n: all(torch.equal(x, y) for x, y in zip(outs[n], outs["this"]))
                                  for n in names},
           "bits_stamped_as_built": [
               all(torch.equal(x, y) for x, y in zip(outs["stamp_parent"], outs["parent"])),
               all(torch.equal(x, y) for x, y in zip(outs["stamp_this"], outs["this"]))],
           "largest_error_over_scale_vs_plain": {
               n: [float((x.double() - y.double()).abs().max()
                         / y.double().abs().max().clamp(min=1e-30)) for x, y in zip(outs[n], plain)]
               for n in ("parent", "this")}}
    times = {n: [] for n in names}
    for n in ("parent", "this", "fdiv", "fdiv", "this", "parent", "stamp_parent", "stamp_this"):
        times[n].append(cs.kernel_device_ms(torch, _bwd(libs, n, args), (ops.BWD_KERNEL,),
                                            reps=10))
    row["device_ms"] = times
    row["us_per_step"] = {n: float(np.mean(v)) / shape[1] * 1e3 for n, v in times.items()}
    if shape == cs.SLSTM_BWD_SHAPE:
        row["clocks_a_step"] = {n: _split(libs[n], _bwd(libs, n, args), shape)
                                for n in ("stamp_parent", "stamp_this")}
    row["card"] = cs.card_state()
    return row


def _division(lib) -> dict:
    """div_rn against __fdiv_rn: 2^28 pairs inside its guard (random
    mantissas, an eighth of them all ones or zero) and 2^28 random bit
    patterns; mismatches where not both NaN."""
    dev = torch.device("cuda")
    lib.repro_divtest.argtypes = (*(ctypes.c_void_p,) * 4, ctypes.c_longlong)
    g = torch.Generator(device=dev).manual_seed(31)
    n = 1 << 25
    res = {"guard": [0, 0], "all_bits": [0, 0]}

    def count(a, b, key):
        fast, ieee = torch.empty_like(a), torch.empty_like(a)
        build.check(lib.repro_divtest(a.data_ptr(), b.data_ptr(), fast.data_ptr(),
                                      ieee.data_ptr(), n), "divtest")
        both_nan = fast.isnan() & ieee.isnan()
        res[key][0] += n
        res[key][1] += int(((fast.view(torch.int32) != ieee.view(torch.int32)) & ~both_nan).sum())

    def rand(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int64)

    for _ in range(8):
        ma, mb = rand(0, 1 << 23), rand(0, 1 << 23)
        mb[: n // 16], ma[n // 16: n // 8], mb[n // 8: n // 8 + n // 32] = (1 << 23) - 1, \
            (1 << 23) - 1, 0
        a = (rand(0, 2) << 31) | ((rand(-80, 80) + 127) << 23) | ma
        b = ((rand(-21, 40) + 127) << 23) | mb
        count(a.to(torch.int32).view(torch.float32), b.to(torch.int32).view(torch.float32),
              "guard")
        count(rand(-(1 << 31), 1 << 31).to(torch.int32).view(torch.float32),
              rand(-(1 << 31), 1 << 31).to(torch.int32).view(torch.float32), "all_bits")
    return {k: {"pairs": v[0], "differ": v[1]} for k, v in res.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", type=Path, required=True,
                   help="a directory holding an earlier tree's src/repro_torch/kernels/csrc")
    p.add_argument("--out", type=Path, required=True, help="where reports and SASS go")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    print(cs.card_line(), flush=True)
    libs = _libraries(_build(args.parent, args.out))
    build.library()
    result = {}
    for shape in (cs.SLSTM_BWD_SHAPE, cs.SLSTM_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{tuple(shape)} {str(dtype)[6:]}"
            result[key] = _shape_rows(libs, tuple(shape), dtype, 7 + shape[1])
            print(key, json.dumps(result[key]), flush=True)
    result["division"] = _division(libs["divtest"])
    print("division", json.dumps(result["division"]), flush=True)
    (args.out / "slstm_bwd_split.json").write_text(json.dumps(result, indent=1))
    print(f"done in {time.time() - t0:.1f} s; {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
