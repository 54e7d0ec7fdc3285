"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an
object file, all sources at once in parallel processes, and the objects
link into one shared library with a plain C interface.  The library lands
in ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
checkout reuses its build.  Nothing is compiled at import time: the CPU
tests import every module on machines with no CUDA toolkit.  The library
links the CUDA runtime alone: ``swa_attention_tc.cu`` takes the CUDA
driver's ``cuTensorMapEncodeTiled`` at run time through
``cudaGetDriverEntryPoint(ByVersion)``, so there is no ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES: tuple[str, ...] = ("trigger_sq.cu", "mix.cu", "mix_sparse.cu",
                             "swa_attention.cu", "swa_attention_tc.cu",
                             "swa_attention_tf32.cu", "selective_scan.cu",
                             "selective_scan_bwd.cu", "slstm.cu")
HEADERS: tuple[str, ...] = ("bf16.cuh", "scan.cuh")  # included by the sources
NVCC_FLAGS: tuple[str, ...] = ("-gencode", "arch=compute_90a,code=sm_90a",
                               "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
# C entry points: name -> argtypes; each returns a CUDA error code as int
_SIGNATURES = {
    "repro_trigger_sq_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "repro_trigger_sq_bf16": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "repro_mix_f32": (_P, _P, _P, _I64, _I64, _I64, _P),
    "repro_mix_bf16": (_P, _P, _P, _I64, _I64, _P),
    "repro_mix_sparse_bf16": (*(_P,) * 5, *(_I64,) * 4, _P),
    "repro_mix_sparse_f32": (*(_P,) * 11, *(_I64,) * 8, _P),
    "repro_mix_sparse_wide_f32": (*(_P,) * 12, *(_I64,) * 10, _P),
    "repro_mix_sparse_direct_f32": (*(_P,) * 7, *(_I64,) * 6, _P),
    "repro_swa_attention_f32": (_P, _P, _P, _P, *(_I64,) * 6, _P),
    "repro_swa_attention_bf16": (_P, _P, _P, _P, *(_I64,) * 6, _P),
    "repro_swa_attention_tc_bf16": (_P, _P, _P, _P, *(_I64,) * 6, _P),
    "repro_swa_attention_tf32_f32": (_P, _P, _P, _P, *(_I64,) * 6, _P),
    "repro_selective_scan_f32": (*(_P,) * 7, *(_I64,) * 7, _P),
    "repro_selective_scan_bf16": (*(_P,) * 7, *(_I64,) * 7, _P),
    "repro_selective_scan_bwd_f32": (*(_P,) * 14, *(_I64,) * 8, _P),
    "repro_selective_scan_bwd_bf16": (*(_P,) * 14, *(_I64,) * 8, _P),
    "repro_selective_scan_bwd_layout": (_I64, _I64, _I64, _P),
    "repro_selective_scan_bwd_occupancy": (_I64, _I64, _P),
    "repro_slstm_f32": (*(_P,) * 12, *(_I64,) * 4, _P),
    "repro_slstm_bf16": (*(_P,) * 12, *(_I64,) * 4, _P),
    "repro_slstm_layout": (_I64, _P),
}

_LIB: ctypes.CDLL | None = None


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles (if needed) and returns the path of the kernel library."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    link = subprocess.run([exe, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, kernel: str) -> None:
    """Raises if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: "
                           f"cudaError {err}")
