"""Build and load the hand-written CUDA kernels, and count their launches.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded through `ctypes`.  The build runs at
first use, all sources at once (one `nvcc` process each, in parallel),
into `build/kernels/` at the repository root.  A library's file name
carries a digest of its source, of every shared header (`csrc/*.cuh`)
and of the flags, so an edited source or header rebuilds.

Nothing here runs at import: a machine without `nvcc` (the CPU test
machine) imports the package and only fails if a CUDA launch is asked
for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# library (csrc/<name>.cu) -> {C entry point: argtypes}; every entry
# returns the CUDA error code of its launch as an int
ENTRIES: Dict[str, Dict[str, list]] = {
    "cmp_eval": {
        "hades_eval_gadget": [_P, _P, _P, _P, _L, _L, _P, _P, _L, _P, _I,
                              _I, _I, _I, _I, _I, _P],
        "hades_eval_paper": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _L,
                             _P, _L, _I, _I, _P],
    },
    "ntt": {
        "hades_negacyclic_mul": [_P, _L, _P, _L, _P, _L, _P, _P, _I, _I,
                                 _P],
        "hades_negacyclic_mul_ntt": [_P, _L, _P, _P, _L, _P, _P, _I, _I,
                                     _P],
        "hades_ntt_br": [_P, _P, _L, _P, _P, _I, _I, _I, _P],
    },
}
SOURCES = tuple(ENTRIES)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# kernel name -> launches since the last reset; each wrapper adds one
# exactly where it launches its kernel (the two ntt_br directions apart),
# under a lock: the serving loop's pump and client threads launch at once
_count_lock = threading.Lock()
LAUNCHES: Dict[str, int] = {"eval_coeff0_gadget": 0, "eval_coeff0_paper": 0,
                            "negacyclic_mul": 0, "negacyclic_mul_ntt": 0,
                            "ntt_br_fwd": 0, "ntt_br_inv": 0}


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from "
            f"{CSRC} on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhades_{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: seconds} for the ones built now; raises with the
    compiler's output if any build fails.  `nvcc -Xptxas -v` output
    (registers, shared memory, spills) lands in `build/kernels/<name>.log`."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f".{name}.{os.getpid()}.so"
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, log)
    out, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        out[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    for entry, argtypes in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    """The current PyTorch stream on `device`, as the C entries take it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
