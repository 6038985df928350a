#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one GPU.

    python3 tools/kernel_variants.py

A variant is a copy of `src/repro_torch/kernels/csrc` with lines
replaced (the gadget Eval's warps per m16 tile, `kSplit`; the NTT
kernels' minimum blocks per SM in `__launch_bounds__`), built with the
package's nvcc flags into `build/kernels/variants/<name>/`, loaded with
ctypes in place of the package's library, held byte-equal to the plain
version and timed by CUDA events at the paths' shapes (paper-bfv): the
served Eval tiles 8 x 16,384 and 10 x 8,192, one atom over 16,384 rows,
1,024 lanes with per-lane bounds; the key multiply and the two-varying
multiply over an encryption chunk [8192, 2, 4096], ntt_br forward at
[8192, 2, 4096] and inverse at [1024, 2, 4096].  Every variant runs in
two rounds, in turns, in one process on one card.  Prints one JSON line
per variant and round, then the card's name and power limit.  Needs a
CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

EVAL_SPLIT = "constexpr int kSplit = 4;"
MUL_BOUNDS = "__launch_bounds__(kMaxThreads, VAR ? 4 : 3)"
NTT_BOUNDS = "__launch_bounds__(kMaxThreads, FWD ? 2 : 4)"

# name -> (library, {line in the source: its replacement})
VARIANTS = {
    "eval_split1": ("cmp_eval", {EVAL_SPLIT: "constexpr int kSplit = 1;"}),
    "eval_split2": ("cmp_eval", {EVAL_SPLIT: "constexpr int kSplit = 2;"}),
    "eval_split4": ("cmp_eval", {}),
    **{f"ntt_blocks{b}": ("ntt", {
        MUL_BOUNDS: f"__launch_bounds__(kMaxThreads, {b})",
        NTT_BOUNDS: f"__launch_bounds__(kMaxThreads, {b})"})
       for b in (2, 3, 4)},
    "ntt_chosen": ("ntt", {}),
}


def build(out_dir: Path) -> dict:
    """Every variant's library, all nvcc processes at once."""
    from repro_torch.kernels import _build
    procs = {}
    for name, (lib, edits) in VARIANTS.items():
        src_dir = out_dir / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        src = src_dir / f"{lib}.cu"
        text = src.read_text()
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {lib}.cu")
            text = text.replace(old, new)
        src.write_text(text)
        so = src_dir / f"lib{lib}.so"
        log = open(src_dir / "nvcc.log", "w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), so, log)
    libs = {}
    for name, (proc, so, log) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}: "
                               f"{(so.parent / 'nvcc.log').read_text()}")
        log.close()
        lib = ctypes.CDLL(str(so))
        _build._declare(VARIANTS[name][0], lib)
        libs[name] = lib
    return libs


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call by CUDA events, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.core import sampling
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK

    t0 = time.perf_counter()
    libs = build(_build.BUILD_DIR / "variants")
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda", 0)
    params = make_params("paper-bfv")
    ks = keygen(params, 1, device=dev)
    ring = ks.ring
    gen = sampling.make_generator(3, dev)
    args = (ks.cek_rev, ring.q_arr[:, 0], params.scale,
            params.profile.gadget_log_base)
    col = sampling.uniform_poly(params, gen, (2, 16384))
    bnd = sampling.uniform_poly(params, gen, (2, 10))
    lane_bnd = sampling.uniform_poly(params, gen, (2, 1, 1024))
    u = sampling.ternary_poly(params, gen, (8192,))
    x = sampling.uniform_poly(params, gen, (1024,))
    br, pairs = ks.key_br("pk0")

    def ev(kernel, A, off, rows, b0, b1):
        fn = CK.eval_coeff0_gadget if kernel else CK.eval_coeff0_gadget_plain
        kw = {"cek_bytes": ks.cek_rev_bytes} if kernel else {}
        return fn(col[0][None], col[1][None], off, rows, [0] * A, b0, b1,
                  *args, **kw)
    tiles = {"eval_8x16384": (8, 0, 16384, bnd[0][:8], bnd[1][:8]),
             "eval_10x8192": (10, 0, 8192, bnd[0], bnd[1]),
             "eval_1x16384": (1, 0, 16384, bnd[0][:1], bnd[1][:1]),
             "eval_lanes1024": (1, 100, 1024, lane_bnd[0], lane_bnd[1])}
    want = {k: ev(False, *t) for k, t in tiles.items()}
    ntt_cases = {
        "mul_key_8192": (lambda: NK.negacyclic_mul_ntt(u, br, ring, pairs),
                         NK.negacyclic_mul_plain(u, ks.pk0, ring)),
        "mul_var_8192": (lambda: NK.negacyclic_mul(u, ks.pk0, ring),
                         NK.negacyclic_mul_plain(u, ks.pk0, ring)),
        "ntt_fwd_8192": (lambda: NK.ntt_br(u, ring), NK.ntt_br_plain(u, ring)),
        "ntt_inv_1024": (lambda: NK.ntt_br(x, ring, fwd=False),
                         NK.ntt_br_plain(x, ring, fwd=False)),
    }
    ok = True
    for rnd in range(2):
        for name, lib in libs.items():
            kind = VARIANTS[name][0]
            _build._libs[kind] = lib
            row = {"variant": name, "round": rnd}
            if kind == "cmp_eval":
                for k, t in tiles.items():
                    got = ev(True, *t)
                    torch.cuda.synchronize()
                    row[f"{k}_equal"] = bool(torch.equal(got, want[k]))
                    row[f"{k}_ms"] = time_cuda(lambda: ev(True, *t), 10)
            else:
                for k, (fn, ref) in ntt_cases.items():
                    got = fn()
                    torch.cuda.synchronize()
                    row[f"{k}_equal"] = bool(torch.equal(got, ref))
                    row[f"{k}_ms"] = time_cuda(fn, 10)
            ok &= all(v for k, v in row.items() if k.endswith("_equal"))
            print(json.dumps(row), flush=True)
    _build._libs.clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
