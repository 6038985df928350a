#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one GPU.

    python3 tools/kernel_variants.py [--baseline DIR] [--skip-builds]

A build variant is a copy of `src/repro_torch/kernels/csrc` with lines
replaced, built with the package's nvcc flags into
`build/kernels/variants/<name>/`, loaded with ctypes in place of the
package's library, held byte-equal to the plain version and timed by
CUDA events, in two rounds of turns: the gadget Eval's warps per m16
tile (`kSplit`) at the paths' shapes (paper-bfv: the served Eval tiles
8 x 16,384 and 10 x 8,192, one atom over 16,384 rows, 1,024 lanes with
per-lane bounds); the multiplies' minimum blocks per SM in
`__launch_bounds__` (`ntt_blocks*`), the wide ntt_br's
(`ntt_wide_blocks3`) and the narrow ntt_br's cluster size
(`ntt_cluster2`, `4`, `16`; the package builds 8), each timed over an
encryption chunk [8192, 2, 4096] (both multiplies, ntt_br both ways),
ntt_br's inverse at [1024, 2, 4096] and the narrow form at paper-ckks
[1, 2, 16384] and [8, 2, 16384] both ways.

`tools/ntt_c1.cu` is ntt_br as one block per (polynomial, tower), the
design before the narrow and wide forms (`start_c1`).  At the paths'
ntt_br shapes and on each side of every change of the package's plan
(paper-bfv and paper-ckks, both directions) `time_turns`, the harness
`chip_smoke.py` uses too, times in turns that kernel, the wide form
without and with a staged row and the narrow form (the package's C
entry with the form forced), and the wrapper with the card's plan:
device ms by CUDA-graph replay where a call moves less than 64 MiB
(there the host's launch is as long as the kernel), CUDA events above.

With `--baseline DIR` (the root of another checkout, such as
`git archive <commit> | tar -x -C build/parent`), that tree's
`csrc/ntt.cu` is built too and its multiplies and ntt_br are timed
beside this tree's at the same shapes, in turns: baseline, current,
current, baseline.  `--skip-builds` leaves out the build variants.
Prints one JSON line per variant (or shape) and round, then the card's
name and power limit.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

C1_SOURCE = ROOT / "tools" / "ntt_c1.cu"
EVAL_SPLIT = "constexpr int kSplit = 4;"
MUL_BOUNDS = "__launch_bounds__(kMaxThreads, VAR ? 4 : 3)"
WIDE_BOUNDS = "__launch_bounds__(kMaxThreads, 2) ntt_br_wide("
CLUSTER = "constexpr int kCluster = 8;"
CLUSTER_PREPARE = ("cudaError_t e = prepare_kernel(ntt_br_cluster<FWD, "
                   "kCluster>, done);")
# clusters above 8 blocks are a non-portable size, allowed per kernel
NON_PORTABLE = (" if (e == cudaSuccess) e = cudaFuncSetAttribute("
                "ntt_br_cluster<FWD, kCluster>, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);")
GRAPH_BYTES = 64 << 20      # calls moving less are timed by graph replay

# name -> (library, {line in the source: its replacement})
VARIANTS = {
    "eval_split1": ("cmp_eval", {EVAL_SPLIT: "constexpr int kSplit = 1;"}),
    "eval_split2": ("cmp_eval", {EVAL_SPLIT: "constexpr int kSplit = 2;"}),
    "eval_split4": ("cmp_eval", {}),
    **{f"ntt_blocks{b}": ("ntt", {
        MUL_BOUNDS: f"__launch_bounds__(kMaxThreads, {b})"})
       for b in (2, 3, 4)},
    "ntt_wide_blocks3": ("ntt", {
        WIDE_BOUNDS: "__launch_bounds__(kMaxThreads, 3) ntt_br_wide("}),
    **{f"ntt_cluster{c}": ("ntt", {
        CLUSTER: f"constexpr int kCluster = {c};",
        **({CLUSTER_PREPARE: CLUSTER_PREPARE + NON_PORTABLE}
           if c > 8 else {})})
       for c in (2, 4, 16)},
    "ntt_chosen": ("ntt", {}),
}


def variant_cluster(name: str) -> int:
    """The narrow form's cluster size an ntt variant was built with."""
    from repro_torch.kernels import ntt as NK
    return int(name[len("ntt_cluster"):]) if name.startswith(
        "ntt_cluster") else NK.CLUSTER


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


def start_c1(out_dir: Path):
    """Start nvcc on `tools/ntt_c1.cu` against the package's sources;
    returns a function that waits for it and returns the loaded library
    (`hades_ntt_br_c1` and the package's ntt entries declared)."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    so, log_path = out_dir / "libntt_c1.so", out_dir / "nvcc.log"
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
         str(so), str(C1_SOURCE)], stdout=log, stderr=subprocess.STDOUT)

    def finish() -> ctypes.CDLL:
        rc = proc.wait(timeout=900)
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {C1_SOURCE.name}: "
                               f"{log_path.read_text()}")
        lib = ctypes.CDLL(str(so))
        _build._declare("ntt", lib)
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hades_ntt_br_c1.argtypes = [P, P, L, P, P, I, I, I, P]
        lib.hades_ntt_br_c1.restype = ctypes.c_int
        return lib
    return finish


def ntt_call(entry, x, ring, fwd: bool, *form):
    """A callable that runs a C entry with ntt_br's arguments (`form`,
    the package's (cluster, depth), between the direction and the
    stream) on x, [..., K, n] on a card, into a new tensor of x's shape."""
    import torch
    from repro_torch.kernels import _build
    K, n = ring.num_towers, ring.n
    x = x.contiguous()
    rows, index = x.numel() // (K * n), x.device.index

    def call():
        out = torch.empty_like(x)
        with _build.on_device(index):
            rc = entry(x.data_ptr(), out.data_ptr(), rows,
                       ring.shoup.data_ptr(), ring.q_arr.data_ptr(), K, n,
                       int(fwd), *form, _build.stream_handle(x.device))
        _build.check(rc, entry.__name__)
        return out
    return call


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


def time_turns(calls: dict, nbytes: int, split: str = None) -> dict:
    """Every callable of `calls` timed in turns, in order and then in
    reverse (a, b, b, a): where a call moves less than GRAPH_BYTES the
    device ms by CUDA-graph replay, and for `split` the first turn's
    `kernels.timing.split` (device, host and events ms), else CUDA
    events.  Returns each one's mean as `<name>_ms`, and the timer."""
    from repro_torch.kernels import timing
    short = nbytes < GRAPH_BYTES
    out, times = {"timer": "graph" if short else "events"}, {}
    for name in [*calls, *reversed(list(calls))]:
        fn = calls[name]
        if short and name == split and "device_ms" not in out:
            out.update(timing.split(fn))
            ms = out["device_ms"]
        elif short:
            ms = timing.device_ms(fn)
        else:
            ms = time_cuda(fn, 10)
        times.setdefault(name, []).append(ms)
    return {**out, **{f"{k}_ms": sum(v) / len(v) for k, v in times.items()}}


def build_baseline(root: Path, out_dir: Path) -> ctypes.CDLL:
    """The checkout at `root`'s ntt library, built with this tree's nvcc
    flags, its multiplies and its ntt_br (the form before plans) declared."""
    from repro_torch.kernels import _build
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "ntt.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libntt.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=900)
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, args in {
            "hades_negacyclic_mul": [P, L, P, L, P, L, P, P, I, I, P],
            "hades_negacyclic_mul_ntt": [P, L, P, P, L, P, P, I, I, P],
            "hades_ntt_br": [P, P, L, P, P, I, I, I, P]}.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def baseline_calls(lib, ring, u, pk0, pairs, x) -> dict:
    """The baseline library's launches at ntt_cases' shapes, through
    ctypes as the wrappers launch them."""
    import torch
    from repro_torch.kernels import _build
    K, n = ring.num_towers, ring.n
    tabs, qs = ring.shoup.data_ptr(), ring.q_arr.data_ptr()
    stream = _build.stream_handle(u.device)

    def run(entry, rows, args):
        out = torch.empty((rows, K, n), dtype=torch.int64, device=u.device)
        _build.check(entry(*args(out)), entry.__name__)
        return out
    return {
        "mul_key_8192": lambda: run(
            lib.hades_negacyclic_mul_ntt, len(u), lambda o: (
                u.data_ptr(), K * n, pairs.data_ptr(), o.data_ptr(), len(u),
                tabs, qs, K, n, stream)),
        "mul_var_8192": lambda: run(
            lib.hades_negacyclic_mul, len(u), lambda o: (
                u.data_ptr(), K * n, pk0.data_ptr(), 0, o.data_ptr(), len(u),
                tabs, qs, K, n, stream)),
        "ntt_fwd_8192": ntt_call(lib.hades_ntt_br, u, ring, True),
        "ntt_inv_1024": ntt_call(lib.hades_ntt_br, x, ring, False),
    }


def time_ntt_forms(emit, c1, profile: str, extra_rows: tuple,
                   seed: int) -> bool:
    """ntt_br at `extra_rows` and on each side of every change of the
    card's plan at `profile`, both directions, in every form (`c1`'s C =
    1 kernel, the wide form at each depth that fits, the narrow form,
    the wrapper's plan), each call held against the plain version and
    timed in turns."""
    import torch
    from repro_torch.core import ring as R
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import ntt as NK
    dev = torch.device("cuda", 0)
    params = make_params(profile)
    ring = R.make_ring(params, dev)
    K, n = params.num_towers, params.n
    sms, smem = NK.card_shape(0)
    rows_set = sorted(set(extra_rows)
                      | set(NK.plan_boundaries(K, n, sms, smem)))
    forms = {f"wide_d{d}": NK.Plan(0, d) for d in (0, 1)
             if NK.wide_smem(n, d) <= smem}
    forms["narrow"] = NK.Plan(NK.CLUSTER, 0)
    entry = _build.load("ntt").hades_ntt_br
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool = torch.randint(0, 1 << 62, (max(rows_set), K, n), generator=gen,
                         device=dev) % ring.q_arr
    ok = True
    for rows in rows_set:
        x = pool[:rows]
        for fwd in (True, False):
            want = NK.ntt_br_plain(x, ring, fwd=fwd)
            calls = {"c1": ntt_call(c1.hades_ntt_br_c1, x, ring, fwd),
                     **{k: ntt_call(entry, x, ring, fwd, *f)
                        for k, f in forms.items()},
                     "planned": lambda: NK.ntt_br(x, ring, fwd=fwd)}
            equal = {k: bool(torch.equal(fn(), want))
                     for k, fn in calls.items()}
            ok &= all(equal.values())
            rec = {"profile": profile, "shape": [rows, K, n], "fwd": fwd,
                   "plan": list(NK.plan(rows, K, n, sms, smem, fwd)),
                   "equal": equal, **time_turns(calls, 16 * rows * K * n)}
            rec["best"] = min(calls, key=lambda k: rec[f"{k}_ms"])
            emit(rec)
            del want
    return ok


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of another checkout whose ntt library is "
                         "timed beside this one")
    ap.add_argument("--skip-builds", action="store_true",
                    help="time only the ntt_br forms (and the baseline)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.core import ring as R
    from repro_torch.core import sampling
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK
    from repro_torch.kernels import timing

    def emit(obj):
        print(json.dumps(obj), flush=True)

    t0 = time.perf_counter()
    c1_done = start_c1(_build.BUILD_DIR / "variants" / "ntt_c1")
    libs = {} if args.skip_builds else build(_build.BUILD_DIR / "variants")
    _build.build_all()
    c1 = c1_done()
    base = (build_baseline(args.baseline.resolve(),
                           _build.BUILD_DIR / "variants" / "baseline")
            if args.baseline is not None else None)
    emit({"build_s": time.perf_counter() - t0})
    dev = torch.device("cuda", 0)
    params = make_params("paper-bfv")
    ks = keygen(params, 1, device=dev)
    ring = ks.ring
    gen = sampling.make_generator(3, dev)
    args_ = (ks.cek_rev, ring.q_arr[:, 0], params.scale,
             params.profile.gadget_log_base)
    col = sampling.uniform_poly(params, gen, (2, 16384))
    bnd = sampling.uniform_poly(params, gen, (2, 10))
    lane_bnd = sampling.uniform_poly(params, gen, (2, 1, 1024))
    u = sampling.ternary_poly(params, gen, (8192,))
    x = sampling.uniform_poly(params, gen, (1024,))
    br, pairs = ks.key_br("pk0")
    ckks = make_params("paper-ckks")
    cring = R.make_ring(ckks, dev)
    cx = sampling.uniform_poly(ckks, gen, (8,))

    def ev(kernel, A, off, rows, b0, b1):
        fn = CK.eval_coeff0_gadget if kernel else CK.eval_coeff0_gadget_plain
        kw = {"cek_bytes": ks.cek_rev_bytes} if kernel else {}
        return fn(col[0][None], col[1][None], off, rows, [0] * A, b0, b1,
                  *args_, **kw)
    tiles = {"eval_8x16384": (8, 0, 16384, bnd[0][:8], bnd[1][:8]),
             "eval_10x8192": (10, 0, 8192, bnd[0], bnd[1]),
             "eval_1x16384": (1, 0, 16384, bnd[0][:1], bnd[1][:1]),
             "eval_lanes1024": (1, 100, 1024, lane_bnd[0], lane_bnd[1])}
    want = {k: ev(False, *t) for k, t in tiles.items()} if libs else {}
    ntt_cases = {
        "mul_key_8192": (lambda: NK.negacyclic_mul_ntt(u, br, ring, pairs),
                         NK.negacyclic_mul_plain(u, ks.pk0, ring)),
        "mul_var_8192": (lambda: NK.negacyclic_mul(u, ks.pk0, ring),
                         NK.negacyclic_mul_plain(u, ks.pk0, ring)),
        "ntt_fwd_8192": (lambda: NK.ntt_br(u, ring), NK.ntt_br_plain(u, ring)),
        "ntt_inv_8192": (lambda: NK.ntt_br(u, ring, fwd=False),
                         NK.ntt_br_plain(u, ring, fwd=False)),
        "ntt_inv_1024": (lambda: NK.ntt_br(x, ring, fwd=False),
                         NK.ntt_br_plain(x, ring, fwd=False)),
    }
    # the narrow form at paper-ckks key setup, launched with the cluster
    # size of the library it runs in (the plan's is the package's)
    narrow = {f"narrow_{r}_{'fwd' if f else 'inv'}": (r, f, NK.ntt_br_plain(
        cx[:r], cring, fwd=f)) for r in (1, 8) for f in (True, False)}
    ok = True

    def ntt_row(name, calls):
        row = {"variant": name, "round": rnd}
        for k, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            ref = (ntt_cases[k][1] if k in ntt_cases else narrow[k][2])
            row[f"{k}_equal"] = bool(torch.equal(got, ref))
            row[f"{k}_ms"] = time_cuda(fn, 10)
        return row

    def narrow_calls(lib, cluster):
        return {k: ntt_call(lib.hades_ntt_br, cx[:r], cring, f, cluster, 0)
                for k, (r, f, _) in narrow.items()}
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
                row = ntt_row(name, {
                    **{k: f for k, (f, _) in ntt_cases.items()},
                    **narrow_calls(lib, variant_cluster(name))})
            ok &= all(v for k, v in row.items() if k.endswith("_equal"))
            emit(row)
    _build._libs.clear()
    if base is not None:
        calls = baseline_calls(base, ring, u, ks.pk0, pairs, x)
        current = {k: f for k, (f, _) in ntt_cases.items()}
        for rnd, name in enumerate(("baseline", "current", "current",
                                    "baseline")):
            row = ntt_row(name, calls if name == "baseline" else current)
            ok &= all(v for k, v in row.items() if k.endswith("_equal"))
            emit(row)
    del u, x, ntt_cases, narrow
    torch.cuda.empty_cache()
    # the paths' ntt_br shapes: key_br and gadget_keymul at paper-bfv,
    # keygen's eval-domain CEK and key_br at paper-ckks
    ok &= time_ntt_forms(emit, c1, "paper-bfv", (1, 33, 1024, 8192), 5)
    ok &= time_ntt_forms(emit, c1, "paper-ckks", (1, 4, 8), 6)
    emit({"floor": timing.launch_floor(dev)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
