#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's served path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. build   — compile every kernel from src/repro_torch/kernels/csrc.
  2. serve   — the main path, after a warm-up on 4,096 rows: keygen
               (paper-bfv, gadget mode), the full hg38 column (34,423
               rows, padded to 65,536) encrypted on the card, a
               QueryServer(batch=4) answering 8 requests.
               Launch counts are zeroed just before and read just after;
               every answer must equal the plaintext truth exactly.
  3. kernels — each kernel against its plain PyTorch version on the card,
               byte-equal (torch.equal; residues are integers, so the
               tolerance is 0), on the served column at every tile shape
               the served batches gave the Eval kernel, plus edge shapes;
               kernel and plain times by CUDA events; bounds from the
               bytes and the card's integer multiply-add rate.
  4. profile — the same requests traced and under torch.profiler:
               engine counters, span totals, device busy share, device
               time by kernel name.
  5. index   — SortedIndex.build over 4,096 rows (encrypted_sort through
               the Eval kernel), point lookups and ranges vs the truth.
  6. card    — the card's name and power limit (nvidia-smi), then one
               {"kernels": [...]} line with every kernel's numbers.

The last line is the device record.  Any failure raises: the script then
exits non-zero without it, as it does with no CUDA device or without
the repository beside it.  It imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PROFILE = "paper-bfv"
BATCH = 4
INDEX_ROWS = 4096
SEED = 0

# H100 SXM published memory rate (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on Hopper (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper: 16 in each of the SM's 4 partitions, against 32 FP32
# lanes).  The kernels' 32 x 32 -> 64-bit integer multiply-adds issue
# at most one per such lane and clock, so SMs x 64 x the maximum SM
# clock is the most the card can do of them.
INT32_LANES_PER_SM = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def max_abs_err(a, b) -> int:
    return int((a - b).abs().max().item()) if a.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def int_mac_rate() -> dict:
    """The card's integer multiply-add rate: SM count (torch) x
    INT32_LANES_PER_SM x maximum SM clock (nvidia-smi)."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "max_sm_mhz": mhz,
            "int_macs_per_s": sms * INT32_LANES_PER_SM * mhz * 1e6}


def _bound(nbytes: int, macs: int, rate: dict) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = macs / rate["int_macs_per_s"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bytes": nbytes, "int_macs": macs}


def eval_bound(A: int, T: int, K: int, n: int, D: int, per_lane: bool,
               rate: dict) -> dict:
    """Gadget Eval over A atoms x T rows: read the tile's c1 and c0
    coefficient 0, the bounds (one per atom, or per lane) and cek_rev
    once, write [A, T, K]; A*T*K*(K*D*n) integer multiply-adds."""
    nb = A * T if per_lane else A
    nbytes = 8 * (T * K * n + T * K + nb * (K * n + K) + K * D * K * n
                  + A * T * K)
    return _bound(nbytes, A * T * K * K * D * n, rate)


def mul_bound(B: int, K: int, n: int, b_rows: int, rate: dict) -> dict:
    """Fused multiply over B rows: read a, b (b_rows rows) and the twiddle
    tables once, write B rows; one multiply-add per modular multiply, per
    (row, tower) 4n for twists and pointwise + 1.5 n log2 n butterflies."""
    S = n.bit_length() - 1
    nbytes = 8 * (2 * B * K * n + b_rows * K * n + 2 * K * n
                  + 2 * K * S * (n // 2))
    return _bound(nbytes, B * K * (4 * n + 3 * (n // 2) * S), rate)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": list(_build.SOURCES), "per_source_s": per_source}
    for name in _build.SOURCES:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            out[f"ptxas_{name}"] = [ln.split("ptxas info    : ")[-1]
                                    for ln in log.read_text().splitlines()
                                    if "Used" in ln]
    emit(out)
    return out


def phase_kernels(ks, table, serve, rate) -> dict:
    """Each kernel vs its plain version, after the main path, on its
    inputs and at every shape it gave the kernels.

    Eval, over the served column itself: for every atom count A of a
    served batch, its first and last row tile (T = lane_tile(W, A)
    rows, so the column's first and last slots) against A random
    bounds; a 1,024-lane tile with per-lane bounds (the sort and probe
    layout); and, over 256 rows of a random two-column stack, atom
    counts that reach every atom-chunk width of the kernel, a partial
    last chunk, and the wrapper's split by column.  Multiply: [64, 2,
    4096] (full and stride-0 second operand) and an encryption chunk
    [8192, 2, 4096] x pk0."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.core.encrypt import ENC_CHUNK_ROWS
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as KO

    params, ring = ks.params, ks.ring
    K, n = params.num_towers, params.n
    _build.reset_launch_counts()
    D = params.gadget_digits_per_tower
    lb = params.profile.gadget_log_base
    gen = sampling.make_generator(SEED + 7, ks.device)
    W = table.scan_width
    qs = ring.q_arr[:, 0]
    col = table.scan_column("value")
    served = [(A, KO.lane_tile(W, A)) for A in
              dict.fromkeys(b["scan_compares"] // W for b in serve["batches"])]
    require(all(b["scan_compares"] % W == 0 for b in serve["batches"]),
            "a served batch's compares are not whole scans")

    def ev(kernel, uniq, off, rows, sel, b0, b1):
        fn = CK.eval_coeff0_gadget if kernel else CK.eval_coeff0_gadget_plain
        return fn(uniq[0], uniq[1], off, rows, sel, b0, b1, ks.cek_rev, qs,
                  params.scale, lb)

    def bounds(*shape):
        return (sampling.uniform_poly(params, gen, shape),
                sampling.uniform_poly(params, gen, shape))

    table_stack = (col.c0[None], col.c1[None])
    pair = sampling.uniform_poly(params, gen, (2, 2, 256))
    pair_stack = (pair[0], pair[1])
    cases, tiles = [], []
    for A, T in served:
        b = bounds(A)
        tiles.append((A, T, b))
        for off in (0, W - T):
            cases.append((table_stack, off, T, [0] * A, *b))
    lanes = 1024
    per_lane = (table_stack, W - lanes, lanes, [0], *bounds(1, lanes))
    cases.append(per_lane)
    for A in (1, 2, 3, 4, 5, 8, 9, 17):
        cases.append((pair_stack, 0, 256, [0] * A, *bounds(A)))
    for A in (3, 10):
        cases.append((pair_stack, 0, 256, [a % 2 for a in range(A)],
                      *bounds(A)))
    errs, eq = [], True
    for case in cases:
        got, want = ev(True, *case), ev(False, *case)
        torch.cuda.synchronize()
        eq &= torch.equal(got, want)
        errs.append(max_abs_err(got, want))
    require(eq, f"Eval kernel != plain (max |err| {errs})")
    timed = []
    for A, T, (b0, b1) in tiles:
        args = (table_stack, 0, T, [0] * A, b0, b1)
        timed.append({"atoms": A, "rows": T,
                      "ms": time_cuda(lambda: ev(True, *args), 5),
                      "plain_ms": time_cuda(lambda: ev(False, *args), 1),
                      **eval_bound(A, T, K, n, D, False, rate)})
    pl_ms = time_cuda(lambda: ev(True, *per_lane), 20)
    del cases, tiles, pair, pair_stack, per_lane

    a64 = sampling.uniform_poly(params, gen, (64,))
    b64 = sampling.uniform_poly(params, gen, (64,))
    mul_eq, mul_errs = True, []
    for b in (b64, ks.pk0):
        got = NK.negacyclic_mul(a64, b, ring)
        want = NK.negacyclic_mul_plain(a64, b, ring)
        torch.cuda.synchronize()
        mul_eq &= torch.equal(got, want)
        mul_errs.append(max_abs_err(got, want))
    u = sampling.ternary_poly(params, gen, (ENC_CHUNK_ROWS,))
    got = NK.negacyclic_mul(ks.pk0, u, ring)
    want = NK.negacyclic_mul_plain(ks.pk0, u, ring)
    mul_eq &= torch.equal(got, want)
    mul_errs.append(max_abs_err(got, want))
    mul_ms = time_cuda(lambda: NK.negacyclic_mul(ks.pk0, u, ring), 5)
    mul_plain_ms = time_cuda(
        lambda: NK.negacyclic_mul_plain(ks.pk0, u, ring), 1)
    mul64_ms = time_cuda(lambda: NK.negacyclic_mul(a64, b64, ring), 20)
    del got, want, u
    require(mul_eq, f"multiply kernel != plain (max |err| {mul_errs})")
    torch.cuda.empty_cache()

    out = {
        "phase": "kernels", "tolerance": 0, "rate": rate,
        "launches": dict(_build.LAUNCHES),
        "eval": {"equal": eq, "max_abs_err": max(errs),
                 "cases": len(errs), "served_tiles": timed,
                 "per_lane_1024_ms": pl_ms},
        "mul": {"equal": mul_eq, "max_abs_err": max(mul_errs),
                "shape": [ENC_CHUNK_ROWS, K, n], "ms": mul_ms,
                "plain_ms": mul_plain_ms, "ms_64x64": mul64_ms,
                **mul_bound(ENC_CHUNK_ROWS, K, n, 1, rate)},
    }
    emit(out)
    return out


def _requests(ks, vals, rng):
    """8 requests: 6 Range, 2 Eq; one Range and one Eq inside an Or/And."""
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P

    seeds = iter(range(1000, 2000))

    def enc(v):
        return E.encrypt(ks, int(v), next(seeds))

    def rng_pair(width):
        lo = int(rng.integers(0, 65537 - width))
        return lo, lo + width

    dup = np.unique(vals, return_counts=True)
    dups = dup[0][dup[1] > 1]
    reqs = []
    for width in (50, 500, 5000, 20000, 65536):
        lo, hi = rng_pair(min(width, 65536))
        reqs.append((P.Range("value", enc(lo), enc(hi)),
                     lambda x, lo=lo, hi=hi: (x >= lo) & (x <= hi)))
    (a, b), v = rng_pair(300), int(dups[0])
    reqs.append((P.Or(P.Range("value", enc(a), enc(b)),
                      P.Eq("value", enc(v))),
                 lambda x, a=a, b=b, v=v: ((x >= a) & (x <= b)) | (x == v)))
    v = int(dups[len(dups) // 2])
    reqs.append((P.Eq("value", enc(v)), lambda x, v=v: x == v))
    lo, hi = rng_pair(30000)
    reqs.append((P.And(P.Not(P.Range("value", enc(lo), enc(hi))),
                       P.Range("value", enc(0), enc(40000))),
                 lambda x, lo=lo, hi=hi: ~((x >= lo) & (x <= hi))
                 & (x <= 40000)))
    return reqs


def phase_serve(dev) -> tuple:
    """The main path, with every launch count zeroed just before it."""
    import torch
    from repro_torch import obs
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.data import load_dataset
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    params = make_params(PROFILE, mode="gadget")
    vals = load_dataset("hg38", scheme="bfv", t=params.t)
    # warm-up over the first INDEX_ROWS rows with other keys: loads
    # every kernel and PyTorch op of the path, so the times below are
    # not those of a cold process
    wks = keygen(params, SEED + 5, device=dev)
    warm = QueryServer(wks, Table.from_arrays(
        wks, "warm", {"value": vals[:INDEX_ROWS]}, SEED + 6), batch=BATCH)
    for q, _ in _requests(wks, vals, np.random.default_rng(SEED + 5)):
        warm.submit(q)
    warm.run()
    del wks, warm
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()

    t0 = time.perf_counter()
    ks = keygen(params, SEED, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = Table.from_arrays(ks, "hg38", {"value": vals}, SEED + 1)
    torch.cuda.synchronize()
    encrypt_s = time.perf_counter() - t0
    reqs = _requests(ks, vals, rng)
    server = QueryServer(ks, table, batch=BATCH)
    qids = [server.submit(q) for q, _ in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    correct = 0
    for qid, (_, truth) in zip(qids, reqs):
        want = np.nonzero(truth(vals))[0]
        correct += int(np.array_equal(results[qid].row_ids, want))
    sample = np.unique(np.concatenate([[0, len(vals) - 1],
                                       rng.integers(0, len(vals), 254)]))
    from repro_torch.core import encrypt as E
    dec = E.decrypt(ks, table.gather("value", sample)).cpu().numpy()
    dec_ok = bool(np.array_equal(dec, vals[sample]))
    out = {
        "phase": "serve", "profile": PROFILE, "mode": "gadget",
        "rows": int(len(vals)), "n_padded": table.n_padded,
        "table_bytes": table.ciphertext_bytes(),
        "requests": len(reqs), "batch": BATCH,
        "correct": f"{correct}/{len(reqs)}",
        "decrypt_sample_ok": dec_ok, "decrypt_sample_rows": len(sample),
        "keygen_s": keygen_s, "encrypt_s": encrypt_s,
        "serve_wall_s": wall, "queries_per_s": len(reqs) / wall,
        "batches": [{"queries": b.queries, "scan_compares": b.scan_compares,
                     "wall_s": b.wall_s} for b in server.batch_log],
        "eval_lanes": sum(b.scan_compares for b in server.batch_log),
        "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(out)
    require(correct == len(reqs), f"serve answered {out['correct']}")
    require(dec_ok, "decrypted sample != data")
    require(all(v > 0 for v in launches.values()),
            f"a kernel never launched on the main path: {launches}")
    return ks, table, vals, reqs, out


def phase_profile(ks, table, reqs, serve) -> dict:
    """The same 8 requests again, traced (`obs.tracing`) and under
    `torch.profiler`: the engine's counters, span totals, device busy
    time and share, and device time by kernel name.  Not the main
    path's measurement (tracing synchronizes per tile); where the
    profiler records no device activity the device numbers are null."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.db.query_serve import QueryServer

    server = QueryServer(ks, table, batch=BATCH)
    for q, _ in reqs:
        server.submit(q)
    torch.cuda.synchronize()
    with obs.tracing() as tracer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lanes = obs.REGISTRY.value("eval.lanes")
        tiles = obs.REGISTRY.value("eval.tiles")
    spans: dict = {}
    for ev in tracer.chrome_trace()["traceEvents"]:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, None                  # union of device intervals
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if end is None or lo >= end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"phase": "profile", "traced_wall_s": wall,
           "eval_lanes": lanes, "eval_tiles": tiles,
           "span_ms": spans,
           "device_events": len(dev),
           "device_busy_s": busy_us / 1e6 if dev else None,
           "device_busy_share": busy_us / 1e6 / wall if dev else None,
           "device_ms_by_name": {name[:80]: {"count": c, "ms": us / 1e3}
                                 for name, (c, us) in top}}
    emit(out)
    require(lanes == serve["eval_lanes"],
            f"traced eval.lanes {lanes} != served {serve['eval_lanes']}")
    return out


def phase_index(ks, table, vals) -> dict:
    """SortedIndex over the first INDEX_ROWS rows, reusing their
    ciphertexts, then point lookups and ranges vs the plaintext truth."""
    import torch
    from repro_torch.core import encrypt as E
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    rows = np.arange(INDEX_ROWS)
    sub = Table.from_ciphertexts("hg38_head", {"value": table.gather(
        "value", rows)}, INDEX_ROWS)
    v = vals[:INDEX_ROWS]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = SortedIndex.build(ks, sub, "value")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(_build.LAUNCHES)
    ok = bool(np.array_equal(v[idx.perm], np.sort(v)))
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    for x in list(rng.choice(v, 3)) + [70000]:
        got = np.sort(idx.point_lookup(ks, E.encrypt(ks, int(x), int(x))))
        ok &= bool(np.array_equal(got, np.nonzero(v == x)[0]))
    for lo, hi in ((1000, 9000), (30000, 30500)):
        got = np.sort(idx.search_range(ks, E.encrypt(ks, lo, lo),
                                       E.encrypt(ks, hi, hi)))
        ok &= bool(np.array_equal(got, np.nonzero((v >= lo) & (v <= hi))[0]))
    torch.cuda.synchronize()
    out = {"phase": "index", "rows": INDEX_ROWS, "correct": ok,
           "build_s": build_s, "build_compares": idx.build_compares,
           "build_launches": build_launches,
           "lookups_s": time.perf_counter() - t0,
           "search_compares": idx.search_compares}
    emit(out)
    require(ok, "index answers differ from the plaintext truth")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(json.dumps({"phase": "start", "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    phase_build()
    rate = int_mac_rate()
    ks, table, vals, reqs, serve = phase_serve(dev)
    kern = phase_kernels(ks, table, serve, rate)
    phase_profile(ks, table, reqs, serve)
    phase_index(ks, table, vals)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          **{k: serve[k] for k in ("correct", "keygen_s", "encrypt_s",
                                   "serve_wall_s", "queries_per_s",
                                   "peak_mem_bytes")}})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = "src/repro_torch/kernels/csrc"
    ev, mul = kern["eval"], kern["mul"]
    tile = ev["served_tiles"][0]          # the first batch's tile shape
    emit({"kernels": [
        {"name": "eval_coeff0_gadget", "route": "cuda",
         "source": f"{src}/cmp_eval.cu",
         "replaces": "src/repro/kernels/cmp_eval.py:48",
         "launches": serve["launches"]["eval_coeff0_gadget"],
         "max_abs_err": ev["max_abs_err"], "ms": tile["ms"],
         "plain_ms": tile["plain_ms"], "bound_ms": tile["bound_ms"],
         "bound_by": tile["bound_by"], "library_ms": None},
        {"name": "negacyclic_mul", "route": "cuda",
         "source": f"{src}/ntt.cu",
         "replaces": "src/repro/kernels/ntt.py:81",
         "launches": serve["launches"]["negacyclic_mul"],
         "max_abs_err": mul["max_abs_err"], "ms": mul["ms"],
         "plain_ms": mul["plain_ms"], "bound_ms": mul["bound_ms"],
         "bound_by": mul["bound_by"], "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
