#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. build   — compile every kernel from src/repro_torch/kernels/csrc;
               each kernel's registers, stack and spills (ptxas), and the
               tensor-core (IMMA) instructions of the gadget Eval.
  2. serve   — the read path, after a warm-up on 4,096 rows: keygen
               (paper-bfv, gadget mode; its eval-domain CEK runs the
               forward NTT kernel, a*sk the two-varying multiply), the
               full hg38 column (34,423 rows, padded to 65,536)
               encrypted on the card (pk0 and pk1 transformed once, then
               the key multiply), a
               QueryServer(batch=4) answering 8 requests.
  3. kernels — each serve-path kernel against its plain PyTorch version
               on the card, byte-equal (torch.equal; residues are
               integers, so the tolerance is 0), on the served column at
               every tile shape the served batches gave the Eval kernel,
               plus edge shapes and a tile of the largest digits; the
               multiply against each key's transform at every row count
               the paths give it; kernel and plain times by CUDA events;
               bounds from the bytes, the card's integer multiply-add
               rate and (the gadget Eval) its dense INT8 tensor-core
               rate.
  4. profile — the same requests traced and under torch.profiler:
               engine counters, span totals, device busy share, device
               time by kernel name.
  5. index   — SortedIndex.build over 4,096 rows (encrypted_sort through
               the Eval kernel), point lookups and ranges vs the truth.
  6. keymul  — gadget_keymul on 1,024 served lanes: ring.ntt/intt on the
               card run the ntt_br kernels (forward and inverse); coeff 0
               of scale·d0 + keymul must equal the gadget Eval kernel's
               residues (two independent kernels).  Then ntt_br in both
               directions against its plain version at keygen's
               [8, 2, 4096], at [4, 2, 16384] (paper-ckks) and at the
               keymul shapes, and the round trip.
  7. write   — the paper-mode write path (paper_ecek_weight=0), after
               the gadget table is freed: keygen, the hg38 column
               encrypted, SortedIndex.build over all 34,423 rows, then
               the write benchmark's traffic (5 % = 1,721 inserts in 4
               chunks, each followed by a Range; a delete of 2 rows and a
               full-range query; the 8 requests of phase 2 scanned over
               base ∪ delta; a union Eq probe of a delta value; compact;
               the probe again), every answer held against the running
               plaintext, under obs tracing (span totals) and with the
               compaction under torch.profiler.
  8. paper   — the paper Eval kernel against its plain version at every
               shape the write phase gave it (column pass at its scan
               tiles, 2,048-row delta tiles and the full 65,536 rows,
               bounds pass, lane form at 32,768 sort pairs, 65,536 merge
               pairs and the probe lanes, one bound for every lane).
  9. shard   — after the write table is freed, the serve keys' hg38 table
               re-encrypted (same seed, same rows) and re-partitioned into
               4 logical shards ([4, 16,384] slots); a
               ShardedQueryServer(batch=4) answers the 8 requests and the
               sharded benchmark's query (30th-70th percentile Range,
               TopK 8), each equal to the unsharded server's answer and
               the truth; the scan ratio against S = 1 and the merge
               bound; a ShardedIndex Eq probe; a 431-row sharded insert,
               a Range over base ∪ delta, compaction, the Range again.
               Then one shard-stacked scan tile against its plain version,
               and the gadget Eval against its plain version at every
               shape the path gave it, on rows of the sharded column.
 10. join    — the join benchmark's traffic (hg38 keys mod 4,302):
               sort-merge at full hg38 through QueryServer.submit_join
               (left 34,423 rows, right the last 17,211; both SortedIndex
               builds timed), then nested loops on a cut (the first 8,192
               x 4,096 rows) in gadget mode (two joins deduped onto one
               grid, and a [4 x 4]-shard join) and in paper mode (the
               write keys).  Then the gadget Eval against its plain
               version at every shape the path gave it, and the pair-grid
               Eval layouts (gadget: the negated right column against
               negated left atoms, with a q - 1 digit tile; paper: the
               column form of both sides) against their plain versions.
 11. card    — the card's name and power limit (nvidia-smi), then one
               {"kernels": [...]} line with every kernel's numbers.

Launch counts are zeroed just before each path (serve, keymul, write,
shard, join) and read just after; each path's kernels must have
launched.  The last
line is the device record.  Any failure raises: the script then exits
non-zero without it, as it does with no CUDA device or without the
repository beside it.  It imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import gc
import json
import shutil
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
KEYMUL_LANES = 1024
WRITE_SHARE = 0.05          # the write benchmark's insert share
WRITE_STEPS = 4
SHARDS = 4
SHARD_TOPK = 8              # the sharded benchmark's k
SHARD_INSERT = 431
JOIN_CUT = (8192, 4096)     # nested-loop cut: left x right rows
SEED = 0

# H100 SXM published memory rate (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on Hopper (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper: 16 in each of the SM's 4 partitions, against 32 FP32
# lanes).  The kernels' 32 x 32 -> 64-bit integer multiply-adds issue
# at most one per such lane and clock, so SMs x 64 x the maximum SM
# clock is the most the card can do of them.
INT32_LANES_PER_SM = 64
# dense INT8 tensor-core operations per second of one H100 SXM (NVIDIA
# data sheet, without sparsity, at 700 W): the gadget Eval's u8 product
INT8_TC_OPS_PER_S = 1979e12


# the kernels each driven path must launch: keygen's a*sk is the multiply
# with two varying operands, its eval-domain gadget CEK and the key
# transforms (KeySet.key_br, once per key) run the forward NTT, and every
# encryption and decryption the multiply against a key transform
SERVE_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt",
                 "negacyclic_mul", "ntt_br_fwd")
KEYMUL_KERNELS = ("ntt_br_fwd", "ntt_br_inv")
WRITE_KERNELS = ("eval_coeff0_paper", "negacyclic_mul_ntt",
                 "negacyclic_mul", "ntt_br_fwd")
# the shard path encrypts its pad and insert rows and scans, sorts and
# probes through the gadget Eval; the join path encrypts its tables and
# runs both Evals (gadget sort-merge and nested cut, paper nested cut)
SHARD_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt")
JOIN_KERNELS = ("eval_coeff0_gadget", "eval_coeff0_paper",
                "negacyclic_mul_ntt")


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


def _bound(nbytes: int, ops: int, ops_per_s: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bytes": nbytes, "ops": ops, "ops_per_s": ops_per_s}


def eval_bound(A: int, T: int, K: int, n: int, D: int, per_lane: bool,
               rate: dict) -> dict:
    """Gadget Eval over A atoms x T rows: read the tile's c1 and c0
    coefficient 0, the bounds (one per atom, or per lane) and cek_rev
    once, write [A, T, K]; the byte-split product is A*T lanes x (K n
    D4) digit bytes (D rounded up to whole 4-byte words) x 8 byte columns
    u8 multiply-adds, 2 operations each, at the dense INT8 tensor-core
    rate."""
    nb = A * T if per_lane else A
    nbytes = 8 * (T * K * n + T * K + nb * (K * n + K) + K * D * K * n
                  + A * T * K)
    words = -(-D // 4)
    d4 = 4 * (1 << (words - 1).bit_length())
    return _bound(nbytes, A * T * K * n * d4 * 8 * 2, INT8_TC_OPS_PER_S)


def mul_bound(B: int, K: int, n: int, b_rows: int, rate: dict, *,
              key_ntt: bool) -> dict:
    """Fused multiply over B rows: read a (and b, b_rows rows, or the
    key's transform as [K, n] 32-bit pairs) and the Shoup tables ([K, 4,
    n] pairs) once, write B rows; one multiply-add per modular multiply:
    per (row, tower) twists and pointwise 3n and n log2 n butterflies
    for two transforms (key_ntt), 4n and 1.5 n log2 n for three."""
    S = n.bit_length() - 1
    ops = 3 * n + n * S if key_ntt else 4 * n + 3 * (n // 2) * S
    b_bytes = 8 * K * n if key_ntt else 8 * b_rows * K * n
    nbytes = 8 * 2 * B * K * n + b_bytes + 8 * 4 * K * n
    return _bound(nbytes, B * K * ops, rate["int_macs_per_s"])


def ntt_bound(B: int, K: int, n: int, rate: dict) -> dict:
    """ntt_br over B rows (either direction): read x and its twist and
    twiddle pairs once, write B rows; n twist multiplies + n/2 log2 n
    butterflies per (row, tower)."""
    S = n.bit_length() - 1
    nbytes = 8 * (2 * B * K * n + 2 * K * n)
    return _bound(nbytes, B * K * (n + (n // 2) * S), rate["int_macs_per_s"])


def paper_bound(B: int, K: int, n: int, lane_form: bool, b_rows: int,
                rate: dict) -> dict:
    """Paper Eval over B lanes: read each lane's c1 and c0 coefficient 0
    (and b's, b_rows of them, in the lane form) and rev(cek) once, write
    [B, K]; one multiply-add per c1 coefficient."""
    rows = B + (b_rows if lane_form else 0)
    nbytes = 8 * (rows * (K * n + K) + K * n + K + B * K)
    return _bound(nbytes, B * K * n, rate["int_macs_per_s"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _ptxas(log: str) -> list:
    """Registers, spills and stack of each kernel from `nvcc -Xptxas -v`
    output: [{kernel, registers, spill_stores, spill_loads, stack}]."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(
        k["kernel"] for k in out), capture_output=True, text=True,
        timeout=60).stdout.splitlines() if shutil.which("c++filt") else []
    for k, name in zip(out, names):
        k["kernel"] = name.split("(")[0]
    return out


def phase_build() -> dict:
    """Build every library; each kernel's registers and spills, and the
    tensor-core instructions (IMMA) in the gadget Eval's machine code."""
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
            out[f"ptxas_{name}"] = _ptxas(log.read_text())
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(
        "cmp_eval"))], capture_output=True, text=True, timeout=300).stdout
    out["imma_instructions_cmp_eval"] = sum("IMMA" in ln
                                            for ln in sass.splitlines())
    emit(out)
    require(out["imma_instructions_cmp_eval"] > 0,
            "the gadget Eval has no tensor-core (IMMA) instruction")
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
    last chunk, and the wrapper's split by column; and a 1,024-lane tile
    whose differences are all q - 1 (bound = c1 + 1), the largest digits.
    Multiply against a key transform (negacyclic_mul_ntt): pk0, pk1 and
    sk at every row count the paths give it (an encryption chunk of
    8,192, the column's last chunk, an insert chunk, a decrypted sample,
    one row); with two varying operands (negacyclic_mul): [64, 2, 4096]
    full and stride 0, and an encryption chunk against pk0."""
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
        args = (uniq[0], uniq[1], off, rows, sel, b0, b1, ks.cek_rev, qs,
                params.scale, lb)
        if kernel:
            return CK.eval_coeff0_gadget(*args, cek_bytes=ks.cek_rev_bytes)
        return CK.eval_coeff0_gadget_plain(*args)

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
    lanes = min(1024, W)
    per_lane = (table_stack, W - lanes, lanes, [0], *bounds(1, lanes))
    cases.append(per_lane)
    top = slice(W - lanes, W)           # d = q - 1 on every coefficient
    cases.append((table_stack, W - lanes, lanes, [0], col.c0[None, top],
                  ((col.c1[top] + 1) % ring.q_arr)[None]))
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

    def held(got, want):
        nonlocal mul_eq
        torch.cuda.synchronize()
        mul_eq &= torch.equal(got, want)
        mul_errs.append(max_abs_err(got, want))
    for b in (b64, ks.pk0):
        held(NK.negacyclic_mul(a64, b, ring),
             NK.negacyclic_mul_plain(a64, b, ring))
    u = sampling.ternary_poly(params, gen, (ENC_CHUNK_ROWS,))
    held(NK.negacyclic_mul(ks.pk0, u, ring),
         NK.negacyclic_mul_plain(ks.pk0, u, ring))
    last_chunk = table.n_rows % ENC_CHUNK_ROWS or ENC_CHUNK_ROWS
    shapes = (ENC_CHUNK_ROWS, last_chunk, 431, 256, 1)
    for name in ("pk0", "pk1", "sk"):
        br, pairs = ks.key_br(name)
        for rows in shapes:
            x = (u[:rows] if name != "sk"
                 else sampling.uniform_poly(params, gen, (rows,)))
            held(NK.negacyclic_mul_ntt(x, br, ring, pairs),
                 NK.negacyclic_mul_ntt_plain(x, br, ring))
    br, pairs = ks.key_br("pk0")
    mul_ntt = {"ms": time_cuda(
        lambda: NK.negacyclic_mul_ntt(u, br, ring, pairs), 10),
        "plain_ms": time_cuda(
            lambda: NK.negacyclic_mul_ntt_plain(u, br, ring), 1),
        **mul_bound(ENC_CHUNK_ROWS, K, n, 1, rate, key_ntt=True)}
    mul_var = {"ms": time_cuda(lambda: NK.negacyclic_mul(u, ks.pk0, ring),
                               10),
               "plain_ms": time_cuda(
                   lambda: NK.negacyclic_mul_plain(u, ks.pk0, ring), 1),
               **mul_bound(ENC_CHUNK_ROWS, K, n, 1, rate, key_ntt=False)}
    mul64_ms = time_cuda(lambda: NK.negacyclic_mul(a64, b64, ring), 20)
    del u
    require(mul_eq, f"multiply kernel != plain (max |err| {mul_errs})")
    torch.cuda.empty_cache()

    out = {
        "phase": "kernels", "tolerance": 0, "rate": rate,
        "launches": dict(_build.LAUNCHES),
        "eval": {"equal": eq, "max_abs_err": max(errs),
                 "cases": len(errs), "served_tiles": timed,
                 "per_lane_1024_ms": pl_ms},
        "mul": {"equal": mul_eq, "max_abs_err": max(mul_errs),
                "cases": len(mul_errs), "key_rows": list(shapes),
                "shape": [ENC_CHUNK_ROWS, K, n], "key_ntt": mul_ntt,
                "var": mul_var, "ms_64x64": mul64_ms},
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
    require(all(launches[k] > 0 for k in SERVE_KERNELS),
            f"a kernel never launched on the serve path: {launches}")
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
    spans = _span_ms(tracer)
    dev = _device_summary(prof, wall, top=8)
    out = {"phase": "profile", "traced_wall_s": wall,
           "eval_lanes": lanes, "eval_tiles": tiles,
           "span_ms": spans,
           "device_events": dev["events"],
           "device_busy_s": dev["busy_s"],
           "device_busy_share": dev["busy_share"],
           "device_ms_by_name": dev["ms_by_name"]}
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


def phase_keymul(ks, table, rate) -> dict:
    """gadget_keymul over KEYMUL_LANES served lanes, its NTTs on the
    ntt_br kernels (launch counts zeroed just before, read just after),
    cross-checked against the gadget Eval kernel; then ntt_br against its
    plain version at every shape it runs at, and timed."""
    import torch
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    from repro_torch.core import gadget as G
    from repro_torch.core import ring as R
    from repro_torch.core import sampling
    from repro_torch.core.encrypt import Ciphertext
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK

    params, ring = ks.params, ks.ring
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    qs = ring.q_arr[:, 0]
    rows = KEYMUL_LANES
    col = table.scan_column("value")
    bound = E.encrypt(ks, 30000, SEED + 11)
    lanes = Ciphertext(col.c0[:rows], col.c1[:rows])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    d = C.ct_sub(ring, lanes, Ciphertext(bound.c0[None], bound.c1[None]))
    keyed = G.gadget_keymul(ks, d.c1)
    via_ntt = R.add(ring, R.scalar_mul(ring, d.c0, params.scale),
                    keyed)[..., 0]
    torch.cuda.synchronize()
    keymul_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    via_eval = CK.eval_coeff0_gadget(
        col.c0[None], col.c1[None], 0, rows, [0], bound.c0[None],
        bound.c1[None], ks.cek_rev, qs, params.scale,
        params.profile.gadget_log_base)[0]
    torch.cuda.synchronize()
    cross_equal = bool(torch.equal(via_ntt, via_eval))
    del d, keyed, via_ntt, via_eval

    gen = sampling.make_generator(SEED + 12, ks.device)
    ckks = make_params("paper-ckks")
    cring = R.make_ring(ckks, ks.device)
    digits = sampling.uniform_poly(params, gen, (rows * K * D,))
    cases = [("keygen cek_gadget", ks.cek_gadget.reshape(-1, K, n), ring),
             ("paper-ckks", sampling.uniform_poly(ckks, gen, (4,)), cring),
             ("keymul digits", digits, ring),
             ("keymul sum", digits[:rows], ring)]
    eq, errs = True, []
    for _, x, rg in cases:
        for fwd in (True, False):
            got = NK.ntt_br(x, rg, fwd=fwd)
            want = NK.ntt_br_plain(x, rg, fwd=fwd)
            torch.cuda.synchronize()
            eq &= torch.equal(got, want)
            errs.append(max_abs_err(got, want))
        eq &= torch.equal(NK.ntt_br(NK.ntt_br(x, rg), rg, fwd=False), x)
    torch.cuda.synchronize()
    # times at the keymul path's shapes: forward over its K*D digit
    # polynomials per lane, inverse over one polynomial per lane
    timed = {}
    for name, x, fwd in (("fwd", digits, True), ("inv", digits[:rows], False)):
        timed[name] = {
            "shape": list(x.shape),
            "ms": time_cuda(lambda: NK.ntt_br(x, ring, fwd=fwd), 10),
            "plain_ms": time_cuda(
                lambda: NK.ntt_br_plain(x, ring, fwd=fwd), 1),
            **ntt_bound(x.shape[0], K, n, rate)}
    timed["fwd_keygen_ms"] = time_cuda(
        lambda: NK.ntt_br(cases[0][1], ring), 20)
    del digits, cases
    torch.cuda.empty_cache()
    out = {"phase": "keymul", "lanes": rows, "cross_equal": cross_equal,
           "keymul_s": keymul_s, "launches": launches, "ntt_equal": eq,
           "max_abs_err": max(errs), "ntt_cases": len(errs), **timed}
    emit(out)
    require(cross_equal, "coeff0 of gadget_keymul != the gadget Eval")
    require(eq, f"ntt_br kernel != plain (max |err| {errs})")
    require(all(launches[k] > 0 for k in KEYMUL_KERNELS),
            f"an NTT kernel never launched on the keymul path: {launches}")
    return out


def phase_write(dev, vals) -> tuple:
    """The paper-mode write path (the write benchmark's traffic over the
    full column), with every launch count zeroed just before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core import encrypt as E
    from repro_torch.core.compare import next_pow2
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.db import execute, compact
    from repro_torch.db import plan as P
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    params = make_params(PROFILE, mode="paper")
    seeds = iter(range(5000, 6000))

    def enc(v):
        return E.encrypt(ks, int(v), next(seeds))

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    walls = {}
    with obs.tracing() as tracer:
        t0 = time.perf_counter()
        ks = keygen(params, SEED + 20, device=dev, paper_ecek_weight=0)
        walls["keygen_s"] = sync_s(t0)
        t0 = time.perf_counter()
        table = Table.from_arrays(ks, "hg38_w", {"value": vals}, SEED + 21)
        walls["encrypt_s"] = sync_s(t0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            idx = SortedIndex.build(ks, table, "value")
            walls["index_build_s"] = sync_s(t0)
        build_dev = _device_summary(prof, walls["index_build_s"])
        del prof
        build_ok = bool(np.array_equal(vals[idx.perm], np.sort(vals)))
        indexes = {"value": idx}
        n = len(vals)
        rng = np.random.default_rng(7)
        m = max(8, round(WRITE_SHARE * n))

        # ---- sustained ingest while serving (FIFO mutation queue) ------
        server = QueryServer(ks, table, indexes=indexes, batch=BATCH)
        all_vals, alive = vals.copy(), np.ones(n, bool)
        chunks = np.array_split(rng.choice(vals, m), WRITE_STEPS)
        qok = gid_ok = True
        t0 = time.perf_counter()
        for i, chunk in enumerate(chunks):
            ins = server.submit_insert({"value": chunk}, SEED + 1000 + i)
            lo, hi = (int(v) for v in np.sort(rng.choice(vals, 2,
                                                         replace=False)))
            qid = server.submit(P.Range("value", enc(lo), enc(hi)))
            res = server.run()
            start = len(all_vals)
            all_vals = np.concatenate([all_vals, chunk])
            alive = np.concatenate([alive, np.ones(len(chunk), bool)])
            gid_ok &= np.array_equal(res[ins].row_ids,
                                     np.arange(start, start + len(chunk)))
            qok &= np.array_equal(
                res[qid].mask, (all_vals >= lo) & (all_vals <= hi) & alive)
        walls["insert_serve_s"] = sync_s(t0)
        # a tombstone mid-stream: the very next query must exclude it
        dead = [n // 2, n // 2 + 1]
        t0 = time.perf_counter()
        did = server.submit_delete(dead)
        qid = server.submit(P.Range("value", enc(all_vals.min()),
                                    enc(all_vals.max())))
        res = server.run()
        walls["delete_query_s"] = sync_s(t0)
        alive[dead] = False
        tomb_ok = bool(res[did].deleted == len(dead)
                       and np.array_equal(res[qid].mask, alive))
        dbuild = sum(b.delta_build_compares for b in server.batch_log)

        # ---- the 8 served requests scanned over base ∪ delta -----------
        scan = QueryServer(ks, table, batch=BATCH)
        reqs = _requests(ks, vals, np.random.default_rng(SEED))
        qids = [scan.submit(q) for q, _ in reqs]
        t0 = time.perf_counter()
        sres = scan.run()
        walls["scan_requests_s"] = sync_s(t0)
        scan_correct = sum(
            int(np.array_equal(sres[q].row_ids,
                               np.nonzero(truth(all_vals) & alive)[0]))
            for q, (_, truth) in zip(qids, reqs))
        scan_batches = [{"queries": b.queries,
                         "scan_compares": b.scan_compares,
                         "wall_s": b.wall_s} for b in scan.batch_log]
        scan_width = table.scan_width
        del scan, sres

        # ---- union probe: base search + one per-run binary search ------
        target = int(all_vals[n + m // 2])          # lives in the delta run
        q_eq = P.Eq("value", enc(target))
        execute(ks, table, q_eq, indexes=indexes)              # warm
        t0 = time.perf_counter()
        for _ in range(2):
            res = execute(ks, table, q_eq, indexes=indexes)
        walls["union_probe_s"] = sync_s(t0) / 2
        want = (all_vals == target) & alive
        probe_ok = bool(np.array_equal(res.mask, want))
        n_b, n_d = next_pow2(table.n_rows), next_pow2(table.n_delta)
        probe_bound = 2 * 2 * (max(1, (n_b - 1).bit_length())
                               + max(1, (n_d - 1).bit_length()))
        probe_compares = res.stats.index_compares

        # ---- compaction: merge network, never a rebuild -----------------
        nb, nd = table.n_rows, table.n_delta
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cstats = compact(ks, table, indexes)
            walls["compact_s"] = sync_s(t0)
        L = next_pow2(max(nb, nd))
        merge_bound = cstats.merge_rounds * L * (1 + max(1,
                                                         L.bit_length() - 1))
        sorted_ok = bool(np.array_equal(all_vals[indexes["value"].perm],
                                        np.sort(all_vals)))
        execute(ks, table, q_eq, indexes=indexes)              # warm
        t0 = time.perf_counter()
        for _ in range(2):
            post = execute(ks, table, q_eq, indexes=indexes)
        walls["post_probe_s"] = sync_s(t0) / 2
        post_ok = bool(np.array_equal(post.mask, want))
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    spans = _span_ms(tracer)
    compact_dev = _device_summary(prof, walls["compact_s"])
    out = {
        "phase": "write", "profile": PROFILE, "mode": "paper",
        "rows_base": n, "rows_inserted": m, "steps": WRITE_STEPS,
        "n_padded": table.n_padded, "index_build_ok": build_ok,
        "index_build_compares": idx.build_compares,
        "index_build_device": build_dev,
        "inserts_per_s": m / walls["insert_serve_s"],
        "exact": bool(qok and gid_ok), "tombstone_ok": tomb_ok,
        "delta_build_compares": dbuild,
        "scan_correct": f"{scan_correct}/{len(reqs)}",
        "scan_width": scan_width, "scan_batches": scan_batches,
        "union_probe": {"compares": probe_compares, "bound": probe_bound,
                        "exact": probe_ok, "matched": int(want.sum())},
        "compact": {"merge_compares": cstats.merge_compares,
                    "merge_bound": merge_bound,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds, "sorted_ok": sorted_ok,
                    "post_probe_compares": post.stats.index_compares,
                    "post_exact": post_ok, "device": compact_dev},
        "walls": walls, "span_ms": spans, "launches": launches,
        "peak_mem_bytes": peak,
    }
    emit(out)
    require(build_ok, "the write table's index is not sorted")
    require(qok and gid_ok, "served answers diverged from the plaintext")
    require(tomb_ok, "the tombstoned rows were not excluded")
    require(scan_correct == len(reqs),
            f"scan over base ∪ delta answered {out['scan_correct']}")
    require(probe_ok, "union probe diverged from the from-scratch answer")
    require(probe_compares <= probe_bound,
            f"union probe {probe_compares} > bound {probe_bound}")
    require(not table.has_delta and sorted_ok and post_ok,
            "compaction left a delta, an unsorted index or a wrong answer")
    require(cstats.merge_compares <= merge_bound,
            f"merge {cstats.merge_compares} > bound {merge_bound}")
    require(cstats.merge_compares < cstats.rebuild_compares,
            "compaction cost a rebuild, not a merge")
    require(all(launches[k] > 0 for k in WRITE_KERNELS),
            f"a kernel never launched on the write path: {launches}")
    return ks, table, out


def _span_ms(tracer) -> dict:
    """Total milliseconds by span name over a tracer's events."""
    spans: dict = {}
    for ev in tracer.chrome_trace()["traceEvents"]:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return spans


def _device_summary(prof, wall_s: float, top: int = 6) -> dict:
    """Device busy time (union of kernel intervals), its share of the
    wall, and the top kernels by device time, from a torch.profiler run."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}                 # keyed as printed: 80 characters
    for e in dev:
        c, us = by_name.get(e.name[:80], (0, 0.0))
        by_name[e.name[:80]] = (c + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, None
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if end is None or lo >= end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"events": len(dev),
            "busy_s": busy_us / 1e6 if dev else None,
            "busy_share": busy_us / 1e6 / wall_s if dev else None,
            "ms_by_name": {name: {"count": c, "ms": us / 1e3}
                           for name, (c, us) in ranked}}


def record_gadget_shapes() -> tuple:
    """Record the shape of every call of the gadget Eval's wrapper until
    `stop()` (every module reaches the kernel through the attribute of
    `cmp_eval`).  Returns (shapes, stop): shapes maps (columns, width,
    rows, per-lane bounds, sel) to [calls, the first call's row offset]."""
    from repro_torch.kernels import cmp_eval as CK
    inner, shapes = CK.eval_coeff0_gadget, {}

    def recorded(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                 bounds_c1, *args, **kwargs):
        key = (*uniq_c1.shape[:2], rows, bounds_c1.dim() == 4,
               tuple(np.asarray(sel, np.int64).tolist()))
        shapes.setdefault(key, [0, row_offset])[0] += 1
        return inner(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, *args, **kwargs)

    def stop():
        CK.eval_coeff0_gadget = inner
    CK.eval_coeff0_gadget = recorded
    return shapes, stop


def check_gadget_shapes(ks, source, shapes: dict, seed: int,
                        rate) -> dict:
    """The gadget Eval kernel against its plain version at every shape a
    path gave it (`record_gadget_shapes`), tolerance 0: the column stack
    and the bounds are rows of the path's own column `source` ([N, K, n])
    drawn by a seeded generator, at the path's first row offset and
    atom selection.  Each shape is timed by CUDA events beside its bound
    (one column tile per unique column the selection names)."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.kernels import cmp_eval as CK

    params = ks.params
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    args = (ks.cek_rev, ks.ring.q_arr[:, 0], params.scale,
            params.profile.gadget_log_base)
    gen = sampling.make_generator(seed, ks.device)

    def draw(*shape):
        pick = torch.randint(0, source.c0.shape[0], (int(np.prod(shape)),),
                             generator=gen, device=ks.device)
        return (source.c0[pick].view(*shape, K, n),
                source.c1[pick].view(*shape, K, n))
    eq, out = True, []
    for (U, W, rows, per_lane, sel), (calls, off) in sorted(
            shapes.items(), key=lambda kv: -kv[1][0]):
        A = len(sel)
        u0, u1 = draw(U, W)
        b0, b1 = draw(A, rows) if per_lane else draw(A)

        def kernel():
            return CK.eval_coeff0_gadget(u0, u1, off, rows, sel, b0, b1,
                                         *args, cek_bytes=ks.cek_rev_bytes)
        got = kernel()
        want = CK.eval_coeff0_gadget_plain(u0, u1, off, rows, sel, b0, b1,
                                           *args)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        eq &= same
        groups = [sel.count(u) for u in dict.fromkeys(sel)]
        bounds = [eval_bound(a, rows, K, n, D, per_lane, rate)
                  for a in groups]
        out.append({"columns": U, "width": W, "row_offset": off,
                    "rows": rows, "atoms": A, "per_lane": per_lane,
                    "launches_per_call": len(groups), "calls": calls,
                    "equal": same, "max_abs_err": max_abs_err(got, want),
                    "ms": time_cuda(kernel, 3),
                    **_bound(sum(b["bytes"] for b in bounds),
                             sum(b["ops"] for b in bounds),
                             INT8_TC_OPS_PER_S)})
        del u0, u1, b0, b1, got, want
    torch.cuda.empty_cache()
    return {"tolerance": 0, "equal": eq, "shapes": out}


def phase_paper(ks, table, write, rate) -> dict:
    """The paper Eval kernel against its plain version at every shape the
    write phase gave it, on the write table's column; timed at the scan
    tile and at the sort and merge stage shapes."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.core.compare import next_pow2
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    params = ks.params
    K, n = params.num_towers, params.n
    qs = ks.ring.q_arr[:, 0]
    col = table.columns["value"]
    W = write["scan_width"]
    gen = sampling.make_generator(SEED + 13, ks.device)
    args = (ks.cek_rev, qs, params.scale)
    tiles = sorted({min(KO.lane_tile(W, b["scan_compares"] // W),
                        table.n_padded) for b in write["scan_batches"]})
    delta_rows = W - table.n_padded if W > table.n_padded else 2048
    # a merge stage compares L = next_pow2(base rows) pairs, a sort stage
    # L / 2: the first half of the merge lanes
    merge_pairs = next_pow2(write["rows_base"])
    pairs = merge_pairs // 2
    pick = torch.randint(0, table.n_rows, (2, merge_pairs), generator=gen,
                         device=ks.device)
    mlo = (col.c0[pick[0]], col.c1[pick[0]])
    mhi = (col.c0[pick[1]], col.c1[pick[1]])
    lo, hi = (mlo[0][:pairs], mlo[1][:pairs]), (mhi[0][:pairs], mhi[1][:pairs])
    probe = torch.randint(0, table.n_rows, (2, 8), generator=gen,
                          device=ks.device)
    cases = []                       # (name, a0, a1, b0, b1)
    for T in tiles:
        for off in (0, table.n_padded - T):
            cases.append((f"column {T}@{off}", col.c0[off:off + T],
                          col.c1[off:off + T], None, None))
    cases.append(("column delta", col.c0[-delta_rows:],
                  col.c1[-delta_rows:], None, None))
    cases.append(("column full", col.c0, col.c1, None, None))
    for A in (8, 10):
        b = sampling.uniform_poly(params, gen, (2, A))
        cases.append((f"bounds {A}", b[0], b[1], None, None))
    cases.append(("lanes sort", *lo, *hi))
    cases.append(("lanes merge", *mlo, *mhi))
    for B in (2, 8):
        cases.append((f"lanes probe {B}", col.c0[probe[0, :B]],
                      col.c1[probe[0, :B]], col.c0[probe[1, :B]],
                      col.c1[probe[1, :B]]))
    cases.append(("lanes one bound", *lo, lo[0][:1], lo[1][:1]))
    eq, errs = True, {}
    for name, a0, a1, b0, b1 in cases:
        got = CK.eval_coeff0_paper(a0, a1, *args, b0, b1)
        want = CK.eval_coeff0_paper_plain(a0, a1, *args, b0, b1)
        torch.cuda.synchronize()
        eq &= torch.equal(got, want)
        errs[name] = max_abs_err(got, want)
    timed = {
        "column": [{"rows": T,
                    "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                        col.c0[:T], col.c1[:T], *args), 10),
                    "plain_ms": time_cuda(
                        lambda: CK.eval_coeff0_paper_plain(
                            col.c0[:T], col.c1[:T], *args), 1),
                    **paper_bound(T, K, n, False, 0, rate)}
                   for T in tiles],
        "lanes": {"pairs": pairs,
                  "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                      *lo, *args, *hi), 10),
                  "plain_ms": time_cuda(lambda: CK.eval_coeff0_paper_plain(
                      *lo, *args, *hi), 1),
                  **paper_bound(pairs, K, n, True, pairs, rate)},
        "lanes_merge": {
            "pairs": merge_pairs,
            "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                *mlo, *args, *mhi), 10),
            "plain_ms": time_cuda(lambda: CK.eval_coeff0_paper_plain(
                *mlo, *args, *mhi), 1),
            **paper_bound(merge_pairs, K, n, True, merge_pairs, rate)},
    }
    del lo, hi, mlo, mhi, cases
    torch.cuda.empty_cache()
    out = {"phase": "paper", "tolerance": 0, "equal": eq,
           "max_abs_err": max(errs.values()), "cases": errs, **timed}
    emit(out)
    require(eq, f"paper Eval kernel != plain (|err| {errs})")
    return out


def _sharded_query(ks, vals):
    """The sharded benchmark's query: a Range over the 30th-70th
    percentile with TopK SHARD_TOPK (benchmarks/db_engine.py run_sharded),
    and its truth (mask, top values)."""
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P
    lo, hi = (int(np.percentile(vals, 30)), int(np.percentile(vals, 70)))
    q = P.Query(where=P.Range("value", E.encrypt(ks, lo, SEED + 31),
                              E.encrypt(ks, hi, SEED + 32)),
                top_k=P.TopK("value", SHARD_TOPK))
    mask = (vals >= lo) & (vals <= hi)
    return q, mask, sorted(vals[mask].tolist(), reverse=True)[:SHARD_TOPK]


def phase_shard(ks, vals, rate) -> dict:
    """The sharded read and write path over the serve keys' hg38 table
    (re-encrypted under the serve phase's seed: the same rows), with
    every launch count zeroed just before it, the served batches and the
    index build under torch.profiler; then one shard-stacked scan tile
    against its plain version."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import db
    from repro_torch.core import encrypt as E
    from repro_torch.core import ring as R
    from repro_torch.core.compare import next_pow2
    from repro_torch.db import plan as P
    from repro_torch.db.executor import dedup_atom_columns, stack_atom_bounds
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.shard import executor as SX
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {}
    table = Table.from_arrays(ks, "hg38", {"value": vals}, SEED + 1)
    reqs = _requests(ks, vals, np.random.default_rng(SEED))
    q_top, top_mask, top_want = _sharded_query(ks, vals)
    # the unsharded answers, and S = 1's counters for the ratio check
    flat = QueryServer(ks, table, batch=BATCH)
    fids = [flat.submit(q) for q, _ in reqs] + [flat.submit(q_top)]
    flat_res = flat.run()
    one = db.ShardedTable.from_table(ks, table, spec=db.ShardSpec.create(1))
    one_stats = db.execute(ks, one, q_top).stats
    del one, flat
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    shapes, stop_recording = record_gadget_shapes()
    t0 = time.perf_counter()
    st = db.ShardedTable.from_table(ks, table,
                                    spec=db.ShardSpec.create(SHARDS))
    walls["partition_s"] = sync_s(t0)
    n_sp = st.n_padded_per_shard
    del table
    server = db.ShardedQueryServer(ks, st, batch=BATCH)
    ids = [server.submit(q) for q, _ in reqs] + [server.submit(q_top)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = server.run()
        walls["serve_s"] = sync_s(t0)
    serve_dev = _device_summary(prof, walls["serve_s"])
    del prof
    correct = 0
    for qid, fid, (_, truth) in zip(ids, fids, reqs):
        want = np.nonzero(truth(vals))[0]
        correct += int(np.array_equal(res[qid].row_ids, want)
                       and np.array_equal(flat_res[fid].row_ids, want))
    top = res[ids[-1]]
    top_ok = bool(np.array_equal(top.mask, top_mask)
                  and vals[top.row_ids].tolist() == top_want
                  and vals[flat_res[fids[-1]].row_ids].tolist() == top_want)
    ratio = (top.stats.per_shard_scan_compares
             / one_stats.per_shard_scan_compares)
    kp, sp = next_pow2(SHARD_TOPK), next_pow2(SHARDS)
    merge_bound = (sp - 1) * (kp + (kp // 2) * max(1, kp.bit_length() - 1))

    # ---- fan-out index: one Eq probe --------------------------------------
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx = db.ShardedIndex.build(ks, st, "value")
        walls["index_build_s"] = sync_s(t0)
    index_dev = _device_summary(prof, walls["index_build_s"])
    del prof
    target = int(vals[len(vals) // 3])
    t0 = time.perf_counter()
    probe = db.execute(ks, st, P.Eq("value", E.encrypt(ks, target,
                                                       SEED + 33)),
                       indexes={"value": idx})
    walls["eq_probe_s"] = sync_s(t0)
    probe_ok = bool(np.array_equal(probe.mask, vals == target))

    # ---- writes: insert, Range over base ∪ delta, compact, Range ---------
    rng = np.random.default_rng(SEED + 34)
    ins_vals = rng.choice(vals, SHARD_INSERT)
    all_vals = np.concatenate([vals, ins_vals])
    writer = db.ShardedQueryServer(ks, st, indexes={"value": idx},
                                   batch=BATCH)
    lo, hi = (int(v) for v in np.sort(rng.choice(vals, 2, replace=False)))
    rq = P.Range("value", E.encrypt(ks, lo, SEED + 35),
                 E.encrypt(ks, hi, SEED + 36))
    want = (all_vals >= lo) & (all_vals <= hi)
    t0 = time.perf_counter()
    ins = writer.submit_insert({"value": ins_vals}, SEED + 37)
    qid = writer.submit(rq)
    wres = writer.run()
    walls["insert_range_s"] = sync_s(t0)
    delta_slots = st.delta_block
    t0 = time.perf_counter()
    scan = db.execute(ks, st, rq)
    walls["union_scan_s"] = sync_s(t0)
    write_ok = bool(np.array_equal(wres[ins].row_ids,
                                   len(vals) + np.arange(SHARD_INSERT))
                    and np.array_equal(wres[qid].mask, want)
                    and np.array_equal(scan.mask, want))
    t0 = time.perf_counter()
    cstats = writer.compact()
    walls["compact_s"] = sync_s(t0)
    after = db.execute(ks, st, rq, indexes=writer.indexes)
    after_scan = db.execute(ks, st, rq)
    compact_ok = bool(not st.has_delta
                      and np.array_equal(after.mask, want)
                      and np.array_equal(after_scan.mask, want))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    stop_recording()
    peak = torch.cuda.max_memory_allocated()

    # ---- one shard-stacked scan tile against its plain version -----------
    params = ks.params
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    atoms = [a for q, _ in reqs[:BATCH] for i in range(
        P.compile_plan(q).num_leaves) for a in P.compile_plan(q).scan_atoms(i)]
    A, W = len(atoms), st.shard_scan_width
    T = KO.lane_tile(W, SHARDS * A)
    uniq, sel = dedup_atom_columns(st, atoms, st.scan_stack)
    bounds = stack_atom_bounds(atoms)
    lo_row = W - T
    got = SX.sharded_tile_values(ks, uniq, sel, bounds, lo_row, T)
    qs = ks.ring.q_arr[:, 0]

    tile_want = torch.stack([R.crt_centered(
        params, CK.eval_coeff0_gadget_plain(
            uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
            bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
            params.profile.gadget_log_base)) for s in range(SHARDS)])
    torch.cuda.synchronize()
    tile_eq = bool(torch.equal(got, tile_want))
    tile_err = max_abs_err(got, tile_want)

    def kernel_tile():
        for s in range(SHARDS):
            CK.eval_coeff0_gadget(
                uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
                bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
                params.profile.gadget_log_base, cek_bytes=ks.cek_rev_bytes)

    def plain_kernels():
        for s in range(SHARDS):
            CK.eval_coeff0_gadget_plain(
                uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
                bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
                params.profile.gadget_log_base)
    one_b = eval_bound(A, T, K, n, D, False, rate)
    tile = {"shards": SHARDS, "atoms": A, "rows": T,
            "launches": SHARDS * len(set(sel.tolist())),
            "equal": tile_eq, "max_abs_err": tile_err,
            "ms": time_cuda(kernel_tile, 5),
            "plain_ms": time_cuda(plain_kernels, 1),
            **_bound(SHARDS * one_b["bytes"], SHARDS * one_b["ops"],
                     INT8_TC_OPS_PER_S)}
    del uniq, bounds, got, tile_want
    stack = st.columns["value"]                      # [S, N_sp, K, n]
    rows = type(stack)(stack.c0.reshape(-1, K, n),
                       stack.c1.reshape(-1, K, n))
    path_shapes = check_gadget_shapes(ks, rows, shapes, SEED + 45, rate)
    del stack, rows
    out = {
        "phase": "shard", "profile": PROFILE, "mode": "gadget",
        "shards": SHARDS, "rows": int(len(vals)),
        "n_padded_per_shard": n_sp,
        "requests": len(ids), "batch": BATCH,
        "correct": f"{correct}/{len(reqs)}", "topk_ok": top_ok,
        "per_shard_scan_compares": top.stats.per_shard_scan_compares,
        "per_shard_scan_compares_s1": one_stats.per_shard_scan_compares,
        "scan_ratio": ratio, "merge_compares": top.stats.merge_compares,
        "merge_bound": merge_bound,
        "batches": [{"queries": b.queries, "eval_calls": b.eval_calls,
                     "scan_compares": b.scan_compares,
                     "merge_compares": b.merge_compares,
                     "wall_s": b.wall_s} for b in server.batch_log],
        "index_build_compares": idx.build_compares,
        "eq_probe": {"exact": probe_ok,
                     "compares": probe.stats.index_compares,
                     "matched": int((vals == target).sum())},
        "insert": {"rows": SHARD_INSERT, "delta_slots": delta_slots,
                   "exact": write_ok},
        "compact": {"merge_compares": cstats.merge_compares,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds, "exact": compact_ok},
        "walls": walls, "serve_device": serve_dev,
        "index_build_device": index_dev, "launches": launches,
        "peak_mem_bytes": peak, "scan_tile": tile,
        "gadget_shapes": path_shapes,
    }
    emit(out)
    require(correct == len(reqs), f"sharded server answered {out['correct']}")
    require(top_ok, "the sharded top-k differs from the truth")
    require(abs(ratio - 1 / SHARDS) < 1e-12,
            f"per-shard scan ratio {ratio} != 1/{SHARDS}")
    require(top.stats.merge_compares <= merge_bound,
            f"merge {top.stats.merge_compares} > k·S bound {merge_bound}")
    require(probe_ok, "the sharded index probe differs from the truth")
    require(write_ok, "the sharded insert or the union read diverged")
    require(compact_ok, "sharded compaction left a delta or a wrong answer")
    require(tile_eq, f"sharded scan tile != plain (max |err| {tile_err})")
    require(path_shapes["equal"], "the gadget Eval != plain at a shard "
            f"path shape: {path_shapes['shapes']}")
    require(all(launches[k] > 0 for k in SHARD_KERNELS),
            f"a kernel never launched on the shard path: {launches}")
    return out


def phase_join(ks, wks, vals, rate) -> tuple:
    """The join benchmark's traffic, with every launch count zeroed just
    before it: sort-merge at full hg38 (gadget, serve keys), then nested
    loops on the JOIN_CUT rows in gadget mode (two joins sharing one grid
    through a QueryServer batch, and a [SHARDS x SHARDS]-shard join) and
    in paper mode (the write keys `wks`); the sort-merge join and the
    shared grid run under torch.profiler.  Returns the cut tables for
    the layout checks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import db
    from repro_torch.db import join as J
    from repro_torch.db import plan as P
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n_l = len(vals)
    n_r = n_l // 2
    buckets = max(8, n_l // 8)
    lk, rk = vals % buckets, vals[n_l - n_r:] % buckets
    join = P.Join(None, None, on="k")
    walls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    shapes, stop_recording = record_gadget_shapes()
    t0 = time.perf_counter()
    left = Table.from_arrays(ks, "hg38_l", {"k": lk}, SEED + 40)
    right = Table.from_arrays(ks, "hg38_r", {"k": rk}, SEED + 41)
    walls["encrypt_s"] = sync_s(t0)
    t0 = time.perf_counter()
    li = SortedIndex.build(ks, left, "k")
    walls["left_index_build_s"] = sync_s(t0)
    t0 = time.perf_counter()
    ri = SortedIndex.build(ks, right, "k")
    walls["right_index_build_s"] = sync_s(t0)
    server = QueryServer(ks, left, indexes={"k": li}, batch=BATCH)
    jid = server.submit_join(join, right, right_indexes={"k": ri})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sm = server.run()[jid]
        walls["sort_merge_s"] = sync_s(t0)
    sm_dev = _device_summary(prof, walls["sort_merge_s"])
    del prof
    want = np.argwhere(lk[:, None] == rk[None, :])
    sm_ok = bool(np.array_equal(sm.pairs, want))
    cl, cr = JOIN_CUT
    in_cut = (sm.pairs[:, 0] < cl) & (sm.pairs[:, 1] < cr)
    sm_cut = sm.pairs[in_cut]
    sm_peak = torch.cuda.max_memory_allocated()
    index_build_compares = [li.build_compares, ri.build_compares]

    # ---- nested loops on the cut: gadget (shared grid, shards), paper ----
    lcut = Table.from_ciphertexts("hg38_l_cut", {"k": left.gather(
        "k", np.arange(cl))}, cl)
    rcut = Table.from_ciphertexts("hg38_r_cut", {"k": right.gather(
        "k", np.arange(cr))}, cr)
    del left, right, li, ri, server
    gc.collect()
    torch.cuda.empty_cache()
    want_cut = np.argwhere(lk[:cl, None] == rk[None, :cr])
    nested = QueryServer(ks, lcut, batch=BATCH)
    j1 = nested.submit_join(join, rcut, strategy="nested")
    j2 = nested.submit_join(join, rcut, strategy="nested")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nres = nested.run()
        walls["nested_gadget_s"] = sync_s(t0)
    nested_dev = _device_summary(prof, walls["nested_gadget_s"])
    del prof
    b = nested.batch_log[0]
    nested_ok = bool(np.array_equal(nres[j1].pairs, want_cut)
                     and np.array_equal(nres[j2].pairs, want_cut)
                     and np.array_equal(sm_cut, want_cut))
    tiles = cl // J._grid_tile(J._resolve_block_pairs(None), cl, cr)
    t0 = time.perf_counter()
    sl = db.ShardedTable.from_table(ks, lcut,
                                    spec=db.ShardSpec.create(SHARDS))
    sr = db.ShardedTable.from_table(ks, rcut,
                                    spec=db.ShardSpec.create(SHARDS))
    sharded = db.execute_join(ks, sl, sr, join, strategy="nested")
    walls["nested_sharded_s"] = sync_s(t0)
    del sl, sr
    sharded_ok = bool(np.array_equal(sharded.pairs, nres[j1].pairs))
    t0 = time.perf_counter()
    pl = Table.from_arrays(wks, "hg38_l_cut", {"k": lk[:cl]}, SEED + 42)
    pr = Table.from_arrays(wks, "hg38_r_cut", {"k": rk[:cr]}, SEED + 43)
    walls["encrypt_paper_cut_s"] = sync_s(t0)
    t0 = time.perf_counter()
    paper = db.execute_join(wks, pl, pr, join, strategy="nested")
    walls["nested_paper_s"] = sync_s(t0)
    paper_ok = bool(np.array_equal(paper.pairs, want_cut))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    stop_recording()
    peak = torch.cuda.max_memory_allocated()
    path_shapes = check_gadget_shapes(ks, lcut.column("k"), shapes,
                                      SEED + 46, rate)

    def stats(r):
        s = r.stats
        return {"eval_calls": s.eval_calls, "pair_compares": s.pair_compares,
                "merge_compares": s.merge_compares,
                "adjacency_compares": s.adjacency_compares,
                "verify_compares": s.verify_compares,
                "build_compares": s.build_compares,
                "join_compares": s.join_compares, "pairs": len(r)}
    out = {
        "phase": "join", "profile": PROFILE, "buckets": buckets,
        "rows": [n_l, n_r], "cut": list(JOIN_CUT),
        "sort_merge": {"exact": sm_ok, **stats(sm),
                       "index_build_compares": index_build_compares,
                       "peak_mem_bytes": sm_peak, "device": sm_dev},
        "nested_gadget": {"exact": nested_ok, **stats(nres[j1]),
                          "batch_joins": b.joins,
                          "grid_evals": b.grid_evals,
                          "grid_pair_compares": b.pair_compares,
                          "device": nested_dev},
        "nested_sharded": {"exact": sharded_ok, **stats(sharded),
                           "shards": list(sharded.stats.shards)},
        "nested_paper": {"exact": paper_ok, **stats(paper)},
        "walls": walls, "launches": launches, "peak_mem_bytes": peak,
        "gadget_shapes": path_shapes,
    }
    emit(out)
    require(sm_ok, "the sort-merge join's pairs differ from the plaintext")
    require(nested_ok, "the nested cut's pairs differ (plaintext/sort-merge)")
    require(b.grid_evals == tiles,
            f"two joins launched {b.grid_evals} grid tiles, not {tiles}")
    require(sharded_ok, "the sharded nested join's pairs differ")
    require(paper_ok, "the paper-mode nested cut's pairs differ")
    require(path_shapes["equal"], "the gadget Eval != plain at a join path "
            f"shape: {path_shapes['shapes']}")
    require(all(launches[k] > 0 for k in JOIN_KERNELS),
            f"a kernel never launched on the join path: {launches}")
    return lcut, rcut, pl, pr, out


def phase_layouts(ks, wks, lcut, rcut, pl, pr, rate) -> dict:
    """The join's kernel layouts against their plain versions on the cut
    tables: the gadget pair-grid tile (the negated right column against
    T negated left atoms), a tile whose digits are all those of q - 1,
    and the paper Eval's column form over each side."""
    import torch
    from repro_torch.core import ring as R
    from repro_torch.core import sampling
    from repro_torch.db import join as J
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    params, ring = ks.params, ks.ring
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    lb, qs = params.profile.gadget_log_base, ring.q_arr[:, 0]
    cl, cr = JOIN_CUT
    T = J._grid_tile(J._resolve_block_pairs(None), cl, cr)
    lct, rct = lcut.column("k"), rcut.column("k")
    grid = KO.PairGrid(ks, lct, rct)
    lo = cl - T
    b0, b1 = R.neg(ring, lct.c0[lo:]), R.neg(ring, lct.c1[lo:])
    zeros = [0] * T

    def ev(kernel, uniq, sel, bnd0, bnd1, rows):
        args = (uniq.c0, uniq.c1, 0, rows, sel, bnd0, bnd1, ks.cek_rev, qs,
                params.scale, lb)
        if kernel:
            return CK.eval_coeff0_gadget(*args, cek_bytes=ks.cek_rev_bytes)
        return CK.eval_coeff0_gadget_plain(*args)
    neg_r = grid.neg_right
    cases = {}
    got = ev(True, neg_r, zeros, b0, b1, cr)
    want = ev(False, neg_r, zeros, b0, b1, cr)
    cases["pair tile"] = (got, want)
    # d = l - r = q - 1 on every coefficient: right rows all c, left c - 1
    gen = sampling.make_generator(SEED + 44, ks.device)
    c = sampling.uniform_poly(params, gen, (2, 1))
    rc0, rc1 = c[0].expand(cr, K, n).contiguous(), c[1].expand(
        cr, K, n).contiguous()
    q = ring.q_arr
    top = type(lct)(R.neg(ring, rc0)[None], R.neg(ring, rc1)[None])
    t0_ = R.neg(ring, ((c[0] - 1) % q).expand(T, K, n).contiguous())
    t1_ = R.neg(ring, ((c[1] - 1) % q).expand(T, K, n).contiguous())
    cases["q - 1 digits"] = (ev(True, top, zeros, t0_, t1_, cr),
                             ev(False, top, zeros, t0_, t1_, cr))
    pargs = (wks.cek_rev, wks.ring.q_arr[:, 0], wks.params.scale)
    for name, ct in (("paper column left", pl.column("k")),
                     ("paper column right", pr.column("k"))):
        cases[name] = (CK.eval_coeff0_paper(ct.c0, ct.c1, *pargs),
                       CK.eval_coeff0_paper_plain(ct.c0, ct.c1, *pargs))
    eq, errs = True, {}
    torch.cuda.synchronize()
    for name, (g, w) in cases.items():
        eq &= torch.equal(g, w)
        errs[name] = max_abs_err(g, w)
    grid_eq = bool(torch.equal(grid.tile(lo, T),
                               R.crt_centered(params, want)))
    del cases, got
    pl_ct, pr_ct = pl.column("k"), pr.column("k")
    out = {
        "phase": "layouts", "tolerance": 0, "equal": bool(eq and grid_eq),
        "max_abs_err": max(errs.values()), "cases": errs,
        "pair_tile": {"layout": "negated right column x negated left atoms",
                      "atoms": T, "rows": cr,
                      "ms": time_cuda(lambda: ev(True, neg_r, zeros, b0, b1,
                                                 cr), 20),
                      "plain_ms": time_cuda(lambda: ev(False, neg_r, zeros,
                                                       b0, b1, cr), 1),
                      "tile_ms": time_cuda(lambda: grid.tile(lo, T), 20),
                      **eval_bound(T, cr, K, n, D, False, rate)},
        "paper_column": [{"rows": int(ct.c0.shape[0]),
                          "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                              ct.c0, ct.c1, *pargs), 10),
                          "plain_ms": time_cuda(
                              lambda: CK.eval_coeff0_paper_plain(
                                  ct.c0, ct.c1, *pargs), 1),
                          **paper_bound(int(ct.c0.shape[0]), K, n, False, 0,
                                        rate)}
                         for ct in (pl_ct, pr_ct)],
    }
    emit(out)
    require(eq and grid_eq, f"a join layout != plain (|err| {errs})")
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
    keymul = phase_keymul(ks, table, rate)
    del table, reqs                 # free the gadget table for the write path
    gc.collect()
    torch.cuda.empty_cache()
    wks, wtable, write = phase_write(dev, vals)
    paper = phase_paper(wks, wtable, write, rate)
    del wtable                      # and the write table for the shard path
    gc.collect()
    torch.cuda.empty_cache()
    shard = phase_shard(ks, vals, rate)
    gc.collect()
    torch.cuda.empty_cache()
    *cut, join = phase_join(ks, wks, vals, rate)
    layouts = phase_layouts(ks, wks, *cut, rate)
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          **{k: serve[k] for k in ("correct", "keygen_s", "encrypt_s",
                                   "serve_wall_s", "queries_per_s",
                                   "peak_mem_bytes")},
          "write": {k: write[k] for k in ("inserts_per_s", "exact",
                                          "scan_correct", "walls",
                                          "peak_mem_bytes")},
          "shard": {k: shard[k] for k in ("correct", "topk_ok",
                                          "scan_ratio", "merge_compares",
                                          "walls", "peak_mem_bytes")},
          "join": {"walls": join["walls"],
                   "peak_mem_bytes": join["peak_mem_bytes"],
                   **{k: join[k]["exact"] for k in (
                       "sort_merge", "nested_gadget", "nested_sharded",
                       "nested_paper")}},
          "layouts_equal": layouts["equal"]})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = "src/repro_torch/kernels/csrc"
    ev, mul = kern["eval"], kern["mul"]
    tile = ev["served_tiles"][0]          # the first batch's tile shape
    lanes = paper["lanes"]                # the sort stage shape

    def row(name, source, replaces, path, launches, err, t):
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": path["launches"][launches],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}
    emit({"kernels": [
        row("eval_coeff0_gadget", "cmp_eval.cu",
            "src/repro/kernels/cmp_eval.py:48", serve, "eval_coeff0_gadget",
            ev["max_abs_err"], tile),
        row("negacyclic_mul_ntt", "ntt.cu", "src/repro/kernels/ntt.py:81",
            serve, "negacyclic_mul_ntt", mul["max_abs_err"], mul["key_ntt"]),
        row("negacyclic_mul", "ntt.cu", "src/repro/kernels/ntt.py:81",
            serve, "negacyclic_mul", mul["max_abs_err"], mul["var"]),
        row("eval_coeff0_paper", "cmp_eval.cu",
            "src/repro/kernels/cmp_eval.py:35", write, "eval_coeff0_paper",
            paper["max_abs_err"], lanes),
        row("ntt_br_fwd", "ntt.cu", "src/repro/kernels/ntt.py:68", keymul,
            "ntt_br_fwd", keymul["max_abs_err"], keymul["fwd"]),
        row("ntt_br_inv", "ntt.cu", "src/repro/kernels/ntt.py:75", keymul,
            "ntt_br_inv", keymul["max_abs_err"], keymul["inv"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
