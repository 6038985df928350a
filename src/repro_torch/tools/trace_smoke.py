"""Trace smoke: one traced QueryServer batch must export a valid Chrome
trace.

The port of `tools/trace_smoke.py`, with every structural check it
makes.  Runs a small encrypted table through a batched `QueryServer`
drain under `obs.tracing()`, checks the answers against the plaintext,
then fails loudly unless:

  * the export is structurally valid Chrome-trace JSON — every event
    carries `ph` / `ts` / `pid` (checked event by event here, on top of
    `obs.validate_chrome_trace`);
  * the spans the batch MUST produce are present: the batch span, the
    fused raw-eval launch, and the index binary search;
  * the server runs with a deliberately tiny `lane_budget`, so the
    fused scan splits into lane tiles — every `executor.eval_tile`
    span must nest under an `executor.fused_eval` parent, and hold its
    three phases `executor.tile_launch`, `executor.tile_wait` and
    `executor.tile_copy`, in that order;
  * the export is stamped in Unix µs (the clock of `torch.profiler`'s
    traces): every event lies between the Unix times read before and
    after the traced drain;
  * per-query compare lanes reconcile exactly with the batch totals.

The trace lands at --out (default trace_smoke.json).

Usage:  PYTHONPATH=src python -m repro_torch.tools.trace_smoke \\
            [--device cpu] [--out trace.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch import db, obs
from repro_torch.core import encrypt as E
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.core.ring import resolve_device


# the phases of every executor.eval_tile span, in order
TILE_PHASES = ("executor.tile_launch", "executor.tile_wait",
               "executor.tile_copy")


def run(argv=None) -> dict:
    """Run the traced batch and validate it: {"errors": [...], "events",
    "batch", "launches"}; the trace is written to --out."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--out", default="trace_smoke.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ks = keygen(make_params("test-bfv", mode="gadget"), 0, device=dev)
    vals = np.array([3, 14, 15, 9, 26, 5, 35, 8, 97, 93, 23, 84], np.int64)
    aux = np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3], np.int64)
    table = db.Table.from_arrays(ks, "smoke", {"v": vals, "a": aux}, 1)
    idx = db.SortedIndex.build(ks, table, "v")   # "a" stays unindexed

    def enc(v, s):
        return E.encrypt(ks, int(v), s)

    # one batch mixing indexed lanes ("v") and a fused-scan atom: both
    # launch kinds must show up in the trace.  lane_budget=8 forces the
    # 16-wide fused scan into 2 tiles so the tile spans are exercised.
    server = db.QueryServer(ks, table, indexes={"v": idx}, batch=3,
                            lane_budget=8)
    qids = [server.submit(db.Range("v", enc(5, 2), enc(30, 3))),
            server.submit(db.Eq("a", enc(2, 4))),    # unindexed -> scan
            server.submit(db.Query(where=db.Range("v", enc(3, 5),
                                                  enc(95, 6)),
                                   top_k=db.TopK("v", 3)))]
    unix_lo = time.time_ns() / 1e3
    with obs.tracing() as tr:
        results = server.run()
        spans = list(tr.spans)
        unix_hi = time.time_ns() / 1e3
        tr.write_chrome_trace(args.out)

    errors = []

    # the answers against the plaintext
    wants = [(vals >= 5) & (vals <= 30), aux == 2]
    for qid, want in zip(qids, wants):
        if not np.array_equal(results[qid].mask, want):
            errors.append(f"query {qid}: mask != the plaintext")
    in_range = vals[(vals >= 3) & (vals <= 95)]
    if vals[results[qids[2]].row_ids].tolist() != sorted(
            in_range.tolist(), reverse=True)[:3]:
        errors.append("top-3 != the plaintext")

    # tile spans must NEST under the fused launch: the lane tiling is a
    # refinement of executor.fused_eval, not a sibling of it
    by_sid = {s.sid: s for s in spans}
    tiles = [s for s in spans if s.name == "executor.eval_tile"]
    if len(tiles) < 2:
        errors.append(f"lane_budget=8 on a 16-wide scan must produce "
                      f">=2 executor.eval_tile spans, got {len(tiles)}")
    for s in tiles:
        parent = by_sid.get(s.parent_sid)
        if parent is None or parent.name != "executor.fused_eval":
            errors.append(
                f"executor.eval_tile span (sid={s.sid}) not nested under "
                f"executor.fused_eval (parent="
                f"{parent.name if parent else None})")
        phases = [k.name for k in tr.children(s)]
        if phases != list(TILE_PHASES):
            errors.append(f"executor.eval_tile span (sid={s.sid}) holds "
                          f"{phases}, not {list(TILE_PHASES)}")

    with open(args.out) as f:
        doc = json.load(f)
    errors += obs.validate_chrome_trace(doc)
    events = doc.get("traceEvents", [])
    for i, ev in enumerate(events):
        for field in ("ph", "ts", "pid"):
            if field not in ev:
                errors.append(f"event {i} missing {field!r}: {ev}")
        # a slack of 1 ms for the clock pair's own reads
        if not unix_lo - 1e3 <= ev.get("ts", 0) <= unix_hi + 1e3:
            errors.append(f"event {i} at {ev.get('ts')} µs lies outside "
                          f"the drain's Unix time [{unix_lo}, {unix_hi}]")

    names = {ev.get("name") for ev in events}
    for must in ("server.batch", "index.search", "executor.fused_eval"):
        if must not in names:
            errors.append(f"required span {must!r} absent from trace")

    b = server.batch_log[-1]
    per_q = sum(results[q].stats.index_compares for q in qids)
    if per_q != b.index_compares:
        errors.append(f"per-query index compares {per_q} != "
                      f"batch total {b.index_compares}")
    per_s = sum(results[q].stats.scan_compares for q in qids)
    if per_s != b.scan_compares:
        errors.append(f"per-query scan compares {per_s} != "
                      f"batch total {b.scan_compares}")
    return {"errors": errors, "events": len(events), "out": args.out,
            "batch": {"queries": b.queries, "eval_calls": b.eval_calls,
                      "index_compares": b.index_compares,
                      "scan_compares": b.scan_compares}}


def main(argv=None) -> int:
    """Run the traced batch; print each failure; 0 only if none."""
    res = run(argv)
    for e in res["errors"]:
        print(f"FAIL {e}")
    if res["errors"]:
        return 1
    b = res["batch"]
    print(f"trace smoke passed: {res['events']} events -> {res['out']} "
          f"(batch: {b['queries']} queries, {b['eval_calls']} fused launch, "
          f"{b['index_compares']} probe + {b['scan_compares']} scan lanes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
