"""Part 6: watching the engine work — `repro_torch.obs` end to end.

The port of `examples/part6_observability.py`.  One encrypted range
query (linear scan, then through the HADES sorted index) runs under a
trace; the demo checks both against the plaintext and prints the nested
span tree with device-true timings, the counter table the run produced,
the launch-signature observer's sites, and writes a Chrome-trace JSON
you can drop into ui.perfetto.dev.

    PYTHONPATH=src python -m repro_torch.examples.part6_observability
    PYTHONPATH=src python -m repro_torch.examples.part6_observability \\
        --device cpu --rows 2048 --trace-out /tmp/trace.json
"""
import argparse
import time

import numpy as np

from repro_torch import db, obs
from repro_torch.core import encrypt as E
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.core.ring import resolve_device
from repro_torch.data import load_dataset
from repro_torch.examples import check


def main(argv=None) -> dict:
    """Trace one encrypted range query; print spans + counters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--rows", type=int, default=1024,
                    help="hg38 rows to load (0 = all 34,423)")
    ap.add_argument("--trace-out", default="obs_trace.json",
                    help="Chrome-trace JSON output path ('' = skip)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = make_params("test-bfv", mode="gadget")
    ks = keygen(params, 0, device=dev)
    vals = load_dataset("hg38", scheme="bfv", t=params.t).astype(np.int64)
    if args.rows:
        vals = vals[:args.rows]

    print(f"--- setup: {len(vals)} hg38 rows, encrypt + index ---")
    t0 = time.time()
    table = db.Table.from_arrays(ks, "hg38", {"pos": vals}, 1)
    idx = db.SortedIndex.build(ks, table, "pos")
    print(f"table {table.n_rows} rows (padded {table.n_padded}), index "
          f"built with {idx.build_compares} compares ({time.time()-t0:.1f}s)")

    def enc(v, s):
        return E.encrypt(ks, int(v), s)

    lo, hi = int(np.percentile(vals, 40)), int(np.percentile(vals, 60))
    q = db.Range("pos", enc(lo, 2), enc(hi, 3))
    db.execute(ks, table, q)                          # warm-up (untraced)
    db.execute(ks, table, q, indexes={"pos": idx})

    # ---- the traced run: linear scan, then the indexed path -------------
    print(f"\n--- traced: Range[{lo}, {hi}] linear + indexed ---")
    with obs.tracing() as tr:
        with obs.span("demo.linear"):
            lin = db.execute(ks, table, q)
        with obs.span("demo.indexed"):
            ind = db.execute(ks, table, q, indexes={"pos": idx})
    want = (vals >= lo) & (vals <= hi)
    out = {"linear": check(np.array_equal(lin.mask, want), "linear scan"),
           "indexed": check(np.array_equal(ind.mask, want), "indexed")}

    print("\nspan tree (device-true ms):")
    for line in tr.tree_lines():
        print(f"  {line}")

    print("\ncounter table:")
    snap = obs.REGISTRY.snapshot()
    width = max(len(k) for k in snap)
    for name, v in snap.items():
        if isinstance(v, dict):                       # histogram summary
            v = (f"count={v['count']:.0f} p50={v['p50']:.3g} "
                 f"p99={v['p99']:.3g}")
        print(f"  {name:<{width}}  {v}")

    print("\nlaunch-signature observer (signatures per launch site):")
    for site, sigs in obs.jit_signatures().items():
        flag = "" if len(sigs) == 1 else "  <-- RETRACES"
        print(f"  {site}: {len(sigs)} signature(s){flag}")

    f = obs.bench_fields()
    print(f"\nlaunch accounting: {f['eval_launches']} launches, "
          f"{f['compare_lanes']} compare lanes, "
          f"{f['jit_retraces']} retraces")
    print(f"  linear scan:  {lin.stats.scan_compares} compares in "
          f"{lin.stats.eval_calls} fused launch")
    print(f"  indexed path: {ind.stats.index_compares} probe compares "
          f"(binary search, ~2*log2 n)")
    out["spans"] = check(any(s.name == "demo.indexed" for s in tr.spans),
                         "the traced spans")

    if args.trace_out:
        tr.write_chrome_trace(args.trace_out)
        errs = obs.validate_chrome_trace(tr.chrome_trace())
        print(f"\nwrote {args.trace_out} "
              f"(valid Chrome trace: {not errs}) — open at ui.perfetto.dev")
        out["trace_valid"] = check(not errs, f"Chrome trace: {errs}")
    return out


if __name__ == "__main__":
    main()
