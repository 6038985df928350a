"""Assemble the dry-run's tables from artifacts/dryrun/*.json.

The port of `repro.launch.report`, for the H100 meshes (32 x 8 and
2 x 32 x 8).  Every figure in the tables is an ESTIMATE from a traced
program (`launch/dryrun.py`), not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.report [--art DIR] [--out DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

MESHES = ("32x8", "2x32x8")
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k",
               "cmp_64k", "cmp_256k", "cmp_256k_c32", "cmp_1m")


def load(art_dir: str):
    recs = {}
    mtimes = {}
    for f in glob.glob(os.path.join(art_dir, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        arch = r["arch"].replace("-", "_")
        if arch == "hades_cmp":
            arch = "hades-cmp"
        r["arch"] = arch
        key = (arch, r["shape"], r["mesh"])
        mt = os.path.getmtime(f)
        if key not in recs or mt > mtimes[key]:     # newest wins
            recs[key] = r
            mtimes[key] = mt
    return recs


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs, mesh="32x8") -> str:
    lines = [
        "| arch | shape | mem GiB/dev | compute | memory | collective | "
        "dominant | MODEL/traced | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({a for a, _, _ in recs})
    for arch in archs:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh))
            if r is None:
                continue
            if r["status"] == "skip":
                lines.append(f"| {arch} | {shape} | — | — | — | — | "
                             f"SKIP (sub-quadratic rule) | — | — |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            ro = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | "
                f"{r['memory']['peak_per_device_gib']:.2f} | "
                f"{fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} | "
                f"{fmt_s(ro['collective_s'])} | {ro['dominant']} | "
                f"{ro['useful_ratio']:.3f} | {ro['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | mem GiB/dev | GFLOP/dev | "
        "coll MB/dev | trace s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mesh) in sorted(recs):
        r = recs[(arch, shape, mesh)]
        if r["status"] == "ok":
            coll = sum(r["collectives"].values()) / 1e6
            lines.append(
                f"| {arch} | {shape} | {mesh} | ok | "
                f"{r['memory']['peak_per_device_gib']:.2f} | "
                f"{r['cost']['flops']/1e9:.0f} | {coll:.0f} | "
                f"{r.get('memfit_compile_s', 0):.0f} |")
        else:
            lines.append(f"| {arch} | {shape} | {mesh} | {r['status']} | "
                         f"— | — | — | — |")
    return "\n".join(lines)


def summary(recs) -> str:
    n_ok = sum(r["status"] == "ok" for r in recs.values())
    n_skip = sum(r["status"] == "skip" for r in recs.values())
    n_err = sum(r["status"] == "error" for r in recs.values())
    doms = defaultdict(int)
    for r in recs.values():
        if r["status"] == "ok" and r["mesh"] == MESHES[0]:
            doms[r["roofline"]["dominant"]] += 1
    return (f"cells: {n_ok} ok, {n_skip} skip, {n_err} error; "
            f"single-pod dominant terms: {dict(doms)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun")
    ap.add_argument("--out", default="artifacts")
    args = ap.parse_args(argv)
    recs = load(args.art)
    print(summary(recs))
    os.makedirs(args.out, exist_ok=True)
    for mesh in MESHES:
        with open(os.path.join(args.out, f"roofline_{mesh}.md"), "w") as f:
            f.write(roofline_table(recs, mesh))
    with open(os.path.join(args.out, "dryrun_table.md"), "w") as f:
        f.write(dryrun_table(recs))
    print("tables written to", args.out)


if __name__ == "__main__":
    main()
