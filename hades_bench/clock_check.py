"""One traced run of a cell, read for what the result line leaves out:
the traced window's read throughput, and the check of the span clock
against the profiler's.

    python3 hades_bench/clock_check.py --workload hg38-bfv.scan \
        --seed 7 --seconds 30 [--out build/clock.json]

The run is `run.py --trace 1`'s (set-up, the traced window, the drain,
the judgement, the per-layer metrics and the breakdown).  Where the
program keeps launch records (`obs.Tracer.launches`), each Eval and key
multiply launch of the window is paired with its kernel's device event
(`obs.match_launches`), and the line gives each kernel's records and
pairs, and the smallest and median lead from the C call to the kernel's
start in the window's first and last 5 s; and the span clock's Unix
offset at every clock pair the program read (`Tracer.clock_pairs`)
against the one offset the harness read at the window's open; and the
records against the profiler's own host events of the CUDA runtime
calls that launched them (`"runtime"`).  A program without them gives
`"clock": null`.  Last, where the profiler's exported file puts a
kernel against the span that waited for it (`"profiler_export"`).  One
JSON line; the same line to `--out`.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.pop("REPRO_OBS", None)
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

# the kernels whose every launch must find its device event
CHECKED = ("eval_coeff0_gadget", "negacyclic_mul_ntt")
EDGE_NS = 5 * 10**9


def _by_second(pairs: list, t0_ns: int) -> list:
    """[[second of the window, n, smallest, median (µs)]] of (Unix ns,
    value ns) pairs."""
    out: dict = {}
    for t, v in pairs:
        out.setdefault(int((t - t0_ns) // 10**9), []).append(v)
    return [[k, len(v), min(v) / 1e3, statistics.median(v) / 1e3]
            for k, v in sorted(out.items())]


def _leads(matches: list) -> dict:
    leads = [m["lead_ns"] for m in matches]
    if not leads:
        return {"n": 0}
    return {"n": len(leads), "min_us": min(leads) / 1e3,
            "median_us": statistics.median(leads) / 1e3}


def clock(obs, win) -> dict:
    """The launch match and the clock offsets of the traced window."""
    tr = obs.get_tracer()
    records = list(tr.launches)
    matches = obs.match_launches(records, win.device.events)
    kernels = {}
    for k in sorted({r.kernel for r in records}):
        kernels[k] = {"records": sum(r.kernel == k for r in records),
                      "paired": sum(m["kernel"] == k for m in matches)}
    lo, hi = tr.to_unix_ns(win.t0), tr.to_unix_ns(win.t1)
    first = [m for m in matches if m["call_ns"] < lo + EDGE_NS]
    last = [m for m in matches if m["call_ns"] > hi - EDGE_NS]
    offsets = [u - p - win.offset_ns for p, u in tr.clock_pairs]
    host = {}
    for r in records:
        host.setdefault(r.kernel, []).append(r.host_s * 1e6)
    for k in kernels:
        sym = next(r.symbol for r in records if r.kernel == k)
        kernels[k]["events"] = sum(sym in e[0] for e in win.device.events)
    return {
        "kernels": kernels,
        "lead_by_second": _by_second(
            [(m["call_ns"], m["lead_ns"]) for m in matches], lo),
        "all_checked_paired": all(
            v["records"] == v["paired"] for k, v in kernels.items()
            if k in CHECKED),
        "negative_leads": sum(m["lead_ns"] < 0 for m in matches),
        "leads_all": _leads(matches),
        "leads_first_5s": _leads(first), "leads_last_5s": _leads(last),
        "min_lead_shift_us": (
            (min(m["lead_ns"] for m in last)
             - min(m["lead_ns"] for m in first)) / 1e3
            if first and last else None),
        "pairs": len(tr.clock_pairs),
        "offset_vs_harness_us": {
            "first": offsets[0] / 1e3, "last": offsets[-1] / 1e3,
            "min": min(offsets) / 1e3, "max": max(offsets) / 1e3},
        "wrapper_host_us": {k: {"median": statistics.median(v),
                                "max": max(v)}
                            for k, v in sorted(host.items())},
    }


def span_table(win) -> dict:
    """{span name: [count, summed s, mean ms]} of the traced window."""
    out: dict = {}
    for name, t0, t1 in win.spans:
        out.setdefault(name, []).append(t1 - t0)
    return {k: [len(v), sum(v), 1e3 * sum(v) / len(v)]
            for k, v in sorted(out.items())}


class _KeptProfile:
    """Keeps the last `torch.profiler.profile` entered (the harness's
    traced window makes its own)."""
    last = None

    @classmethod
    def install(cls) -> None:
        import torch.profiler as tp
        base = tp.profile

        class Kept(base):
            def __enter__(self):
                cls.last = self
                return super().__enter__()
        tp.profile = Kept


def runtime_check(obs, win, prof) -> dict:
    """The launch records against the profiler's own host events: each
    record of a checked kernel paired, in order, with the CUDA runtime
    call that launched a kernel of its symbol (linked to the kernel by
    correlation id).  On one clock the runtime call lies inside the
    record's C call: `before_call_us` (runtime start before the C
    call's start) and `after_return_us` (runtime end after its return)
    are at most 0.  `device_lead` is the kernel's start after its
    runtime call, both on the profiler's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    tr = obs.get_tracer()
    kern, rt = {}, {}
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if not corr:
            continue
        if e.device_type() == cuda:
            kern[corr] = (e.name(), e.start_ns())
        elif e.name().startswith(("cudaLaunch", "cuLaunch")):
            rt[corr] = (e.start_ns(), e.end_ns())
    lo = tr.to_unix_ns(win.t0)
    out = {"runtime_events": len(rt)}
    for k in CHECKED:
        recs = sorted((r for r in tr.launches if r.kernel == k),
                      key=lambda r: r.t_call)
        if not recs:
            continue
        sym = recs[0].symbol
        calls = sorted((rt[c][0], rt[c][1], kern[c][1]) for c in rt
                       if c in kern and sym in kern[c][0])
        before, after, lead = [], [], []
        for rec, (r0, r1, k0) in zip(recs, calls):
            c0, c1 = tr.to_unix_ns(rec.t_call), tr.to_unix_ns(rec.t_ret)
            before.append((c0, c0 - r0))
            after.append((c0, r1 - c1))
            lead.append((c0, k0 - r0))
        out[k] = {"records": len(recs), "runtime_calls": len(calls)}
        if before:
            out[k].update({
                "before_call_us_max": max(v for _, v in before) / 1e3,
                "after_return_us_max": max(v for _, v in after) / 1e3,
                "device_lead_us_min": min(v for _, v in lead) / 1e3,
                "before_call_by_second": _by_second(before, lo),
                "device_lead_by_second": _by_second(lead, lo)})
    return out


def profiler_export(device, obs) -> dict:
    """Where `torch.profiler`'s `export_chrome_trace` puts a kernel, and
    whether it lies inside the `obs` span that waited for it once that
    span is exported on the profiler file's base (`baseTimeNanoseconds`):
    the kernel's `ts`, the span's `ts` and its end (µs), and the Unix µs
    read before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device=device)
    torch.cuda.synchronize(device)
    before = time.time_ns() / 1e3
    with obs.tracing() as tr, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        with obs.span("clock_check.kernel") as sp:
            sp.sync((x * 3).sum())
        torch.cuda.synchronize(device)
    after = time.time_ns() / 1e3
    path = ROOT / "build" / "clock_check_profile.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    ts = [e["ts"] for e in doc.get("traceEvents", [])
          if e.get("cat") == "kernel"]
    out = {"kernels": len(ts), "kernel_ts_us": min(ts) if ts else None,
           "before_us": before, "after_us": after, "base_ns": base,
           "cats": sorted({str(e.get("cat")) for e in doc.get(
               "traceEvents", [])})}
    if hasattr(obs, "match_launches"):
        span, = tr.chrome_trace(base)["traceEvents"]
        out.update(span_ts_us=span["ts"],
                   span_end_us=span["ts"] + span["dur"],
                   inside=bool(ts) and all(
                       span["ts"] <= t <= span["ts"] + span["dur"]
                       for t in ts))
    return out


def main(argv) -> int:
    import torch

    from repro_torch import obs

    from hbench import cli
    from hbench.reference import is_correct
    from hbench.spec import Bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    obs.disable()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    device = torch.device("cuda", 0)
    _KeptProfile.install()
    cell, win, back = cli.measure(bench, args.workload, args.seed,
                                  args.seconds, True, device, T_START)
    line = {"workload": args.workload, "seed": args.seed,
            "kind": torch.cuda.get_device_name(device),
            "window_s": win.seconds,
            "traced_qps": len(win.ok_reads()) / win.seconds,
            "idle_share": 1.0 - win.device.busy_s / win.seconds,
            "metrics": {k: v["value"] for k, v in cli.read_metrics(
                bench, args.workload, win, True).items()},
            "breakdown": cli.breakdown(win), "spans": span_table(win)}
    if hasattr(obs, "match_launches"):
        line["clock"] = clock(obs, win)
        line["runtime"] = runtime_check(obs, win, _KeptProfile.last)
    else:
        line["clock"] = line["runtime"] = None
    cell.free()
    torch.cuda.empty_cache()
    line["profiler_export"] = profiler_export(device, obs)
    checks = cli.judge_run(cell, win, back)
    line["correct"] = is_correct(checks)
    line["checks"] = checks
    text = json.dumps(line)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
