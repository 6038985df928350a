"""One run of one cell: set-up, the measured window, the drain, the
comparison with the reference, and the result line.

    python3 hades_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The run needs the cards its cell asks for: without them it prints no
result and exits with 2.  With `--trace 0` the line's metrics are the
cell's end-to-end metrics, measured with the program's tracing off; with
`--trace 1` its per-layer metrics, from `obs` spans and counters, the
wrapped kernel calls and `torch.profiler`'s device trace.  After the
window it exits with 3 and prints no result if a module of JAX or of the
JAX package was loaded.  The numbers that decide `correct` come last on
standard error and last in the line, each beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

# top-level module names the port and the harness must never load
FOREIGN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def foreign_modules(names) -> list:
    """The FOREIGN top-level names among module names `names`, compared
    whole (`repro_torch` is not `repro`)."""
    return sorted({n.split(".")[0] for n in names} & set(FOREIGN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(checks: dict, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown=None) -> dict:
    """The run's last line; `checks` ({name: [number, limit]}) comes
    last."""
    from hbench.reference import is_correct
    line = {"correct": is_correct(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def traced_window(cell, seconds: float, peaks):
    """The window under `obs.tracing`, the kernel-call recorder and the
    profiler (device activity only; on a CPU, whose trace holds no
    device events, host activity)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    from hbench.devtrace import DeviceTrace, KernelWork

    act = (ProfilerActivity.CUDA if cell.device.type == "cuda"
           else ProfilerActivity.CPU)
    with obs.tracing() as tracer, KernelWork(peaks) as work, profile(
            activities=[act]) as prof:
        offset_ns = time.time_ns() - time.perf_counter_ns()
        win = cell.window(seconds)
    win.spans = [(s.name, s.t0, s.t1) for s in tracer.spans]
    win.counters = obs.REGISTRY.snapshot()
    win.kernels = work
    win.device = DeviceTrace.from_profiler(prof)
    win.offset_ns = offset_ns
    return win


def measure(bench, name: str, seed: int, seconds: float, trace: bool,
            device, t_start: float):
    """Set up the cell, run its window, drain; returns (cell, window,
    read-back record).  The window's peak memory counts from its open."""
    import torch

    from hbench import roofline
    from hbench.cell import Cell

    wl = bench.workload(name)
    cell = Cell(bench.config(wl["config"]), bench.traffic(wl["traffic"]),
                seed, device)
    cell.setup()
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        peaks = roofline.PEAKS.get(torch.cuda.get_device_name(device)
                                   if cuda else "")
        win = traced_window(cell, seconds, peaks)
    else:
        win = cell.window(seconds)
    if cuda:
        win.peak_bytes = torch.cuda.max_memory_allocated(device)
        win.run_peak_bytes = max(setup_peak, win.peak_bytes)
    win.setup_s = setup_s
    cell.clients.drain()
    back = cell.read_back()
    return cell, win, back


def judge_run(cell, win, back) -> dict:
    """The program's numbers against the reference."""
    from hbench.reference import Reference, judge
    ref = Reference(cell.column.values, cell.insert_rows)
    return judge(win.reads + [back], win.writes, ref)


def read_metrics(bench, name: str, win, trace: bool) -> dict:
    out = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"])(win)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(win) -> dict:
    dev = win.device
    return {"device_ops": dev.top_ops(10),
            "idle_gaps": dev.idle_gaps(win.spans, win.offset_ns, 10)}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    from pathlib import Path

    import torch

    from repro_torch import obs

    from hbench.spec import Bench

    obs.disable()
    bench = Bench(Path(__file__).resolve().parents[2])
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell, win, back = measure(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, t_start)
    metrics = read_metrics(bench, args.workload, win, bool(args.trace))
    extra = breakdown(win) if args.trace else None
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": win.run_peak_bytes}
    if args.trace:
        dev["busy_s"] = win.device.busy_s
        dev["window_s"] = win.seconds
    attempted = len(win.reads) + len(win.writes)
    failed = sum(r.status != "OK" for r in win.reads + win.writes)
    # the program's state goes before the reference runs
    cell.free()
    gc.collect()
    torch.cuda.empty_cache()
    checks = judge_run(cell, win, back)
    found = foreign_modules(sys.modules)
    if found:
        print(f"loaded modules of {found}: the port and the harness must "
              "not import JAX or the JAX package", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result_line(checks, attempted, failed, metrics, dev,
                                 extra)))
    return 0
