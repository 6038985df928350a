"""Split a kernel wrapper's cost on the GPU: device, host and launch floor.

    python -m repro_torch.kernels.timing [--baseline DIR] [--out PATH]

Three numbers per call of a wrapper, each a mean:

- `device_ms`: launches captured in one CUDA graph and replayed, CUDA
  events around the replays: the kernel's own time, without the host;
- `host_ms`: `time.perf_counter` around calls of the Python wrapper
  issued in batches behind `torch.cuda._sleep`, so the card is busy and
  the host never waits for it (`saturated` says whether the card was
  still busy when each batch ended);
- the launch floor: both of the above for an empty kernel
  (`hades_empty_launch` in `csrc/cmp_eval.cu`) launched through the same
  `ctypes` path.

`events_ms` is the older measure (`chip_smoke.py::time_cuda`: CUDA
events around 3 back-to-back calls), which counts the host wherever it
is slower than the kernel.

Run as a script, it measures the paper Eval (`cmp_eval.eval_coeff0_paper`)
at paper-bfv on seeded random residues at the lane counts and forms the
write, loop and join paths launch it with, and at edge lane counts, each
call held against `eval_coeff0_paper_plain` (`torch.equal`).  With
`--baseline DIR` (the root of another checkout of the repository, such
as `git archive <commit> | tar -x -C build/parent`), that tree's paper
Eval, kernel and wrapper, is built into `DIR/build/kernels` and measured
at the same shapes, in turns: baseline, current, current, baseline.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build

GRAPH_LAUNCHES = 100        # launches captured in one graph
GRAPH_REPLAYS = 5
HOST_CALLS = 1000
HOST_BATCH = 200            # calls behind one sleep: far below the
                            # card's queue of pending launches
SLEEP_CYCLES = 200_000_000  # each batch's sleep on the card: 0.1 s at
                            # 2 GHz, far longer than a batch's host time


def device_ms(fn, launches: int = GRAPH_LAUNCHES,
              replays: int = GRAPH_REPLAYS) -> float:
    """Milliseconds per launch of `fn`: `launches` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # capture on a stream of the current card: torch.cuda.graph's default
    # capture stream is made once, on whichever card was current then
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * launches)


def host_ms(fn, calls: int = HOST_CALLS, batch: int = HOST_BATCH) -> dict:
    """Host milliseconds per call of `fn` with the card busy behind it:
    each batch of calls is issued behind a `torch.cuda._sleep` on the
    card, so no call waits for the device.  Returns {"host_ms", "saturated"}:
    whether the sleep was still running when every batch had been issued."""
    fn()
    torch.cuda.synchronize()
    total, saturated = 0.0, True
    for _ in range(calls // batch):
        torch.cuda._sleep(SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        saturated &= not slept.query()
        torch.cuda.synchronize()
    return {"host_ms": total / (calls // batch * batch) * 1e3,
            "saturated": saturated}


def events_ms(fn, reps: int = 3) -> float:
    """Milliseconds per call by CUDA events around `reps` back-to-back
    calls, after one warm-up (`chip_smoke.py::time_cuda`)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split(fn) -> dict:
    """The three numbers of one wrapper call, and `events_ms`."""
    return {"device_ms": device_ms(fn), **host_ms(fn),
            "events_ms": events_ms(fn)}


def empty_launch(device=None):
    """A callable that launches the empty kernel of `csrc/cmp_eval.cu` on
    the current stream through ctypes, as the wrappers launch theirs."""
    entry = _build.load("cmp_eval").hades_empty_launch
    index = torch.device(device or "cuda").index
    index = torch.cuda.current_device() if index is None else index

    def launch():
        _build.check(entry(_build.stream_handle(index)), "empty launch")
    return launch


def launch_floor(device=None) -> dict:
    """The empty kernel's device and host time per launch."""
    return split(empty_launch(device))


# ---------------------------------------------------------------------------
# the paper Eval at the paths' shapes
# ---------------------------------------------------------------------------

# (name, lanes, rows of b: lanes, 1 (one bound for every lane) or 0
# (column form)) at paper-bfv: the loop's 16 recorded shapes (probe steps
# and merges of 2-128 lanes, sort stages of 32,768 pairs, column passes
# of 64 and 65,536 rows), the write path's (bounds of 8 and 10 atoms,
# 2,048-row delta tiles, 65,536 merge pairs, one bound for every lane),
# the join cut's column passes, and lane counts that are multiples of no
# cluster size
PROFILE = "paper-bfv"
PAPER_SHAPES = (
    *((f"lanes {B}", B, B) for B in (1, 2, 3, 4, 5, 6, 8, 16, 32, 64, 127,
                                      128, 32768, 65536)),
    ("one bound 32768", 32768, 1),
    *((f"column {B}", B, 0) for B in (8, 10, 64, 2048, 4096, 8192, 65536)),
)


def _load_baseline(root: Path):
    """The paper Eval wrapper of the checkout at `root`, bound to that
    checkout's own kernel library (built into `root/build/kernels`)."""
    kdir = root / "src" / "repro_torch" / "kernels"

    def module(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    build = module("baseline_build", kdir / "_build.py")
    build.SOURCES = ("cmp_eval",)
    build.load("cmp_eval")
    ck = module("baseline_cmp_eval", kdir / "cmp_eval.py")
    ck._build = build
    return ck.eval_coeff0_paper


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of another checkout whose paper Eval is "
                         "measured beside this one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("timing: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.params import make_params
    from repro_torch.kernels import cmp_eval as CK

    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            print(line, file=sink, flush=True)

    dev = torch.device("cuda", 0)
    params = make_params(PROFILE, mode="paper")
    K, n = params.num_towers, params.n
    qs = torch.tensor(params.qs, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    top = max(B for _, B, _ in PAPER_SHAPES)

    def residues(*shape):
        u = torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
        return u % qs[:, None]
    cek = residues(K, n)
    pool_a = (residues(top, K, n), residues(top, K, n))
    pool_b = (residues(top, K, n), residues(top, K, n))
    versions = {"current": CK.eval_coeff0_paper}
    order = ["current", "current"]
    if args.baseline is not None:
        versions["baseline"] = _load_baseline(args.baseline.resolve())
        order = ["baseline", "current", "current", "baseline"]
    emit({"floor": launch_floor(dev), "card": _card(),
          "profile": PROFILE})
    summary = {}
    for name, B, b_rows in PAPER_SHAPES:
        a0, a1 = pool_a[0][:B], pool_a[1][:B]
        b0, b1 = ((pool_b[0][:b_rows], pool_b[1][:b_rows]) if b_rows
                  else (None, None))
        want = CK.eval_coeff0_paper_plain(a0, a1, cek, qs,
                                          params.scale, b0, b1)
        for turn, version in enumerate(order):
            wrapper = versions[version]

            def call():
                return wrapper(a0, a1, cek, qs, params.scale, b0, b1)
            equal = bool(torch.equal(call(), want))
            rec = {"shape": name, "lanes": B, "b_rows": b_rows,
                   "version": version, "turn": turn, "equal": equal,
                   **split(call)}
            emit(rec)
            summary.setdefault((name, version), []).append(rec)
        del want
    for (name, version), recs in summary.items():
        emit({"summary": name, "version": version,
              "equal": all(r["equal"] for r in recs),
              **{k: sum(r[k] for r in recs) / len(recs)
                 for k in ("device_ms", "host_ms", "events_ms")}})
    emit({"card": _card()})
    ok = all(r["equal"] for recs in summary.values() for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
