"""The control of `correct`, on the card: for each seed, one run of the
cell (set-up, a window, the drain), then its reads judged twice, once
with the program's answers and once with the control's in their place
(the reference one bit coarser, `hbench.reference.coarsen`).  The
control has to fail where the program passes.

    python3 hades_bench/control.py --workload hg38-bfv.scan \
        --seeds 11,12,13 --seconds 5

One JSON line a seed: {"seed", "program": checks, "control": checks};
every seed runs in this one process, one after the other.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.pop("REPRO_OBS", None)
sys.path[:0] = [str(ROOT / "src"), str(HERE)]


def main(argv) -> int:
    import torch

    from hbench import cli
    from hbench.reference import Reference, control_answers, judge
    from hbench.spec import Bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, each one run")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    device = torch.device("cuda", 0)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        cell, win, back = cli.measure(bench, args.workload, seed,
                                      args.seconds, False, device, t_start)
        reads = win.reads + [back]
        base, inserts = cell.column.values, cell.insert_rows
        cell.free()
        gc.collect()
        torch.cuda.empty_cache()
        ref = Reference(base, inserts)
        program = judge(reads, win.writes, ref)
        control = judge(reads, win.writes, ref, answers=control_answers(
            reads, base, inserts, cell.column.step))
        print(json.dumps({"seed": seed, "reads": len(reads),
                          "setup_s": win.setup_s, "program": program,
                          "control": control}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
