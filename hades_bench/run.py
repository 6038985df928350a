"""Run one cell of the benchmark once (see `hbench/cli.py`).

    python3 hades_bench/run.py --workload hg38-bfv.scan --seed 7 \
        --seconds 20 --trace 0

Run from a checkout: it puts the checkout's `src` and this folder on its
path, keeps every cache under the checkout's `build/`, and needs one CUDA
card per chip its cell asks for.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches at fixed paths inside the checkout; host threads kept few
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.pop("REPRO_OBS", None)
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from hbench import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
