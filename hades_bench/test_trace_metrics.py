"""The readers of the program's phase spans and counters, on synthetic
traced windows (no program, no card): each reads what its entry says,
and returns None where its spans or counters are absent, as in a
window of a program that does not make them."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from hbench.cell import Window  # noqa: E402
from hbench.spec import Bench  # noqa: E402

BENCH = Bench(HERE.parent)
NEW = ("server.combine_ms.hg38-bfv.scan", "server.combine_ms.hg38-ckks.scan",
       "executor.tile_host_ms.hg38-bfv.scan",
       "executor.tile_host_ms.hg38-ckks.scan", "index.delta_build_ms",
       "index.probe_host_ms", "write.fold_ms", "write.compact_gib",
       "write.compact_mallocs")


def window(spans=None, counters=None) -> Window:
    return Window(0.0, 30.0, [], [], [], [], 32, spans=spans,
                  counters=counters)


def read(name, win):
    return BENCH.reader(name)(win)


SPANS = [
    ("server.batch", 0.0, 0.060), ("server.combine", 0.040, 0.058),
    ("server.batch", 1.0, 1.050), ("server.combine", 1.030, 1.044),
    ("executor.eval_tile", 0.0, 0.004), ("executor.tile_launch", 0.0, 0.001),
    ("executor.tile_wait", 0.001, 0.003), ("executor.tile_copy", 0.003,
                                           0.004),
    ("executor.eval_tile", 0.1, 0.105), ("executor.tile_launch", 0.1, 0.1005),
    ("executor.tile_wait", 0.1005, 0.1035),
    ("executor.tile_copy", 0.1035, 0.105),
    ("delta.index_build", 2.0, 2.02), ("delta.index_sort", 2.0, 2.016),
    ("delta.index_sort", 3.0, 3.010),
    ("index.search", 4.0, 4.01), ("index.probe_step", 4.0, 4.002),
    ("index.probe_wait", 4.0015, 4.002), ("index.probe_step", 4.002, 4.005),
    ("index.probe_wait", 4.004, 4.005),
    ("compact", 5.0, 6.0), ("compact.fold", 5.9, 5.98),
    ("compact", 7.0, 8.0), ("compact.fold", 7.9, 7.94),
]
COUNTERS = {
    "compact.runs": 2,
    "compact.bytes{phase=delta_index}": 14 * 2**30,
    "compact.bytes{phase=pad_blocks}": 20 * 2**30,
    "compact.bytes{phase=merge_index}": 544 * 2**30,
    "compact.bytes{phase=fold}": 20 * 2**30,
    "mem.cuda_mallocs{span=compact}": 3,
    "mem.cuda_mallocs{span=server.mutation}": 40,
}


def test_new_entries_have_readers_and_cells():
    per_layer = {m["name"]: m for m in BENCH.doc["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert callable(BENCH.reader(name))
        # a split name is read in its own cell, the others in ingest's
        cell = name.split(".", 2)[2] if name.count(".") > 1 \
            else "hg38-bfv.ingest"
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("name,want", [
    ("server.combine_ms.hg38-bfv.scan", 16.0),           # (18 + 14) / 2
    ("server.combine_ms.hg38-ckks.scan", 16.0),
    ("executor.tile_host_ms.hg38-bfv.scan", 2.0),        # (1+1 + .5+1.5) / 2
    ("executor.tile_host_ms.hg38-ckks.scan", 2.0),
    ("index.delta_build_ms", 13.0),                      # (16 + 10) / 2
    ("index.probe_host_ms", 1.75),                       # (2-.5 + 3-1) / 2
    ("write.fold_ms", 60.0),                             # (80 + 40) / 2
    ("write.compact_gib", 299.0),                        # 598 GiB / 2 runs
    ("write.compact_mallocs", 1.5),                      # 3 / 2 runs
])
def test_reader_reads_the_window(name, want):
    assert read(name, window(SPANS, COUNTERS)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_returns_none_without_its_spans(name):
    # untraced; traced with none of the new spans or counters (a program
    # without them: the parent's spans and `compact.runs` only)
    old = [s for s in SPANS if s[0] in ("server.batch", "executor.eval_tile",
                                        "delta.index_build", "index.search",
                                        "compact")]
    assert read(name, window()) is None
    assert read(name, window(old, {"compact.runs": 2})) is None
    assert read(name, window([], {})) is None
