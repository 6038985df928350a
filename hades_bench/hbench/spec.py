"""`BENCHMARK.json` and the files it names, found by name.

A cell's configuration is the file its `configs` entry names; its
traffic is `hades_bench/traffic/<traffic>.json`; each metric, end to end
or per layer, is read by `hades_bench/metrics/<metric name>.py`, a
module with `read(window) -> float | None` (None: nothing to read in
this cell, and the metric is left out of the line).  A quantity split by
cell, so that each cell's has its own bound and moves its own cell's
metric, is named `<quantity>.<cell>` (`qps.hg38-bfv.scan`) and read by
the quantity's file: the longest leading part of the name, up to a dot,
that has one.  A cell, a traffic mix or a metric is added by adding its
file (none for a split quantity) and its entry.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Bench:
    """The benchmark rooted at `root` (the directory of BENCHMARK.json)."""

    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "hades_bench"

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> list:
        """The cell's metric entries: its end-to-end metrics untraced,
        its per-layer metrics traced."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        return [m for m in group if _applies(m, workload)]

    def reader(self, metric: str):
        """The `read` function of the metric's file."""
        parts = metric.split(".")
        for k in range(len(parts), 0, -1):
            path = self.dir / "metrics" / (".".join(parts[:k]) + ".py")
            if path.exists():
                break
        else:
            raise FileNotFoundError(f"no reader for metric {metric!r}")
        spec = importlib.util.spec_from_file_location(
            "hbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
