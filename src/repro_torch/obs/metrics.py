"""Counters + histograms for the encrypted query engine: the part of
`repro.obs.metrics` that the served and write paths use (the snapshot
view and the join absorber arrive with later slices).

The registry is the aggregation layer OVER the per-call stats
dataclasses (`ExecStats`, `BatchStats`): those stay as cheap always-on
return values, and `absorb_*` folds them into process-wide counters
whenever the observability layer is enabled.  Direct instrumentation (launch
counts, lane totals, ciphertext bytes, pad-waste) lands here too.

All record helpers are gated on `obs.is_enabled()` — one global bool
check when disabled.

Counter glossary:

  eval.launches        batched raw-eval launches (fused-scan tiles,
                       index probe steps)
  eval.lanes           total compare lanes through those launches
  index.probes         encrypted binary-search probe lanes
  bytes.moved          ciphertext bytes entering launches
  jit.retraces         distinct launch signatures beyond the first
                       per site (see jitwatch)
  pad.waste            histogram of n_padded / n_rows per executed plan
  server.batch_wall_s  histogram of drained-batch wall seconds
  server.queries       queries served (label: tenant)
  server.compares      compare lanes attributed per tenant
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple, Union

from repro_torch.obs import trace as _trace


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add `n` (default 1) to the counter."""
        self.value += int(n)


class Histogram:
    """Value distribution: keeps the raw observations (engine
    cardinality is batches, not rows, so the buffer stays small)."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        """Record one observation."""
        self.values.append(float(v))


MetricKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> MetricKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class Registry:
    """Name+labels → Counter/Histogram map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[MetricKey, Union[Counter, Histogram]] = {}

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter `name{labels}`."""
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter()
            return m

    def histogram(self, name: str, **labels) -> Histogram:
        """Get-or-create the histogram `name{labels}`."""
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Histogram()
            return m

    def value(self, name: str, **labels) -> int:
        """Current value of a counter (0 if never touched)."""
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
        return m.value if isinstance(m, Counter) else 0

    def reset(self) -> None:
        """Drop every metric (fresh trace region)."""
        with self._lock:
            self._metrics = {}


REGISTRY = Registry()


def count(name: str, n: int = 1, **labels) -> None:
    """Increment counter `name{labels}` by `n` iff obs is enabled."""
    if not _trace._enabled:
        return
    REGISTRY.counter(name, **labels).inc(n)


def observe(name: str, v: float, **labels) -> None:
    """Record `v` into histogram `name{labels}` iff obs is enabled."""
    if not _trace._enabled:
        return
    REGISTRY.histogram(name, **labels).observe(v)


# -- stats-dataclass absorption -------------------------------------------
#
# The engine's return-value dataclasses are the ground truth for one
# call; these helpers fold them into the process-wide registry so the
# registry supersedes the scattered counters as the aggregate view.

def absorb_exec_stats(stats, **labels) -> None:
    """Fold one `ExecStats`/`ShardedExecStats` into the registry."""
    if not _trace._enabled:
        return
    count("exec.eval_calls", stats.eval_calls, **labels)
    count("exec.scan_compares", stats.scan_compares, **labels)
    count("exec.index_compares", stats.index_compares, **labels)
    count("exec.order_compares", stats.order_compares, **labels)
    count("exec.scan_leaves", stats.scan_leaves, **labels)
    count("exec.indexed_leaves", stats.indexed_leaves, **labels)
    if getattr(stats, "merge_compares", 0):
        count("exec.merge_compares", stats.merge_compares, **labels)


def absorb_batch_stats(bstats, **labels) -> None:
    """Fold one `BatchStats`/`ShardedBatchStats` into the registry."""
    if not _trace._enabled:
        return
    count("server.batches", 1, **labels)
    count("server.batch_queries", bstats.queries, **labels)
    count("server.batch_eval_calls", bstats.eval_calls, **labels)
    count("server.batch_scan_compares", bstats.scan_compares, **labels)
    count("server.batch_index_compares", bstats.index_compares, **labels)
    observe("server.batch_wall_s", bstats.wall_s, **labels)


def absorb_join_stats(jstats, **labels) -> None:
    """Fold one `JoinStats` into the registry."""
    if not _trace._enabled:
        return
    count("join.executions", 1, strategy=jstats.strategy, **labels)
    count("join.eval_calls", jstats.eval_calls, **labels)
    count("join.compares", jstats.join_compares, **labels)


def absorb_compaction_stats(cstats, **labels) -> None:
    """Fold one `CompactionStats` into the registry."""
    if not _trace._enabled:
        return
    count("compact.runs", 1, **labels)
    count("compact.merge_compares", cstats.merge_compares, **labels)
    count("compact.indexes_merged", cstats.indexes_merged, **labels)
