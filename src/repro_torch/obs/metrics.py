"""Counters + histograms for the encrypted query engine.

The registry is the aggregation layer OVER the per-call stats
dataclasses (`ExecStats`, `BatchStats`): those stay as cheap always-on
return values, and `absorb_*` folds them into process-wide counters
whenever the observability layer is enabled.  Direct instrumentation (launch
counts, lane totals, ciphertext bytes, pad-waste) lands here too.

All record helpers are gated on `obs.is_enabled()` — one global bool
check when disabled.

Counter glossary:

  eval.launches        batched raw-eval launches (fused-scan tiles,
                       index probe steps, pair-grid tiles, merge rounds)
  eval.lanes           total compare lanes through those launches
  index.probes         encrypted binary-search probe lanes
  bytes.moved          ciphertext bytes entering launches
  jit.retraces         distinct launch signatures beyond the first
                       per site (see jitwatch)
  pad.waste            histogram of n_padded / n_rows per executed plan
  server.batch_wall_s  histogram of drained-batch wall seconds
  server.queries       queries served (label: tenant)
  server.compares      compare lanes attributed per tenant
  compact.bytes        ciphertext bytes a compaction phase reads plus
                       writes, from logical shapes (label: phase)
  mem.cuda_mallocs     cudaMalloc segments allocated inside a span
                       (label: span; CUDA only)
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
    """Value distribution; keeps raw observations (engine cardinality
    is batches, not rows, so the buffer stays small) and derives
    count/sum/percentiles on demand."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        """Record one observation."""
        self.values.append(float(v))

    @property
    def count(self) -> int:
        """Number of observations."""
        return len(self.values)

    @property
    def total(self) -> float:
        """Sum of observations."""
        return float(sum(self.values))

    def percentile(self, p: float) -> float:
        """The p-th percentile (0..100) by nearest-rank
        (ceil(p/100·n)-th sorted value); 0.0 if empty."""
        if not self.values:
            return 0.0
        xs = sorted(self.values)
        k = max(0, min(len(xs) - 1,
                       -(-int(p * len(xs)) // 100) - 1))  # ceil w/o math
        return xs[k]

    def summary(self) -> Dict[str, float]:
        """count / sum / p50 / p99 as a flat dict."""
        return {"count": self.count, "sum": self.total,
                "p50": self.percentile(50), "p99": self.percentile(99)}


MetricKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> MetricKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _key_str(key: MetricKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Registry:
    """Name+labels → Counter/Histogram map with a flat snapshot view."""

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

    def snapshot(self) -> Dict[str, Any]:
        """Flat `{name_string: int | summary-dict}` dump (JSON-safe),
        sorted by key for stable diffs."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        out: Dict[str, Any] = {}
        for key, m in items:
            out[_key_str(key)] = (m.value if isinstance(m, Counter)
                                  else m.summary())
        return out

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


def absorb_compaction_stats(cstats, **labels) -> None:
    """Fold one `CompactionStats` into the registry."""
    if not _trace._enabled:
        return
    count("compact.runs", 1, **labels)
    count("compact.merge_compares", cstats.merge_compares, **labels)
    count("compact.indexes_merged", cstats.indexes_merged, **labels)


class _MallocCount:
    """Adds the cudaMalloc segments allocated between its enter and exit
    to `mem.cuda_mallocs{span=...}`."""

    __slots__ = ("span", "device", "before")

    def __init__(self, span: str, device):
        self.span, self.device = span, device

    def _segments(self) -> int:
        import torch
        return torch.cuda.memory_stats(self.device).get(
            "segment.all.allocated", 0)

    def __enter__(self) -> "_MallocCount":
        self.before = self._segments()
        return self

    def __exit__(self, *exc) -> None:
        count("mem.cuda_mallocs", self._segments() - self.before,
              span=self.span)


def count_mallocs(span: str, device):
    """Context manager: count the cudaMalloc calls of a region on a CUDA
    `device` into `mem.cuda_mallocs{span=span}` (the allocator's
    `segment.all.allocated` before and after).  The shared no-op span
    when tracing is off or the device is not CUDA."""
    if not _trace._enabled or getattr(device, "type", None) != "cuda":
        return _trace._NULL_SPAN
    return _MallocCount(span, device)
