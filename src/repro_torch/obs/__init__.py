"""`repro_torch.obs`: tracing, metrics, and launch accounting in one layer.

The engine's cost story — eval launches, compare lanes, index probes,
launch-signature retraces, batch latency — flows through this package
so the executor, the servers, the serving loop and the benchmarks all
hang measurements on the same counters.  Three pieces:

  * spans  (`obs.span`, `obs.tracing`) — nested, device-true timing,
    Chrome-trace export in Unix time; near-zero cost when disabled; the
    kernel wrappers' launch records (`Tracer.launches`) and their match
    with the profiler's device events (`obs.match_launches`);
  * metrics (`obs.count`, `obs.observe`, `obs.metrics.REGISTRY`) —
    counters + histograms that absorb the per-call stats dataclasses;
  * jitwatch (`obs.jit_launch`) — kernel launch-signature sets per
    site, surfacing pow2-bucketing violations as a `jit.retraces`
    counter;

and `export` (Chrome-trace files, flat metric dumps, bench fields).
Enable for a region with `with obs.tracing() as tr:` (or process-wide
via `REPRO_OBS=1`); everything is a one-bool-check no-op otherwise.
"""
from repro_torch.obs import export, jitwatch, metrics
from repro_torch.obs.export import (bench_fields, chrome_trace, metrics_dump,
                                    validate_chrome_trace, write_chrome_trace,
                                    write_metrics)
from repro_torch.obs.jitwatch import launch as jit_launch
from repro_torch.obs.jitwatch import retraces as jit_retraces
from repro_torch.obs.jitwatch import signatures as jit_signatures
from repro_torch.obs.metrics import (REGISTRY, Counter, Histogram, Registry,
                                     absorb_batch_stats,
                                     absorb_compaction_stats,
                                     absorb_exec_stats, count, count_mallocs,
                                     observe)
from repro_torch.obs.trace import (TRACER, Launch, Span, Tracer, current_span,
                                   disable, enable, get_tracer, is_enabled,
                                   mark_clock, match_launches, span, stamp,
                                   tracing)

__all__ = [
    "export", "jitwatch", "metrics",
    "bench_fields", "chrome_trace", "metrics_dump", "validate_chrome_trace",
    "write_chrome_trace", "write_metrics",
    "jit_launch", "jit_retraces", "jit_signatures",
    "REGISTRY", "Counter", "Histogram", "Registry",
    "absorb_batch_stats", "absorb_compaction_stats",
    "absorb_exec_stats", "count", "count_mallocs", "observe",
    "TRACER", "Launch", "Span", "Tracer", "current_span", "disable",
    "enable", "get_tracer", "is_enabled", "mark_clock", "match_launches",
    "span", "stamp", "tracing",
]
