"""`repro_torch.obs`: tracing, metrics and launch accounting.

The part of `repro.obs` the served path uses: spans (`obs.span`,
`obs.tracing`), counters and histograms (`obs.count`, `obs.observe`,
`obs.REGISTRY`) that absorb the per-call stats dataclasses, and the
launch-signature watcher (`obs.jit_launch`).  Everything is a
one-bool-check no-op unless enabled (`with obs.tracing() as tr:` or
`REPRO_OBS=1`).  `export.py` is not ported yet.
"""
from repro_torch.obs.jitwatch import launch as jit_launch
from repro_torch.obs.metrics import (REGISTRY, absorb_batch_stats,
                                     absorb_exec_stats, count, observe)
from repro_torch.obs.trace import TRACER, is_enabled, span, tracing

__all__ = [
    "jit_launch", "REGISTRY", "absorb_batch_stats", "absorb_exec_stats",
    "count", "observe", "TRACER", "is_enabled", "span", "tracing",
]
