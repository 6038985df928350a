"""Span tracing for the encrypted query engine.

One global trace buffer, contextvar-nested spans, device-true timing.
The design constraint is the disabled path: `obs.span(...)` must cost
one global-bool check and return a shared no-op object, so
instrumentation can live inside the executor hot path permanently.

Usage::

    with obs.tracing() as tr:
        server.run()
    tr.write_chrome_trace("trace.json")   # chrome://tracing / Perfetto

Spans nest through a `contextvars.ContextVar`, so server batches, loop
pumps, index probes and compactions all attach to the span that was
live when they started — including across threads spawned with a
copied context.

Device-true timing: CUDA launches are asynchronous, so a naive
`perf_counter()` pair around a launch measures the enqueue, not the
work.  `Span.sync(value)` synchronizes the value's CUDA device *inside*
the span when tracing is enabled (a no-op for CPU tensors), and is the
identity function when disabled — enabling a trace tightens timing
attribution without changing what the engine computes.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_enabled: bool = os.environ.get("REPRO_OBS", "") not in ("", "0")

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None)


def enable() -> None:
    """Turn span recording + metrics collection on (module-global)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn span recording + metrics collection off (module-global)."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    """Whether the observability layer is currently recording."""
    return _enabled


class Span:
    """One timed, attributed region.  Created by `span()`; use as a
    context manager.  Finished spans land in the global `Tracer`."""

    __slots__ = ("name", "args", "t0", "t1", "sid", "parent_sid",
                 "depth", "tid", "_token")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0
        self.sid = -1
        self.parent_sid = -1
        self.depth = 0
        self.tid = 0
        self._token = None

    def __enter__(self) -> "Span":
        parent = _current.get()
        tr = TRACER
        with tr._lock:
            self.sid = tr._next_sid
            tr._next_sid += 1
        self.parent_sid = parent.sid if parent is not None else -1
        self.depth = parent.depth + 1 if parent is not None else 0
        self.tid = threading.get_ident()
        self._token = _current.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._token is not None:
            _current.reset(self._token)
        TRACER._finish(self)

    def set(self, **kw) -> "Span":
        """Attach attributes to the span (shown in the trace `args`)."""
        self.args.update(kw)
        return self

    def sync(self, value):
        """Wait for the device work behind `value` (a tensor) to finish,
        so the span's duration includes it.  Returns `value` unchanged."""
        if getattr(value, "is_cuda", False):
            import torch
            torch.cuda.synchronize(value.device)
        return value

    @property
    def dur_s(self) -> float:
        """Span duration in seconds (0 until the span closes)."""
        return max(0.0, self.t1 - self.t0)


class _NullSpan:
    """Shared do-nothing span handed out when tracing is disabled.
    `sync` is the identity — no forced device sync on the fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **kw) -> "_NullSpan":
        """No-op attribute setter (disabled-path stand-in)."""
        return self

    def sync(self, value):
        """Identity: no device sync when tracing is off."""
        return value


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Open a span named `name` with attributes `args`.  Returns the
    shared no-op span when tracing is disabled (near-zero cost)."""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, args)


def current_span():
    """The innermost live span in this context, or None."""
    return _current.get()


class Tracer:
    """Global buffer of finished spans.  Thread-safe appends; spans
    keep their id / parent-id so the tree is reconstructible."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_sid = 0
        self.spans: List[Span] = []
        self._epoch = time.perf_counter()

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def clear(self) -> None:
        """Drop all recorded spans and restart the trace clock."""
        with self._lock:
            self.spans = []
            self._next_sid = 0
            self._epoch = time.perf_counter()

    # -- views -------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON object: one `ph: "X"` complete
        event per span (load in chrome://tracing or ui.perfetto.dev;
        spans of one thread nest by time)."""
        pid = os.getpid()
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s.t0)
        return {"traceEvents": [{
            "name": sp.name, "ph": "X",
            "ts": (sp.t0 - self._epoch) * 1e6,
            "dur": max(0.0, sp.t1 - sp.t0) * 1e6,
            "pid": pid, "tid": sp.tid,
            "args": {k: _jsonable(v) for k, v in sp.args.items()},
        } for sp in spans], "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        """Serialize `chrome_trace()` to `path`."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh, indent=1)

    def roots(self) -> List[Span]:
        """Spans whose parent finished outside this trace (tree roots)."""
        sids = {sp.sid for sp in self.spans}
        return [sp for sp in self.spans if sp.parent_sid not in sids]

    def children(self, sp: Span) -> List[Span]:
        """Direct child spans of `sp`, in start order."""
        kids = [s for s in self.spans if s.parent_sid == sp.sid]
        return sorted(kids, key=lambda s: s.t0)

    def tree_lines(self) -> List[str]:
        """The span tree as indented text lines (for terminals/tests)."""
        lines: List[str] = []

        def walk(sp: Span, depth: int) -> None:
            attrs = " ".join(f"{k}={_jsonable(v)}" for k, v in sp.args.items())
            ms = (sp.t1 - sp.t0) * 1e3
            lines.append(f"{'  ' * depth}{sp.name}  {ms:.2f}ms"
                         + (f"  [{attrs}]" if attrs else ""))
            for kid in self.children(sp):
                walk(kid, depth + 1)

        for root in sorted(self.roots(), key=lambda s: s.t0):
            walk(root, 0)
        return lines


def _jsonable(v):
    """Coerce span-attribute values to JSON-safe scalars."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return str(v)


TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global `Tracer` buffer."""
    return TRACER


class tracing:
    """Context manager: enable tracing (and metrics) for a region,
    restore the previous state on exit, yield the global tracer.

    `fresh=True` (default) clears previously-recorded spans and resets
    the metrics registry so the trace covers exactly this region."""

    def __init__(self, fresh: bool = True):
        self.fresh = fresh
        self._was_enabled = False

    def __enter__(self) -> Tracer:
        self._was_enabled = is_enabled()
        if self.fresh:
            TRACER.clear()
            from repro_torch.obs import jitwatch, metrics
            metrics.REGISTRY.reset()
            jitwatch.reset()
        enable()
        return TRACER

    def __exit__(self, *exc) -> None:
        if not self._was_enabled:
            disable()
