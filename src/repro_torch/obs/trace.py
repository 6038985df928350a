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
work.  `Span.sync(value)` synchronizes the value's CUDA stream *inside*
the span when tracing is enabled (a no-op for CPU tensors), and is the
identity function when disabled — enabling a trace tightens timing
attribution without changing what the engine computes.

Besides spans the tracer keeps a launch record per kernel launch
(`add_launch`, called by `kernels._build.count_launch`: the wrapper's
entry, the C call's start and return, the innermost span, the work
shape) and pairs of (perf_counter ns, Unix ns) read back to back (at
`tracing()` open and at each `serve.pump`), by which `to_unix_ns` puts a
span-clock stamp on the profiler's clock; `match_launches` pairs launch
records with the profiler's device events and returns each launch's
lead.
"""
from __future__ import annotations

import bisect
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

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
        """Wait for the device work behind `value` (a tensor) to finish:
        a synchronise of its device's current stream, so the span's
        duration includes it.  Returns `value` unchanged."""
        if getattr(value, "is_cuda", False):
            import torch
            torch.cuda.current_stream(value.device).synchronize()
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


def stamp() -> float:
    """`time.perf_counter()` (the span clock) while tracing, else 0.0:
    the kernel wrappers stamp their entry and C call with it."""
    return time.perf_counter() if _enabled else 0.0


def mark_clock() -> None:
    """Read a clock pair into the global tracer while tracing
    (`Tracer.mark_clock`; the serving loop's pump calls it)."""
    if _enabled:
        TRACER.mark_clock()


class Launch:
    """One kernel launch as its wrapper saw it: `t_in` (the wrapper's
    entry), `t_call` and `t_ret` (just before and after the C call) on
    the span clock, the `sid` of the innermost span it was made in (-1:
    none), and the work shape (`work`: lanes, rows, K, D, n, ...).
    `symbol` is the kernel's name as its device events carry it."""

    __slots__ = ("kernel", "symbol", "t_in", "t_call", "t_ret", "sid",
                 "tid", "work")

    def __init__(self, kernel: str, symbol: str, t_in: float, t_call: float,
                 t_ret: float, sid: int, tid: int, work: Dict[str, Any]):
        self.kernel, self.symbol = kernel, symbol
        self.t_in, self.t_call, self.t_ret = t_in, t_call, t_ret
        self.sid, self.tid, self.work = sid, tid, work

    @property
    def host_s(self) -> float:
        """Wrapper entry to the C call's return (s)."""
        return self.t_ret - self.t_in


class Tracer:
    """Global buffer of finished spans.  Thread-safe appends; spans
    keep their id / parent-id so the tree is reconstructible."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_sid = 0
        self.spans: List[Span] = []
        self.launches: List[Launch] = []
        # (perf_counter ns, Unix ns) read back to back, in time order
        self.clock_pairs: List[tuple] = []

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def clear(self) -> None:
        """Drop all recorded spans, launch records and clock pairs."""
        with self._lock:
            self.spans = []
            self.launches = []
            self.clock_pairs = []
            self._next_sid = 0

    def add_launch(self, kernel: str, symbol: str, t_in: float,
                   t_call: float, work: Dict[str, Any]) -> None:
        """Record one launch whose C call returned just now, in the
        innermost live span."""
        t_ret = time.perf_counter()
        cur = _current.get()
        rec = Launch(kernel, symbol, t_in, t_call, t_ret,
                     cur.sid if cur is not None else -1,
                     threading.get_ident(), work)
        with self._lock:
            self.launches.append(rec)

    # -- the clock ---------------------------------------------------------

    def mark_clock(self) -> None:
        """Read one (perf_counter ns, Unix ns) pair: the Unix clock
        between two reads of the span clock, paired with their middle;
        the tightest of three tries (a thread switch between the reads
        would skew one)."""
        tries = []
        for _ in range(3):
            p0 = time.perf_counter_ns()
            unix = time.time_ns()
            p1 = time.perf_counter_ns()
            tries.append((p1 - p0, (p0 + p1) // 2, unix))
        _, perf, unix = min(tries)
        with self._lock:
            self.clock_pairs.append((perf, unix))

    def to_unix_ns(self, t: float) -> int:
        """Span-clock stamp `t` (perf_counter seconds) on the Unix clock
        of `torch.profiler`'s events (ns), by the nearest clock pair."""
        if not self.clock_pairs:
            self.mark_clock()
        pairs = self.clock_pairs
        ns = int(round(t * 1e9))
        i = bisect.bisect_left(pairs, (ns,))
        near = min(pairs[max(0, i - 1):i + 1],
                   key=lambda p: abs(p[0] - ns))
        return near[1] + ns - near[0]

    # -- views -------------------------------------------------------------

    def chrome_trace(self, base_ns: int = 0) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON object: one `ph: "X"` complete
        event per span and per launch record (wrapper entry to the C
        call's return, on its host thread), stamped in µs of Unix time
        (`to_unix_ns`) after `base_ns`.  `torch.profiler`'s
        `export_chrome_trace` stamps its events after the Unix time its
        file names as `baseTimeNanoseconds`: pass that, and the two
        files' events overlay with no shift."""
        pid = os.getpid()
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s.t0)
            launches = list(self.launches)
        events = [{
            "name": sp.name, "ph": "X",
            "ts": (self.to_unix_ns(sp.t0) - base_ns) / 1e3,
            "dur": max(0.0, sp.t1 - sp.t0) * 1e6,
            "pid": pid, "tid": sp.tid,
            "args": {k: _jsonable(v) for k, v in sp.args.items()},
        } for sp in spans]
        events += [{
            "name": rec.kernel, "ph": "X", "cat": "launch",
            "ts": (self.to_unix_ns(rec.t_in) - base_ns) / 1e3,
            "dur": max(0.0, rec.host_s) * 1e6,
            "pid": pid, "tid": rec.tid,
            "args": {**{k: _jsonable(v) for k, v in rec.work.items()},
                     "sid": rec.sid,
                     "call_us": (rec.t_call - rec.t_in) * 1e6},
        } for rec in launches]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base_ns}

    def write_chrome_trace(self, path, base_ns: int = 0) -> None:
        """Serialize `chrome_trace(base_ns)` to `path`."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(base_ns), fh, indent=1)

    def roots(self) -> List[Span]:
        """Spans whose parent finished outside this trace (tree roots)."""
        sids = {sp.sid for sp in self.spans}
        return [sp for sp in self.spans if sp.parent_sid not in sids]

    def children(self, sp: Span) -> List[Span]:
        """Direct child spans of `sp`, in start order."""
        kids = [s for s in self.spans if s.parent_sid == sp.sid]
        return sorted(kids, key=lambda s: s.t0)

    def tree_lines(self, skip: Sequence[str] = ()) -> List[str]:
        """The span tree as indented text lines (for terminals/tests).
        Spans named in `skip` are left out, their children lifted to
        their place."""
        lines: List[str] = []

        def walk(sp: Span, depth: int) -> None:
            if sp.name in skip:
                for kid in self.children(sp):
                    walk(kid, depth)
                return
            attrs = " ".join(f"{k}={_jsonable(v)}" for k, v in sp.args.items())
            ms = (sp.t1 - sp.t0) * 1e3
            lines.append(f"{'  ' * depth}{sp.name}  {ms:.2f}ms"
                         + (f"  [{attrs}]" if attrs else ""))
            for kid in self.children(sp):
                walk(kid, depth + 1)

        for root in sorted(self.roots(), key=lambda s: s.t0):
            walk(root, 0)
        return lines

    def request_spans(self, ticket: int) -> List[Span]:
        """The spans of one `ServeLoop` ticket: each `serve.batch` span
        that drafted it (`tickets=`) and every span under those, in
        start order.  `request_launches` gives their launch records."""
        with self._lock:
            spans = list(self.spans)
        kids: Dict[int, List[Span]] = {}
        for sp in spans:
            kids.setdefault(sp.parent_sid, []).append(sp)
        todo = [sp for sp in spans if sp.name == "serve.batch"
                and ticket in sp.args.get("tickets", ())]
        out: List[Span] = []
        while todo:
            sp = todo.pop()
            out.append(sp)
            todo.extend(kids.get(sp.sid, ()))
        return sorted(out, key=lambda s: s.t0)

    def request_launches(self, ticket: int) -> List[Launch]:
        """The launch records made inside `request_spans(ticket)`."""
        sids = {sp.sid for sp in self.request_spans(ticket)}
        with self._lock:
            return [rec for rec in self.launches if rec.sid in sids]


def match_launches(records: Sequence[Launch], device_events: Sequence,
                   tracer: Optional["Tracer"] = None) -> List[Dict]:
    """Pair launch records with the device events of their kernel.

    `device_events`: (name, start_ns, end_ns) on the profiler's Unix
    clock (`torch.profiler`'s kernel events).  Records and events of one
    `symbol` (an event matches when its name contains it) pair in launch
    order, one stream assumed.  Returns, per pair in call order,
    {kernel, sid, call_ns, start_ns, lead_ns}: `lead_ns` is from the C
    call's start (`tracer.to_unix_ns`, default the global tracer) to the
    kernel's start on the card.  On a shared clock no lead is negative:
    a negative lead says the device events' stamps run behind the host
    clock by at least that much.  Records or events beyond the shorter
    list of a symbol stay unpaired."""
    tracer = tracer or TRACER
    by_symbol: Dict[str, List[Launch]] = {}
    for rec in records:
        by_symbol.setdefault(rec.symbol, []).append(rec)
    out: List[Dict] = []
    for sym, recs in by_symbol.items():
        recs = sorted(recs, key=lambda r: r.t_call)
        starts = sorted(int(e[1]) for e in device_events if sym in e[0])
        for rec, start in zip(recs, starts):
            call = tracer.to_unix_ns(rec.t_call)
            out.append({"kernel": rec.kernel, "sid": rec.sid,
                        "call_ns": call, "start_ns": start,
                        "lead_ns": start - call})
    return sorted(out, key=lambda m: m["call_ns"])


def _jsonable(v):
    """Coerce span-attribute values to JSON-safe scalars."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global `Tracer` buffer."""
    return TRACER


class tracing:
    """Context manager: enable tracing (and metrics) for a region,
    restore the previous state on exit, yield the global tracer.

    `fresh=True` (default) clears previously-recorded spans and resets
    the metrics registry so the trace covers exactly this region.  The
    open reads a clock pair (`Tracer.mark_clock`)."""

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
        TRACER.mark_clock()
        enable()
        return TRACER

    def __exit__(self, *exc) -> None:
        if not self._was_enabled:
            disable()
