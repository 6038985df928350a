"""Exporters: Chrome-trace JSON, flat metrics dumps, BENCH fields.

Two consumers: humans (load `write_chrome_trace` output into
chrome://tracing or ui.perfetto.dev; print `tree_lines`), and benchmark
harnesses (`bench_fields()` rides each pass's `derived` dict so a
trajectory carries launch/lane/retrace counts).  In the port
`jit_signatures` are the distinct kernel launch signatures per site
(`obs.jitwatch`).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.obs import jitwatch, metrics
from repro_torch.obs.trace import TRACER, Tracer

_REQUIRED_EVENT_KEYS = ("ph", "ts", "pid")


def chrome_trace(tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """The Chrome-trace JSON object for `tracer` (default: global)."""
    return (tracer or TRACER).chrome_trace()


def write_chrome_trace(path, tracer: Optional[Tracer] = None) -> None:
    """Write the Chrome-trace JSON for `tracer` to `path`."""
    (tracer or TRACER).write_chrome_trace(path)


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate a Chrome-trace object (or JSON string): `traceEvents`
    must be a list and every event must carry `ph`/`ts`/`pid` (plus
    `name`/`tid`/`dur` for complete events).  Returns a list of error
    strings — empty means valid."""
    errors: List[str] = []
    if isinstance(doc, str):
        try:
            doc = json.loads(doc)
        except json.JSONDecodeError as e:
            return [f"not JSON: {e}"]
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED_EVENT_KEYS:
            if k not in ev:
                errors.append(f"event {i}: missing '{k}'")
        if ev.get("ph") == "X":
            for k in ("name", "tid", "dur"):
                if k not in ev:
                    errors.append(f"event {i}: complete event missing '{k}'")
    return errors


def metrics_dump(registry: Optional[metrics.Registry] = None
                 ) -> Dict[str, Any]:
    """Flat JSON-safe metrics snapshot, plus the launch signature sets."""
    reg = registry or metrics.REGISTRY
    return {"metrics": reg.snapshot(),
            "jit_signatures": jitwatch.signatures()}


def write_metrics(path, registry: Optional[metrics.Registry] = None) -> None:
    """Serialize `metrics_dump()` to `path`."""
    with open(path, "w") as fh:
        json.dump(metrics_dump(registry), fh, indent=1, sort_keys=True)


def bench_fields(registry: Optional[metrics.Registry] = None
                 ) -> Dict[str, int]:
    """The launch-accounting triple every benchmark pass carries:
    eval_launches / compare_lanes / jit_retraces."""
    reg = registry or metrics.REGISTRY
    return {
        "eval_launches": reg.value("eval.launches"),
        "compare_lanes": reg.value("eval.lanes"),
        "jit_retraces": reg.value("jit.retraces"),
    }
