"""Launch-signature observer: distinct (shape, dtype) signatures per site.

The port of `repro.obs.jitwatch`.  Under JAX a new signature meant a
retrace and recompile; here it means a new launch shape (grid and
tile size) for the kernel behind the site.  The pow2 padding discipline
keeps the signature set per site at ~1, and any signature beyond the
first at a site increments the `jit.retraces` counter (the reference's
name, kept so both engines report the same metric).

Gated on `obs.is_enabled()` like everything else in the layer.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple

from repro_torch.obs import metrics
from repro_torch.obs import trace as _trace

_lock = threading.Lock()
_sites: Dict[str, Set[Tuple]] = {}


def _sig_of(x) -> Tuple:
    """(shape, dtype) signature of an array-like (or passthrough tuple)."""
    shape = getattr(x, "shape", None)
    if shape is None:
        return (tuple(x),) if isinstance(x, (tuple, list)) else (str(x),)
    return (tuple(int(d) for d in shape), str(getattr(x, "dtype", "?")))


def launch(site: str, *operands) -> None:
    """Record one launch at `site` with the given operands (arrays or
    explicit shape tuples).  New-signature-beyond-the-first increments
    `jit.retraces` (total and per-site)."""
    if not _trace._enabled:
        return
    sig = tuple(_sig_of(x) for x in operands)
    metrics.count("launches", 1, site=site)
    with _lock:
        seen = _sites.setdefault(site, set())
        fresh = sig not in seen
        if fresh:
            seen.add(sig)
            retrace = len(seen) > 1
        else:
            retrace = False
    if retrace:
        metrics.count("jit.retraces", 1)
        metrics.count("jit.retraces", 1, site=site)


def signatures() -> Dict[str, List[Tuple]]:
    """Site → sorted list of distinct launch signatures seen so far."""
    with _lock:
        return {site: sorted(map(repr, sigs))
                for site, sigs in sorted(_sites.items())}


def retraces() -> int:
    """Total distinct-signatures-beyond-the-first across all sites."""
    with _lock:
        return sum(max(0, len(s) - 1) for s in _sites.values())


def reset() -> None:
    """Forget every signature (fresh trace region)."""
    with _lock:
        _sites.clear()
