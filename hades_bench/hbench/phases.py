"""Helpers of the readers of the program's phase spans and counters."""
from __future__ import annotations


def span_sum(win, names) -> tuple:
    """(summed seconds, count) of the traced window's spans named in
    `names`, or None where the window holds none of them."""
    if win.spans is None:
        return None
    durs = [t1 - t0 for n, t0, t1 in win.spans if n in names]
    return (sum(durs), len(durs)) if durs else None


def counter_sum(win, name: str):
    """The sum of counter `name` over its labels in the traced window, or
    None where it was never counted."""
    if win.counters is None:
        return None
    vals = [v for k, v in win.counters.items() if k.split("{")[0] == name]
    return sum(vals) if vals else None


def per_compaction(win, name: str):
    """Counter `name` summed over its labels (a `{label}` in `name` picks
    that one), over the window's compactions (`compact.runs`), or None
    where either is absent."""
    if win.counters is None:
        return None
    total = (win.counters.get(name) if "{" in name
             else counter_sum(win, name))
    runs = win.counters.get("compact.runs")
    return total / runs if total is not None and runs else None
