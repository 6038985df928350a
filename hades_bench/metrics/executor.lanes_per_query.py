"""executor.lanes_per_query: the `eval.lanes` counter of the traced
window over the reads answered in it."""


def read(win):
    if win.counters is None or not win.ok_reads():
        return None
    lanes = win.counters.get("eval.lanes", 0)
    return lanes / len(win.ok_reads()) if lanes else None
