"""insert_p95_ms: the 95th percentile of ms from each insert's due time
on the cell's schedule to its acknowledgement, over every insert that
fell due in the window (those acknowledged in the drain included)."""
import numpy as np


def read(win):
    lat = [1e3 * (w.done_t - w.submit_t) for w in win.writes
           if w.done_t is not None]
    return float(np.percentile(lat, 95)) if lat else None
