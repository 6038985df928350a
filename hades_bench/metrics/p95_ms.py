"""p95_ms: the 95th percentile of submit-to-answer ms over every read
submitted in the window (those answered in the drain included)."""
import numpy as np


def read(win):
    lat = win.read_latencies_ms()
    return float(np.percentile(lat, 95)) if lat.size else None
