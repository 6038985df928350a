"""host_p95_ms: the reads' 95th percentile of submit-to-answer ms in the
traced window, where `obs` spans synchronise the card per tile: in a
cell whose card is idle most of the window the tail is paced by the
host, and this companion shows what the tracing adds to it (per layer,
beside the untraced `p95_ms` of the same cell, which it moves)."""
import numpy as np


def read(win):
    lat = win.read_latencies_ms()
    return float(np.percentile(lat, 95)) if lat.size else None
