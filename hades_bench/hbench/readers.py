"""Helpers the per-layer metric readers share."""
from __future__ import annotations


def mean_ms(win, name: str):
    """The mean duration of the traced window's `name` spans (ms), or
    None where there is none."""
    if win.spans is None:
        return None
    durs = [t1 - t0 for n, t0, t1 in win.spans if n == name]
    return 1e3 * sum(durs) / len(durs) if durs else None


def roofline_share(win, kernel: str):
    """100 x the kernel's summed bound over its device seconds in the
    traced window, or None where it did not run or the card has no
    published peaks here."""
    if win.kernels is None or win.device is None:
        return None
    calls, bound = win.kernels.sums[kernel]
    device_s = win.device.kernel_s(kernel)
    if not calls or not device_s or win.kernels.peaks is None:
        return None
    return 100.0 * bound / device_s
