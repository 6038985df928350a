"""qps: read requests answered OK in the window, per second of it."""


def read(win):
    return len(win.ok_reads()) / win.seconds
