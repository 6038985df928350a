"""loop.read_qps: reads answered OK per second of the traced window.
Where a cell's reads come one batch a pump between long write pumps,
their throughput steps with how many read pumps fit between two
compactions, and it stands beside the cell's end-to-end tails as a
per-layer reading."""


def read(win):
    return len(win.ok_reads()) / win.seconds
