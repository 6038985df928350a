"""loop.batch_fill: the mean size of the read batches the loop drafted
in the window, as a share of its batch cap (%)."""


def read(win):
    sizes = [s for _, klass, s in win.batch_shapes if klass != "write"]
    return 100.0 * sum(sizes) / len(sizes) / win.batch_cap if sizes else None
