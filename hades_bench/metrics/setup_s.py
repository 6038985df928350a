"""setup_s: from the runner's start to the window's open: CUDA start,
the kernels' build in a fresh checkout, keys, the encrypted column, the
index, the request pool and the warm-up."""


def read(win):
    return win.setup_s
