"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window,
its peak stats reset at the open, so the table and index count."""


def read(win):
    return None if win.peak_bytes is None else win.peak_bytes / 2**30
