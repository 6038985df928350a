"""write.compact_gib: the ciphertext bytes one compaction reads plus
writes, counted by the program from logical shapes (`compact.bytes`,
summed over its phases: the delta run's index sort, the merge blocks'
padding, the merge network's compare-exchange stages, the fold), over
the window's compactions (`compact.runs`), in GiB."""
from hbench.phases import per_compaction


def read(win):
    b = per_compaction(win, "compact.bytes")
    return None if b is None else b / 2**30
