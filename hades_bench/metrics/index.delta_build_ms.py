"""index.delta_build_ms: the mean `delta.index_sort` span of the traced
window (ms): one fresh sort of the pending delta run's index (a read
batch's, or a compaction's)."""
from hbench.readers import mean_ms


def read(win):
    return mean_ms(win, "delta.index_sort")
