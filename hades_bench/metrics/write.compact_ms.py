"""write.compact_ms: the mean `compact` span of the traced window (ms):
the index merge and the fold of the delta into the base."""
from hbench.readers import mean_ms


def read(win):
    return mean_ms(win, "compact")
