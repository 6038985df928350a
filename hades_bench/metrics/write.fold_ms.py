"""write.fold_ms: the mean `compact.fold` span of the traced window (ms):
a compaction's append of the delta's rows to the base's columns (a
whole-column concat and the encrypted zero rows that pad it)."""
from hbench.readers import mean_ms


def read(win):
    return mean_ms(win, "compact.fold")
