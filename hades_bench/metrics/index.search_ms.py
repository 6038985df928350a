"""index.search_ms: the mean `index.search` span of the traced window
(ms): one lane-batched binary search, base or delta run."""
from hbench.readers import mean_ms


def read(win):
    return mean_ms(win, "index.search")
