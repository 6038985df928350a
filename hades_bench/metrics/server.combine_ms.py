"""server.combine_ms: the mean `server.combine` span of the traced window
(ms): one a read batch, the per-query loop after the index probes and
the fused Eval (the boolean tree, the live-slot mask, the slot ids, the
row mask, order and gathers)."""
from hbench.readers import mean_ms


def read(win):
    return mean_ms(win, "server.combine")
