"""executor.tile_host_ms: the host time of a fused-scan tile outside its
wait for the card (ms): the summed `executor.tile_launch` (until the
tile's Eval is enqueued) and `executor.tile_copy` (the copy to the host
and the store) spans over the count of `executor.eval_tile` spans."""
from hbench.phases import span_sum


def read(win):
    host = span_sum(win, ("executor.tile_launch", "executor.tile_copy"))
    tiles = span_sum(win, ("executor.eval_tile",))
    if host is None or tiles is None:
        return None
    return 1e3 * host[0] / tiles[1]
