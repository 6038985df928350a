"""server.batch_ms: the mean `BatchStats.wall_s` of the read batches the
server drained in the window (ms)."""


def read(win):
    walls = [b.wall_s for b in win.batch_log]
    return 1e3 * sum(walls) / len(walls) if walls else None
