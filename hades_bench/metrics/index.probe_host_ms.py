"""index.probe_host_ms: the host time of an index probe step (ms): the
summed `index.probe_step` spans less their `index.probe_wait` children
(the wait for the step's Eval on the card), over the count of steps."""
from hbench.phases import span_sum


def read(win):
    steps = span_sum(win, ("index.probe_step",))
    if steps is None:
        return None
    waits = span_sum(win, ("index.probe_wait",)) or (0.0, 0)
    return 1e3 * (steps[0] - waits[0]) / steps[1]
