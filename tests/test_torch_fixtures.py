"""What tests/torch_fixtures.py puts on a port test module: the time
limit of each test, and the module fixtures in force."""
import os
import signal
import time

import jax
import pytest
import torch

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    TEST_TIME_LIMIT_S, TimeLimitExceeded, _clear_reference_spans,
    _one_torch_thread, _time_limit, _unoptimized_reference_compiles,
    time_limit)


def test_time_limit_dumps_stacks_raises_and_restores_the_outer_limit(capfd):
    outer = signal.getitimer(signal.ITIMER_REAL)[0]     # `_time_limit`'s
    assert 0 < outer <= TEST_TIME_LIMIT_S
    handler = signal.getsignal(signal.SIGALRM)
    start = time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="time limit of 1 s"):
        with time_limit(1, "a 3 s sleep"):
            time.sleep(3)
    assert time.monotonic() - start < 2.5
    assert os.path.basename(__file__) in capfd.readouterr().err  # the dump
    assert outer - 2.5 < signal.getitimer(signal.ITIMER_REAL)[0] < outer
    assert signal.getsignal(signal.SIGALRM) is handler


def test_time_limit_passes_through_except_exception():
    caught = []
    with pytest.raises(TimeLimitExceeded):
        with time_limit(0.2, "a loop that isolates faults"):
            for _ in range(30):
                try:                    # as a serve loop isolates a fault
                    time.sleep(0.1)
                except Exception as e:
                    caught.append(e)
    assert caught == []


def test_module_fixtures_in_force():
    assert torch.get_num_threads() == 1
    assert jax.config.read("jax_disable_most_optimizations")
