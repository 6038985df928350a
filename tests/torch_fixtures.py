"""The fixtures every port test module (`test_torch_*.py`) runs under,
held here once.  A module takes them by name, and pytest collects them
from its namespace:

    from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
        _clear_reference_spans, _one_torch_thread, _time_limit,
        _unoptimized_reference_compiles)

and a module that runs the reference's encryption or indexes also
imports `_jitted_reference` and asks for it with `pytestmark =
pytest.mark.usefixtures("_jitted_reference")`.  The reference's own
test files do not use them."""
import contextlib
import faulthandler
import signal
import sys
import time

import jax
import pytest
import torch

from repro import obs as RO
from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.db import index as RI
from repro.db.shard import index as RSI

# a port test fails past this, from its function fixtures' setup to their
# teardown (about twice the slowest test of the suite measured, a 165 s
# case of the reference's shard invariance)
TEST_TIME_LIMIT_S = 300


# ---------------------------------------------------------------------------
# the time limit of every port test
# ---------------------------------------------------------------------------

class TimeLimitExceeded(BaseException):
    """A test ran past its time limit.  A BaseException, as pytest's own
    outcomes are, so that an `except Exception` on the way (a serve
    loop's fault isolation, Hypothesis's shrinking) lets it through."""


@contextlib.contextmanager
def time_limit(seconds: float, what: str = "test"):
    """Raise `TimeLimitExceeded` once `seconds` have passed, after dumping
    every thread's stack to stderr.  On exit the handler and the timer
    found on entry are restored, the timer with what is left of it, so
    limits nest.  SIGALRM interrupts Python code and blocking calls such
    as sleeps (C code that never returns to the interpreter stays stuck,
    its stack dumped); it is set from the main thread, where pytest and
    its xdist workers run tests."""
    def expire(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        raise TimeLimitExceeded(
            f"{what} ran past its time limit of {seconds} s")

    old_handler = signal.signal(signal.SIGALRM, expire)
    start = time.monotonic()
    outer, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
        if outer:
            left = outer - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Fail a test that runs past `TEST_TIME_LIMIT_S`: a hang then names
    its line and costs one failure instead of the suite."""
    with time_limit(TEST_TIME_LIMIT_S, request.node.nodeid):
        yield


# ---------------------------------------------------------------------------
# module fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's ops while a module runs: the
    suite's worker processes share the cores, and each op's thread pool
    would wait on the others (the torch range-query example took 110 s
    under 6 workers, 3 s alone)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_reference_compiles():
    """Compile the reference's programs without XLA's optimization
    passes while a module runs: nearly all of the reference's time in
    these tests is compiling eager ops and jitted programs at each new
    shape.  The passes change no integer result; float results (CKKS
    encodings, the model families) may differ in their last bits
    without them, and the port's float tests hold within their
    tolerances under this setting."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


@pytest.fixture(scope="module", autouse=True)
def _clear_reference_spans():
    """Leave the reference's tracer without spans after a module:
    `RO.tracing()` keeps a region's spans for the caller to read, and
    tests/test_obs.py expects none while tracing is off, whichever
    module ran before it in the same worker."""
    yield
    RO.TRACER.clear()


# ---------------------------------------------------------------------------
# the reference jitted once per KeySet (ask for `_jitted_reference`)
# ---------------------------------------------------------------------------

_JITTED = {}        # (function, id(KeySet)) -> jitted; the jitted
                    # closure holds its KeySet, so an id is never reused
_REF_FNS = {"encrypt": RE.encrypt, "decrypt": RE.decrypt,
            "encrypt_fae": RE.encrypt_fae, "eval_value": RC.eval_value,
            "compare_fae": RC.compare_fae}


def _jitted(name, ks):
    """The reference's `name`, with `ks` bound, jitted once."""
    key = (name, id(ks))
    if key not in _JITTED:
        fn = _REF_FNS[name]
        _JITTED[key] = jax.jit(lambda *a: fn(ks, *a))
    return _JITTED[key]


def _build_with_shared_jit(build):
    def wrapped(cls, ks, table, column, *, comparator=None):
        fae = _jitted("compare_fae", ks)
        return build(ks, table, column, comparator=comparator or (
            lambda _ks, a, b: fae(a, b)))
    return classmethod(wrapped)


def jit_reference(setattr_=setattr):
    """Route the reference's encrypt, encrypt_fae and decrypt, its
    indexes' sort comparator and its probe Evals through `_jitted`:
    eager JAX compiles every op at every new shape (seconds per
    encryption on a CPU), a reference index jits its own comparator and
    probe Eval per build, and jitting integer arithmetic changes no
    value.  `setattr_` is `monkeypatch.setattr` under a test."""
    for name in ("encrypt", "decrypt", "encrypt_fae"):
        setattr_(RE, name, lambda ks, *a, _n=name: _jitted(_n, ks)(*a))
    setattr_(RI.SortedIndex, "build",
             _build_with_shared_jit(RI.SortedIndex.build))
    for cls in (RI.SortedIndex, RSI.ShardedIndex):
        setattr_(cls, "_eval", lambda self, ks: _jitted("eval_value", ks))


@pytest.fixture
def _jitted_reference(monkeypatch):
    """The reference jitted once per KeySet for one port test (see
    `jit_reference`)."""
    jit_reference(monkeypatch.setattr)
