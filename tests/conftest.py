"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the
real (single) device; only launch/dryrun.py forces 512 host devices."""
import zlib

import jax
import numpy as np
import pytest

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def rng(request):
    """Deterministic per-test np.random.Generator.

    Seeded from the test's nodeid, so (a) every run of a given test —
    including hypothesis-less fallback sweeps of the encrypted-compare
    property tests — draws the same values, and (b) failures replay
    exactly from the failing test's name alone.  Parametrized tests get
    distinct streams per parameter (the id is part of the nodeid).
    """
    seed = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# cross-scheme engine matrix: one cached KeySet per profile for the whole
# session (test-ckks keygen alone is ~10s — pay it once, not per test)
# ---------------------------------------------------------------------------

_SCHEME_KS_CACHE = {}

# keygen seeds match the historical bfv_keys/ckks_keys fixtures, which now
# delegate here — one keygen per profile for the whole session, regardless
# of whether a test reaches the keyset via scheme_ks or the named fixtures
_SCHEME_SEEDS = {"test-bfv": 42, "test-ckks": 7}


def get_scheme_ks(profile: str):
    """Shared small-profile KeySet cache (importable by tests that need a
    specific scheme outside the `scheme_ks` parametrization)."""
    if profile not in _SCHEME_KS_CACHE:
        from repro.core.keys import keygen
        from repro.core.params import make_params
        _SCHEME_KS_CACHE[profile] = keygen(
            make_params(profile, mode="gadget"),
            jax.random.PRNGKey(_SCHEME_SEEDS[profile]))
    return _SCHEME_KS_CACHE[profile]


@pytest.fixture(scope="session", params=["test-bfv", "test-ckks"],
                ids=["bfv", "ckks"])
def scheme_ks(request):
    """Parametrizes a test over the bfv and ckks engine profiles."""
    return get_scheme_ks(request.param)


@pytest.fixture(scope="session")
def bfv_engine_ks():
    """The bfv KeySet from the same shared cache, for scheme-independent
    engine tests (plan compilation etc.) that shouldn't double-run."""
    return get_scheme_ks("test-bfv")


@pytest.fixture(scope="session")
def bfv_params():
    from repro.core.params import make_params
    return make_params("test-bfv", mode="gadget")


@pytest.fixture(scope="session")
def bfv_keys(bfv_params):
    return get_scheme_ks("test-bfv")


@pytest.fixture(scope="session")
def paper_params():
    from repro.core.params import make_params
    return make_params("test-bfv", mode="paper")


@pytest.fixture(scope="session")
def paper_keys(paper_params):
    from repro.core.keys import keygen
    # weight=0 satisfies the paper's own correctness precondition exactly
    return keygen(paper_params, jax.random.PRNGKey(42), paper_ecek_weight=0)


@pytest.fixture(scope="session")
def ckks_params():
    from repro.core.params import make_params
    return make_params("test-ckks", mode="gadget")


@pytest.fixture(scope="session")
def ckks_keys(ckks_params):
    return get_scheme_ks("test-ckks")
