"""The port's copies of the paper's baselines (`repro_torch.baselines`:
Paillier, HOPE, POPE) against the reference's.

Keys and ciphertexts are Python integers, so the two packages'
interoperate: the reference's cases run on both copies, a ciphertext of
one decrypts under the other's key, and on the same keys HOPE and POPE
give the same answers and POPE takes the same client round trips.
"""
import dataclasses

import pytest

from repro.baselines import hope as RHOPE
from repro.baselines import paillier as RP
from repro.baselines import pope as RPOPE
from repro_torch.baselines import hope as THOPE
from repro_torch.baselines import paillier as TP
from repro_torch.baselines import pope as TPOPE

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

PKGS = {"reference": (RP, RHOPE, RPOPE), "port": (TP, THOPE, TPOPE)}


@pytest.fixture(scope="module")
def ref_keys():
    return RP.keygen(bits=512)     # small-but-real for test speed


def _port_keys(pub, priv):
    """The same key material as the port's dataclasses."""
    tpub = TP.PaillierPublicKey(**dataclasses.asdict(pub))
    return tpub, TP.PaillierPrivateKey(lam=priv.lam, mu=priv.mu, pub=tpub)


# ---------------------------------------------------------------------------
# the reference's cases, on both copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_paillier_cases(pkg):
    P = PKGS[pkg][0]
    pub, priv = P.keygen(bits=512)
    for m in (0, 1, 12345, pub.n - 1):
        assert P.decrypt(priv, P.encrypt(pub, m)) == m % pub.n
    ct = P.add(pub, P.encrypt(pub, 1234), P.encrypt(pub, 5678))
    assert P.decrypt(priv, ct) == 1234 + 5678
    assert P.decrypt(priv, P.cmul(pub, P.encrypt(pub, 111), 7)) == 777


@pytest.mark.parametrize("pkg", PKGS)
def test_hope_cases(pkg):
    HOPE = PKGS[pkg][1]
    ctx = HOPE.keygen(bits=512)
    for a, b in [(5, 3), (3, 5), (7, 7), (10**6, 1), (0, 10**6)]:
        out = HOPE.compare(ctx, HOPE.encrypt(ctx, a), HOPE.encrypt(ctx, b))
        assert out == (a > b) - (a < b), (a, b, out)
    ct_sum = HOPE.add(ctx, HOPE.encrypt(ctx, 40), HOPE.encrypt(ctx, 2))
    assert HOPE.compare(ctx, ct_sum, HOPE.encrypt(ctx, 41)) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_pope_cases(pkg):
    P, _, POPE = PKGS[pkg]
    client = POPE.PopeClient(bits=256)
    tr = POPE.Transport(latency_s=0.0)
    server = POPE.PopeServer(client, tr)
    cts = [client.encrypt(v) for v in [9, 2, 7, 1]]
    for c in cts:
        server.insert(c)
    assert server.compare(cts[0], cts[1]) == 1
    assert tr.rounds > 0, "POPE must consume client round trips"
    server = POPE.PopeServer(client, POPE.Transport(latency_s=0.0))
    for v in [5, 17, 3, 99, 42, 8]:
        server.insert(client.encrypt(v))
    got = server.range_query(client.encrypt(8), client.encrypt(50))
    assert sorted(P.decrypt(client.priv, c) for c in got) == [8, 17, 42]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_paillier_cross_decryption(ref_keys):
    """A reference ciphertext decrypts under the port's copy of the key,
    and a port ciphertext under the reference's; sums and scalar products
    mix the two."""
    pub, priv = ref_keys
    tpub, tpriv = _port_keys(pub, priv)
    for m in (0, 1, 12345, pub.n - 1, -5):
        assert TP.decrypt(tpriv, RP.encrypt(pub, m)) == m % pub.n
        assert RP.decrypt(priv, TP.encrypt(tpub, m)) == m % pub.n
    mixed = TP.add(tpub, RP.encrypt(pub, 40), TP.encrypt(tpub, 2))
    assert RP.decrypt(priv, RP.cmul(pub, mixed, 3)) == 126
    assert TP.cmul(tpub, mixed, 3) == RP.cmul(pub, mixed, 3)


def test_hope_compare_equals_reference_on_same_keys(ref_keys):
    pub, priv = ref_keys
    tpub, tpriv = _port_keys(pub, priv)
    rctx = RHOPE.HopeContext(pub=pub, priv=priv)
    tctx = THOPE.HopeContext(pub=tpub, priv=tpriv)
    vals = [0, 3, 5, 5, 41, 42, 10**6, -7]
    cts = [RHOPE.encrypt(rctx, v) for v in vals]
    for a in cts:
        for b in cts:
            assert THOPE.compare(tctx, a, b) == RHOPE.compare(rctx, a, b)
    ct_sum = THOPE.add(tctx, cts[4], THOPE.encrypt(tctx, 1))
    assert THOPE.compare(tctx, ct_sum, cts[5]) == \
        RHOPE.compare(rctx, ct_sum, cts[5]) == 0


def _pope_client(POPE, pub, priv):
    client = POPE.PopeClient.__new__(POPE.PopeClient)
    client.pub, client.priv = pub, priv
    return client


def test_pope_answers_and_rounds_equal_reference(ref_keys):
    """The same ciphertexts through both servers: the same compares,
    range answers (as ciphertexts) and client round-trip counts."""
    pub, priv = ref_keys
    rclient = _pope_client(RPOPE, pub, priv)
    tclient = _pope_client(TPOPE, *_port_keys(pub, priv))
    vals = [5, 17, 3, 99, 42, 8, 17, 60, 1, 33]
    cts = [RP.encrypt(pub, v) for v in vals]
    rt, tt = RPOPE.Transport(latency_s=0.0), TPOPE.Transport(latency_s=0.0)
    rs, ts = RPOPE.PopeServer(rclient, rt), TPOPE.PopeServer(tclient, tt)
    for c in cts:
        rs.insert(c)
        ts.insert(c)
    for lo, hi in [(8, 50), (0, 100), (17, 17), (61, 98)]:
        clo, chi = RP.encrypt(pub, lo), RP.encrypt(pub, hi)
        got, want = ts.range_query(clo, chi), rs.range_query(clo, chi)
        assert got == want
        assert sorted(TP.decrypt(tclient.priv, c) for c in got) == \
            sorted(v for v in vals if lo <= v <= hi)
        assert tt.rounds == rt.rounds
    for a, b in [(0, 1), (1, 6), (3, 3)]:
        assert ts.compare(cts[a], cts[b]) == rs.compare(cts[a], cts[b])
    assert tt.rounds == rt.rounds > 0
    assert ts.sorted == rs.sorted
