"""FAE tables (Alg. 3, perturbation-aware encryption) through the port's
engine against the reference.

A FAE table is `Table.from_arrays(..., fae=True)`: every column, pad
rows included, is encrypted with `encrypt_fae`, and the engine orders
it with Alg. 4's strict comparator.  The port's table is built from the
reference's own draws (`samples={column: (u, e0, e1, pert, e_m)}`), so
its ciphertexts are byte-equal to the reference's, and then every
answer must be equal too: scan and indexed reads, TopK/OrderBy (the
tie order is a deterministic function of the ciphertexts), the sorted
index, a `QueryServer` batch, inserts (EncBasic, as the reference
encrypts them), deletes and compaction on a FAE base, sort-merge joins,
and Finding F2's flip share and τ-probe rate (tests/test_system.py).
Both at test-bfv and at test-ckks, where τ = 2^-6 is close to the
perturbation's spread (ε = 0.01 a side), so answers near a bound follow
the perturbed values; the two packages must still agree exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import db as RDB
from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.core.compare import next_pow2
from repro.db import plan as RP
from repro.db import table as RT
from repro_torch import db as TDB
from repro_torch.core import compare as TC
from repro_torch.db import plan as TP

from test_torch_core import ct_to_torch, jitted_ref, n_, ref_encrypt_samples
from test_torch_join import Side, _same_join, _want_pairs, gadget_keys
from test_torch_write import (BATCH_STATS, COMPACTION, _same_ct, _same_index,
                              _same_result, _samples, _zero_pads)
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


PROFILES = ["test-bfv", "test-ckks"]
GRID = 0.25          # float lattice (>> the perturbation's 0.02 spread)
EPS_BAND = 0.3       # one lattice step either side, not two
N_BASE = 20          # every case: 20 base rows (32 slots), 5 inserted


def fae_samples(ref_ks, data, key):
    """The (u, e0, e1, pert, e_m) the reference's FAE ingest draws per
    column of `data` (padded to a power of two) under `key`:
    `encrypt_fae` splits `column_key(key, column)` into (k_pert, k_em,
    k_enc) and `_encrypt_payload` splits k_enc into (k_u, k_e0, k_e1)."""
    rp = ref_ks.params
    shape = (next_pow2(len(next(iter(data.values())))),)
    out = {}
    for c in data:
        k_pert, k_em, k_enc = jax.random.split(RT.column_key(key, c), 3)
        pert = jax.random.uniform(k_pert, shape, dtype=jnp.float64,
                                  minval=-rp.epsilon, maxval=rp.epsilon)
        e_m = jax.random.randint(k_em, shape, -rp.noise_bound,
                                 rp.noise_bound + 1, dtype=jnp.int64)
        out[c] = tuple(np.asarray(x) for x in (
            *ref_encrypt_samples(rp, k_enc, shape), pert, e_m))
    return out


class Fae:
    """A reference FAE table and the port's, built from the reference's
    draws (the port's own ingest path), written together."""

    def __init__(self, profile, seed=1):
        self.ref_ks, self.ks = gadget_keys(profile)
        self.ckks = profile == "test-ckks"
        rng = np.random.default_rng(seed)
        ints = rng.choice(np.arange(-60, 60), N_BASE, replace=False)
        self.data = {"v": self.vals(ints), "w": self.vals(ints // 8)}
        key = jax.random.PRNGKey(seed)
        self.ref = RDB.Table.from_arrays(self.ref_ks, "t", self.data, key,
                                         fae=True)
        self.t = TDB.Table.from_arrays(
            self.ks, "t", self.data, 0, fae=True,
            samples=fae_samples(self.ref_ks, self.data, key))
        self.t.zero_pad_rows = _zero_pads(self.ref_ks)
        self._seed = 100 * seed

    def vals(self, ints):
        ints = np.asarray(ints)
        return ints * GRID if self.ckks else ints.astype(np.int64)

    def enc(self, v):
        self._seed += 1
        m = jnp.asarray(float(v) if self.ckks else int(v))
        ct = RE.encrypt(self.ref_ks, m, jax.random.PRNGKey(self._seed))
        return ct, ct_to_torch(ct)

    def plans(self):
        """(name, reference plan, port plan): Range on v, Eq on w at the
        native τ (and an ε band on floats), And/Not, Or."""
        d, eps = self.data, (EPS_BAND if self.ckks else None)
        lo, hi = np.percentile(d["v"], [25, 70])
        (r_lo, t_lo), (r_hi, t_hi) = self.enc(lo), self.enc(hi)
        (r_x, t_x), (r_y, t_y) = self.enc(d["w"][3]), self.enc(d["w"][11])
        plans = [
            ("range", RP.Range("v", r_lo, r_hi), TP.Range("v", t_lo, t_hi)),
            ("eq", RP.Eq("w", r_x), TP.Eq("w", t_x)),
            ("and_not", RP.And(RP.Range("v", r_lo, r_hi),
                               RP.Not(RP.Eq("w", r_y, eps=eps))),
             TP.And(TP.Range("v", t_lo, t_hi),
                    TP.Not(TP.Eq("w", t_y, eps=eps)))),
            ("or", RP.Or(RP.Eq("w", r_x, eps=eps), RP.Range("v", r_lo, r_hi)),
             TP.Or(TP.Eq("w", t_x, eps=eps), TP.Range("v", t_lo, t_hi)))]
        if self.ckks:
            plans.append(("eq_eps", RP.Eq("w", r_y, eps=EPS_BAND),
                          TP.Eq("w", t_y, eps=EPS_BAND)))
        return plans

    def indexes(self):
        return ({c: RDB.SortedIndex.build(self.ref_ks, self.ref, c)
                 for c in ("v", "w")},
                {c: TDB.SortedIndex.build(self.ks, self.t, c)
                 for c in ("v", "w")})

    def same_reads(self, ref_ix, ix, plans=None):
        for name, ref_q, q in plans or self.plans():
            for rix, tix in (({}, {}), (ref_ix, ix)):
                _same_result(TDB.execute(self.ks, self.t, q, indexes=tix),
                             RDB.execute(self.ref_ks, self.ref, ref_q,
                                         indexes=rix))

    def same_columns(self):
        assert self.t.n_rows == self.ref.n_rows
        for c, ct in self.ref.columns.items():
            _same_ct(self.t.columns[c], ct)


@functools.lru_cache(maxsize=None)
def _fae(profile):
    """One read-only FAE table pair and its indexes per profile (the
    write case builds its own)."""
    p = Fae(profile)
    return p, p.indexes()


# ---------------------------------------------------------------------------
# the table: FAE ingest from the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_fae_table_equals_reference(profile):
    """Every column, pad rows included, byte-equal to the reference's FAE
    table; the columns decrypt to the data within the perturbation
    (BFV: exactly).  A 3-tuple under fae=True draws pert and e_m from
    the column's stream; a 5-tuple without fae, or any other length, is
    refused."""
    p, _ = _fae(profile)
    p.same_columns()
    got = p.t.decrypt_column(p.ks, "v", include_padding=True)
    want = np.asarray(p.ref.decrypt_column(p.ref_ks, "v",
                                           include_padding=True))
    assert np.array_equal(got, want)
    if p.ckks:
        assert np.abs(got[:N_BASE] - p.data["v"]).max() < 0.011
    else:
        assert np.array_equal(got[:N_BASE], p.data["v"])
    data = {"v": p.data["v"]}
    drawn = fae_samples(p.ref_ks, data, jax.random.PRNGKey(5))["v"]
    own = TDB.Table.from_arrays(p.ks, "t", data, 0, fae=True,
                                samples={"v": drawn[:3]})
    assert not np.array_equal(n_(own.columns["v"].c0), p.t.columns["v"].c0)
    for bad, fae in ((drawn, False), (drawn[:4], True), (drawn[:2], True)):
        with pytest.raises(ValueError, match="samples"):
            TDB.Table.from_arrays(p.ks, "t", data, 0, fae=fae,
                                  samples={"v": bad})


# ---------------------------------------------------------------------------
# reads: scans, the sorted index, order stages, a served batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_fae_reads_and_index_match_reference(profile):
    """Each index (permutation, sorted ciphertexts, compare counts) and
    every plan scanned and indexed: row ids, masks and ExecStats.  At
    test-bfv the answers equal the plaintext's (Finding F2)."""
    p, (ref_ix, ix) = _fae(profile)
    for c in ("v", "w"):
        _same_index(ix[c], ref_ix[c])
    p.same_reads(ref_ix, ix)
    if not p.ckks:
        v, w = p.data["v"], p.data["w"]
        lo, hi = np.percentile(v, [25, 70])
        got = TDB.execute(p.ks, p.t, p.plans()[0][2], indexes=ix)
        assert np.array_equal(got.row_ids, np.nonzero((v >= lo)
                                                      & (v <= hi))[0])
        got = TDB.execute(p.ks, p.t, p.plans()[1][2])
        assert np.array_equal(got.row_ids, np.nonzero(w == w[3])[0])


@pytest.mark.parametrize("profile", PROFILES)
def test_fae_order_matches_reference(profile):
    """TopK and OrderBy (descending, with a limit) on the tie-heavy FAE
    column: Alg. 4 orders each tie class by its ciphertexts, and the
    row ids equal the reference's; the values follow the plaintext's
    order."""
    p, _ = _fae(profile)
    name, ref_where, where = p.plans()[0]
    w = p.data["w"]
    for ref_q, q in (
            (RP.Query(where=ref_where, top_k=RP.TopK("w", 4)),
             TP.Query(where=where, top_k=TP.TopK("w", 4))),
            (RP.Query(where=ref_where, order_by=RP.OrderBy("w", True),
                      limit=RP.Limit(6)),
             TP.Query(where=where, order_by=TP.OrderBy("w", True),
                      limit=TP.Limit(6)))):
        got = TDB.execute(p.ks, p.t, q)
        _same_result(got, RDB.execute(p.ref_ks, p.ref, ref_q))
        vals = w[got.row_ids]
        assert np.array_equal(vals, np.sort(vals)[::-1])


@pytest.mark.parametrize("profile", PROFILES)
def test_fae_query_server_matches_reference(profile):
    """One `QueryServer` batch over the FAE table and its indexes:
    every answer and the batch's counters."""
    p, (ref_ix, ix) = _fae(profile)
    plans = p.plans()
    ref_srv = RDB.QueryServer(p.ref_ks, p.ref, indexes=ref_ix,
                              batch=len(plans))
    srv = TDB.QueryServer(p.ks, p.t, indexes=ix, batch=len(plans))
    ids = [(ref_srv.submit(r), srv.submit(q)) for _, r, q in plans]
    want, got = ref_srv.run(), srv.run()
    for rq, tq in ids:
        _same_result(got[tq], want[rq])
    assert len(srv.batch_log) == len(ref_srv.batch_log) == 1
    for f in BATCH_STATS:
        assert (getattr(srv.batch_log[0], f)
                == getattr(ref_srv.batch_log[0], f)), f


# ---------------------------------------------------------------------------
# writes on a FAE base, joins, Finding F2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_fae_writes_and_compaction_match_reference(profile):
    """Inserts into a FAE table encrypt EncBasic, as the reference's do
    (the reference's samples injected), a base row is deleted, reads
    over base ∪ delta (scan and indexed), compaction into both indexes,
    the reads again: every answer, CompactionStats, the merged indexes
    and the folded columns."""
    p = Fae(profile, seed=2)
    ref_ix, ix = p.indexes()
    ints = np.array([7, -33, 7, 50, -2])
    data = {"v": p.vals(ints), "w": p.vals(ints // 8)}
    key = jax.random.PRNGKey(21)
    want = p.ref.insert(p.ref_ks, data, key)
    got = p.t.insert(p.ks, data, 0, samples=_samples(p.ref_ks, data, key))
    assert np.array_equal(got, want)
    _same_ct(p.t.delta.columns["v"], p.ref.delta.columns["v"])
    assert p.t.delete([4]) == p.ref.delete([4]) == 1
    reads = p.plans()[:2]
    p.same_reads(ref_ix, ix, reads)
    want = RDB.compact(p.ref_ks, p.ref, ref_ix)
    got = TDB.compact(p.ks, p.t, ix)
    for f in COMPACTION:
        assert getattr(got, f) == getattr(want, f), f
    for c in ("v", "w"):
        _same_index(ix[c], ref_ix[c])
    p.same_columns()
    p.same_reads(ref_ix, ix, reads)


@pytest.mark.parametrize("profile", PROFILES)
def test_fae_join_matches_reference(profile):
    """A sort-merge join of the FAE tie-heavy key against an EncBasic
    table of its distinct values (the FAE side's index reused, the other
    built by the join): pairs, masks and JoinStats equal the reference's
    and the plaintext's (an ε band on floats)."""
    p, (ref_ix, ix) = _fae(profile)
    w = p.data["w"]
    keys = np.unique(w)
    right = Side(p.ref_ks, "R", {"w": keys}, 9)
    eps = EPS_BAND if p.ckks else None
    ref_j = RP.Join(None, None, on="w", eps=eps)
    j = TP.Join(None, None, on="w", eps=eps)
    want = RDB.execute_join(p.ref_ks, p.ref, right.ref, ref_j,
                            strategy="sort_merge",
                            left_indexes={"w": ref_ix["w"]})
    got = TDB.execute_join(p.ks, p.t, right.t, j, strategy="sort_merge",
                           left_indexes={"w": ix["w"]})
    _same_join(got, want)
    assert got.stats.build_compares > 0
    assert np.array_equal(got.pairs, _want_pairs(w, keys, eps=eps))


@pytest.mark.parametrize("profile", PROFILES)
def test_fae_f2_rates_match_reference(profile):
    """Finding F2 on 256 pairs of FAE encryptions of one value: the
    port's Alg. 4 outcomes and τ-decodes equal the reference's on the
    same ciphertexts, so do the flip share and the τ-probe rate; EncBasic
    ties decode to 0.  At test-bfv the τ-probe still sees the ties (the
    perturbation is ~1 % of τ); at test-ckks (τ = 2^-6, ε = 0.01) some
    pairs sit outside τ."""
    ref_ks, ks = gadget_keys(profile)
    value = 7.0 if profile == "test-ckks" else 7
    col = jnp.full((256,), value)
    f1, f2 = (RE.encrypt_fae(ref_ks, col, jax.random.PRNGKey(s))
              for s in (3, 4))
    b1, b2 = (RE.encrypt(ref_ks, col, jax.random.PRNGKey(s)) for s in (1, 2))
    t1, t2 = ct_to_torch(f1), ct_to_torch(f2)
    flips = n_(TC.compare_fae(ks, t1, t2))
    probe = n_(TC.compare(ks, t1, t2))
    assert np.array_equal(flips, jitted_ref(ref_ks, RC.compare_fae)(f1, f2))
    assert np.array_equal(probe, jitted_ref(ref_ks, RC.compare)(f1, f2))
    control = n_(TC.compare(ks, ct_to_torch(b1), ct_to_torch(b2)))
    assert float((control == 0).mean()) == 1.0
    share, rate = float(flips.mean()), float((probe == 0).mean())
    assert 0.1 < share < 0.9, share      # tests/test_system.py's bounds
    if profile == "test-bfv":
        assert rate > 0.9, rate
    else:
        assert 0.5 < rate < 1.0, rate
