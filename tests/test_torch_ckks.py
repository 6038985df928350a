"""Float (CKKS) columns through the port's engine against the reference.

What the other port files leave out under CKKS: the write path
(inserts, deletes, updates, ε-band reads over base ∪ delta, scan and
indexed, compaction; after `tests/test_db_mutations.py`), sharded float
tables at S ∈ {1, 2, 4} (ε-band Eq, Range, TopK; after the ckks cases
of `tests/test_db_shard.py`), a `QueryServer` batch of float lanes each
with its own decode threshold, and the paper-ckks profile's host
arithmetic and one compare at n = 16,384.  Everything runs on the
session's test-ckks KeySet (`tests/conftest.py`), bridged: reference
tables and trapdoors are bridged into the port, the port's inserts take
the reference's encryption samples and pad rows, so every ciphertext,
answer and counter must be equal, with no tolerance.  The `gpu` cases
hold the float path's kernel shapes at n = 16,384 against their plain
versions on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro.core import ckks as RCK
from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.core import ring as RR
from repro.core.keys import KeySet as RefKeySet
from repro.core.params import make_params as ref_make_params
from repro.db import plan as RP
from repro_torch import db as TDB
from repro_torch.core import ckks as TCK
from repro_torch.core import compare as TC
from repro_torch.core import encrypt as TE
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import make_params as torch_make_params
from repro_torch.db import plan as TP

from conftest import get_scheme_ks
from test_torch_core import ct_to_torch, jitted_ref, ks_to_torch, n_
from test_torch_join import Scheme, Side
from test_torch_shard import STATS as SHARD_STATS
from test_torch_shard import _ref_zeros
from test_torch_write import (BATCH_STATS, COMPACTION, _same_index,
                              _same_result, _same_state, _samples, _zero_pads)
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


GRID = 0.25          # float lattice (>> test-ckks equality tolerance)
EPS_BAND = 0.3       # one lattice step either side, not two
N_BASE = 12          # every write case: 12 base rows, 5 inserted


@functools.lru_cache(maxsize=None)
def _bridged(profile):
    """The session's reference KeySet (tests/conftest.py) and its key
    material as a port KeySet on the CPU."""
    ref_ks = get_scheme_ks(profile)
    return ref_ks, ks_to_torch(ref_ks)


class Floats(Scheme):
    """`test_torch_join.Scheme` (lattice values, trapdoors bridged) on
    the session's test-ckks KeySet."""

    def __init__(self):
        self.ref_ks, self.ks = _bridged("test-ckks")
        self.ckks = True
        self._seed = 700


class FloatPair:
    """A reference float table and its bridged port twin, written
    together (`test_torch_write.Pair` on CKKS keys)."""

    def __init__(self, ints, seed):
        self.sc = Floats()
        self.ref_ks, self.ks = self.sc.ref_ks, self.sc.ks
        self.vals = self.sc.vals(ints)
        self.ref = RDB.Table.from_arrays(self.ref_ks, "t", {"v": self.vals},
                                         jax.random.PRNGKey(seed))
        self.t = TDB.Table.from_ciphertexts(
            "t", {c: ct_to_torch(ct) for c, ct in self.ref.columns.items()},
            self.ref.n_rows, zero_pad_rows=_zero_pads(self.ref_ks))

    def insert(self, ints, seed):
        data = {"v": self.sc.vals(ints)}
        key = jax.random.PRNGKey(seed)
        want = self.ref.insert(self.ref_ks, data, key)
        got = self.t.insert(self.ks, data, 7,
                            samples=_samples(self.ref_ks, data, key))
        assert np.array_equal(got, want)
        self.vals = np.concatenate([self.vals, data["v"]])
        return got

    def delete(self, rows):
        assert self.t.delete(rows) == self.ref.delete(rows)

    def plans(self, target, lo, hi):
        """(name, reference plan, port plan, plaintext truth over the
        global ids): an ε-band Eq, an ε-inclusive Range, a plain Range
        with off-lattice bounds."""
        v, sc = self.vals, self.sc
        (r_x, t_x), (r_lo, t_lo), (r_hi, t_hi) = (
            sc.enc(x) for x in (target, lo - GRID / 2, hi + GRID / 2))
        alive = self.t.alive
        return [
            ("eq_eps", RP.Eq("v", r_x, eps=EPS_BAND),
             TP.Eq("v", t_x, eps=EPS_BAND),
             (np.abs(v - target) <= EPS_BAND) & alive),
            ("range_eps", RP.Range("v", r_lo, r_hi, eps=GRID),
             TP.Range("v", t_lo, t_hi, eps=GRID),
             (v > lo - 3 * GRID / 2) & (v < hi + 3 * GRID / 2) & alive),
            ("range", RP.Range("v", r_lo, r_hi), TP.Range("v", t_lo, t_hi),
             (v >= lo) & (v <= hi) & alive)]

    def indexes(self):
        return ({"v": RDB.SortedIndex.build(self.ref_ks, self.ref, "v")},
                {"v": TDB.SortedIndex.build(self.ks, self.t, "v")})

    def same_reads(self, plans, ref_ix, ix):
        for name, ref_q, q, want in plans:
            for rix, tix in (({}, {}), (ref_ix, ix)):
                got = TDB.execute(self.ks, self.t, q, indexes=tix)
                _same_result(got, RDB.execute(self.ref_ks, self.ref, ref_q,
                                              indexes=rix))
                assert np.array_equal(got.mask, want), name


def _base(seed):
    rng = np.random.default_rng(seed)
    ints = rng.choice(np.arange(0, 80), N_BASE, replace=False)
    ints[[3, 7]] = ints[0] + 1               # one lattice step from row 0
    return ints


# ---------------------------------------------------------------------------
# the write path on float columns
# ---------------------------------------------------------------------------

def test_float_writes_keep_table_state_equal():
    """Insert (a delta run of 8 slots, 3 of them encryptions of 0),
    delete, update (the run re-padded around its new row): ids, masks,
    the union scan view, every ciphertext and the decrypted floats equal
    the reference's."""
    p = FloatPair(_base(1), 1)
    p.insert([5, 40, 2, 7, 7], 11)
    p.delete([0, N_BASE + 1])
    _same_state(p)
    key = jax.random.PRNGKey(13)
    data = {"v": p.sc.vals([50])}
    want = p.ref.update(p.ref_ks, [1], data, key)
    got = p.t.update(p.ks, [1], data, 0,
                     samples=_samples(p.ref_ks, data, key))
    assert np.array_equal(got, want) and got.tolist() == [N_BASE + 5]
    _same_state(p)
    dec = p.t.decrypt_column(p.ks, "v")
    assert np.abs(dec - np.concatenate([p.vals, data["v"]])).max() < \
        TCK.equality_tolerance(p.ks.params)


@pytest.mark.parametrize("use_index", [False, True], ids=["scan", "indexed"])
def test_union_float_reads_match_reference(use_index):
    """ε-band Eq, ε-inclusive and plain Ranges over base ∪ delta with a
    tombstone, the band's neighbours in base and in the delta run
    (`test_db_mutations.py`'s ε-band case: the answer does not care
    where a row lives): rows, masks, ExecStats (delta-run builds
    included), the delta run's own index, and the plaintext."""
    p = FloatPair(_base(3), 3)
    ref_ix, ix = p.indexes()
    base0 = int(p.vals[0] / GRID)
    p.insert([base0, base0 + 1, 60, 5, 33], 31)
    p.delete([2])
    plans = p.plans(p.vals[0], 10 * GRID, 40 * GRID)
    for name, ref_q, q, want in plans:
        tix, rix = (ix, ref_ix) if use_index else ({}, {})
        got = TDB.execute(p.ks, p.t, q, indexes=tix)
        _same_result(got, RDB.execute(p.ref_ks, p.ref, ref_q, indexes=rix))
        assert np.array_equal(got.mask, want), name
    if use_index:
        _same_index(p.t.delta_index(p.ks, "v"),
                    p.ref.delta_index(p.ref_ks, "v"))


def test_float_compaction_matches_reference():
    """Merge network, not a rebuild, on a float column: CompactionStats,
    the merged index (perm and ciphertexts), the folded base, the reads
    before and after (scan and indexed), and a no-op second pass."""
    p = FloatPair(_base(5), 5)
    ref_ix, ix = p.indexes()
    p.insert([5, 61, 3, 77, 21], 51)
    p.delete([4])
    plans = p.plans(p.vals[N_BASE + 1], 4 * GRID, 30 * GRID)
    p.same_reads(plans, ref_ix, ix)
    want = RDB.compact(p.ref_ks, p.ref, ref_ix)
    got = TDB.compact(p.ks, p.t, ix)
    for f in COMPACTION:
        assert getattr(got, f) == getattr(want, f), f
    assert 0 < got.merge_compares < got.rebuild_compares
    _same_index(ix["v"], ref_ix["v"])
    _same_state(p)
    assert np.array_equal(p.vals[ix["v"].perm], np.sort(p.vals))
    p.same_reads(plans, ref_ix, ix)
    again = TDB.compact(p.ks, p.t, ix)
    assert again.merge_compares == 0 and again.n_delta == 0


def test_query_server_float_writes_match_reference():
    """Float queries see exactly the writes submitted before them
    (insert, delete, update on the queue), with ε-band and plain lanes
    in one batch: results, MutationResults and BatchStats."""
    p = FloatPair(_base(4), 4)
    ref_ix, ix = p.indexes()
    ref_srv = RDB.QueryServer(p.ref_ks, p.ref, indexes=ref_ix, batch=3)
    srv = TDB.QueryServer(p.ks, p.t, indexes=ix, batch=3)
    data, key = {"v": p.sc.vals([6, 12, 4, 9, 15])}, jax.random.PRNGKey(41)
    eq = p.plans(p.vals[0], 4 * GRID, 30 * GRID)
    ops = [("q", eq[0]), ("ins", None), ("q", eq[1]), ("q", eq[2]),
           ("del", [0]), ("q", eq[0]), ("upd", [2])]
    ids, ref_ids = [], []
    for kind, q in ops:
        if kind == "q":
            ref_ids.append(ref_srv.submit(q[1]))
            ids.append(srv.submit(q[2]))
        elif kind == "ins":
            ref_ids.append(ref_srv.submit_insert(data, key))
            ids.append(srv.submit_insert(
                data, samples=_samples(p.ref_ks, data, key)))
        elif kind == "del":
            ref_ids.append(ref_srv.submit_delete(q))
            ids.append(srv.submit_delete(q))
        else:
            k2, d2 = jax.random.PRNGKey(42), {"v": p.sc.vals([11])}
            ref_ids.append(ref_srv.submit_update(q, d2, k2))
            ids.append(srv.submit_update(q, d2,
                                         samples=_samples(p.ref_ks, d2, k2)))
    assert ids == ref_ids
    want, got = ref_srv.run(), srv.run()
    for qid, (kind, _) in zip(ids, ops):
        if kind == "q":
            _same_result(got[qid], want[qid])
        else:
            assert got[qid].kind == want[qid].kind
            assert np.array_equal(got[qid].row_ids, want[qid].row_ids)
            assert got[qid].deleted == want[qid].deleted
    assert len(srv.batch_log) == len(ref_srv.batch_log)
    for g, w in zip(srv.batch_log, ref_srv.batch_log):
        for f in BATCH_STATS:
            assert getattr(g, f) == getattr(w, f), f
    _same_state(p)


# ---------------------------------------------------------------------------
# the batched server: every float lane with its own τ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True])
def test_query_server_float_lanes_own_tau(indexed):
    """One batch of float queries, each leaf with its own ε (so its own
    decode threshold; two at the profile's native τ), scanned in one
    fused pass or searched in one lane-batched probe: results and
    BatchStats equal the reference's, answers the plaintext's, each
    equal to its own `execute`."""
    p = FloatPair(_base(6), 6)
    ref_ix, ix = p.indexes() if indexed else ({}, {})
    v, sc = p.vals, p.sc
    specs = [("eq", p.vals[0], 0.3), ("eq", p.vals[5], 0.8),
             ("eq", p.vals[2], None), ("range", (8, 50), None),
             ("range", (20, 30), 0.5), ("range", (0, 12), 1.2)]
    queries = []
    for kind, x, eps in specs:
        if kind == "eq":
            r, t = sc.enc(x)
            want = np.abs(v - x) <= (eps if eps else 0.0)
            queries.append((RP.Eq("v", r, eps=eps), TP.Eq("v", t, eps=eps),
                            want))
        else:
            lo, hi = x[0] * GRID - GRID / 2, x[1] * GRID + GRID / 2
            (r_lo, t_lo), (r_hi, t_hi) = sc.enc(lo), sc.enc(hi)
            w = eps or 0.0
            queries.append((RP.Range("v", r_lo, r_hi, eps=eps),
                            TP.Range("v", t_lo, t_hi, eps=eps),
                            (v > lo - w) & (v < hi + w)))
    taus = {TCK.eps_to_tau(p.ks.params, e) if e is not None
            else p.ks.params.tau for _, _, e in specs}
    assert len(taus) == len(specs) - 1           # two at the native τ
    ref_srv = RDB.QueryServer(p.ref_ks, p.ref, indexes=ref_ix, batch=8)
    srv = TDB.QueryServer(p.ks, p.t, indexes=ix, batch=8)
    ref_ids = [ref_srv.submit(rq) for rq, _, _ in queries]
    ids = [srv.submit(tq) for _, tq, _ in queries]
    want, got = ref_srv.run(), srv.run()
    assert ids == ref_ids and len(srv.batch_log) == 1
    for qid, (_, tq, truth) in zip(ids, queries):
        _same_result(got[qid], want[qid])
        assert np.array_equal(got[qid].mask, truth)
        assert np.array_equal(got[qid].row_ids, TDB.execute(
            p.ks, p.t, tq, indexes=ix).row_ids)
    for f in ("queries", "eval_calls", "scan_compares", "index_compares"):
        assert getattr(srv.batch_log[0], f) == getattr(ref_srv.batch_log[0],
                                                       f), f


# ---------------------------------------------------------------------------
# sharded float tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _float_side():
    sc = Floats()
    ints = np.random.default_rng(12).integers(0, 60, 22)
    ints[[3, 9]] = ints[0]
    ints[17] = ints[0] + 1
    data = {"v": sc.vals(ints)}
    return sc, Side(sc.ref_ks, "f", data, 9), data


def _same_sharded(got, want):
    assert np.array_equal(got.row_ids, want.row_ids)
    assert np.array_equal(got.mask, want.mask)
    for f in SHARD_STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_float_queries_match_reference(S):
    """S logical shards of one float table (22 rows, duplicates and a
    lattice neighbour of row 0): an ε-band Eq, an ε-inclusive Range and
    TopK over it: rows, masks and ShardedExecStats equal the
    reference's, answers the plaintext's, the TopK values in order the
    unsharded plaintext's."""
    sc, side, data = _float_side()
    ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                      spec=RDB.ShardSpec.create(S))
    st = TDB.ShardedTable.from_table(
        sc.ks, side.t, spec=TDB.ShardSpec.create(S),
        pad_rows=_ref_zeros(sc.ref_ks, 0x5AAD))
    v = data["v"]
    (r_x, t_x), (r_lo, t_lo), (r_hi, t_hi) = (
        sc.enc(x) for x in (v[0], sc.bound(sc.vals(10), -1),
                            sc.bound(sc.vals(45), +1)))
    band = (v > 10 * GRID - 3 * GRID / 2) & (v < 45 * GRID + 3 * GRID / 2)
    plans = [
        (RP.Eq("v", r_x, eps=EPS_BAND), TP.Eq("v", t_x, eps=EPS_BAND),
         np.abs(v - v[0]) <= EPS_BAND),
        (RP.Range("v", r_lo, r_hi, eps=GRID),
         TP.Range("v", t_lo, t_hi, eps=GRID), band),
        (RP.Query(where=RP.Range("v", r_lo, r_hi, eps=GRID),
                  top_k=RP.TopK("v", 4)),
         TP.Query(where=TP.Range("v", t_lo, t_hi, eps=GRID),
                  top_k=TP.TopK("v", 4)), band)]
    for ref_q, q, truth in plans:
        got = TDB.execute(sc.ks, st, q)
        _same_sharded(got, RDB.execute(sc.ref_ks, ref, ref_q))
        assert np.array_equal(got.mask, truth)
    assert v[got.row_ids].tolist() == sorted(v[band].tolist(),
                                             reverse=True)[:4]
    if S > 1:
        assert got.stats.merge_compares > 0


# ---------------------------------------------------------------------------
# the paper-ckks profile: host arithmetic, and one compare at n = 16,384
# ---------------------------------------------------------------------------

def test_paper_ckks_host_arithmetic_matches_reference():
    """The paper profile's encode, ε -> τ, equality tolerance, operand
    headroom and the sentinel payload (`max_operand // 2` as an int64
    tensor under the CKKS payload, and its negative for top-k) equal
    the reference's; the sentinels' Eval stays inside Q/2 against every
    value of the float path, and each ε-band τ of the slice is ε·2^32
    exactly, above 2^30 (an int64 on the host)."""
    rp = ref_make_params("paper-ckks", mode="gadget")
    tp = torch_make_params("paper-ckks", mode="gadget")
    assert tp.qs == rp.qs and tp.Q == rp.Q
    for f in ("tau", "max_operand", "delta_enc", "scale",
              "gadget_digits_per_tower"):
        assert getattr(tp, f) == getattr(rp, f), f
    assert tp.scale * tp.delta_enc == 1 << 32
    assert TCK.equality_tolerance(tp) == RCK.equality_tolerance(rp) == 2**-7
    sentinel = tp.max_operand // 2
    x = np.array([0.0, GRID, 999.75, 1000.0, 1e6, 123.456, -2.25,
                  float(sentinel), -float(sentinel)])
    assert np.array_equal(n_(TCK.encode(tp, x)), np.asarray(RCK.encode(rp, x)))
    for eps in (0.0, 1e-9, GRID / 2, GRID + GRID / 2, 2 * GRID + GRID / 2,
                3.0, 1000.0):
        assert TCK.eps_to_tau(tp, eps) == RCK.eps_to_tau(rp, eps), eps
    for eps in (GRID + GRID / 2, 2 * GRID + GRID / 2):
        tau = TCK.eps_to_tau(tp, eps)
        assert type(tau) is int and tau == int(eps * 2**32) > 2**30
    for value in (sentinel, -sentinel):
        m = np.full(3, value, np.int64)
        got = TE._payload(tp, torch.as_tensor(m))
        assert got.dtype == torch.int64
        assert np.array_equal(n_(got),
                              np.asarray(RE._payload(rp, jnp.asarray(m))))
        assert int(got[0]) == value * tp.delta_enc
    assert tp.scale * tp.delta_enc * (sentinel + 1000) < tp.Q // 2


@functools.lru_cache(maxsize=None)
def _paper_ckks_keys():
    """Paper-ckks gadget keys from the port's keygen on the CPU, the same
    key material handed to a reference KeySet."""
    tks = torch_keygen(torch_make_params("paper-ckks", mode="gadget"), 21,
                       device="cpu")
    rp = ref_make_params("paper-ckks", mode="gadget")
    ref_ks = RefKeySet(params=rp, ring=RR.make_ring(rp),
                       **{k: jnp.asarray(n_(getattr(tks, k)))
                          for k in ("sk", "pk0", "pk1", "cek_gadget",
                                    "cek_gadget_ntt")}, cek=None)
    return ref_ks, tks


def test_paper_ckks_compare_matches_reference():
    """Four lanes at n = 16,384: the port's raw eval values (its plain
    path on the CPU) equal the reference's jitted ones on the same
    ciphertexts, and Alg. 2's signs the plaintext's, a lattice step
    apart and at equality."""
    ref_ks, tks = _paper_ckks_keys()
    a = np.array([0.0, 500.25, 999.75, 123.5])
    b = np.array([GRID, 500.0, 999.75, 1000.0])
    ct_a, ct_b = (TE.encrypt(tks, torch.as_tensor(x), 30 + i)
                  for i, x in enumerate((a, b)))
    ref_a, ref_b = (RE.Ciphertext(jnp.asarray(n_(ct.c0)),
                                  jnp.asarray(n_(ct.c1)))
                    for ct in (ct_a, ct_b))
    want = np.asarray(jitted_ref(ref_ks, RC.eval_value)(ref_a, ref_b))
    got = TC.eval_value(tks, ct_a, ct_b)
    assert np.array_equal(n_(got), want)
    assert np.array_equal(n_(TC.three_way(tks, got)), np.sign(a - b))


def test_paper_ckks_table_form_byte_split_equals_plain():
    """The gadget Eval kernel's arithmetic (`eval_coeff0_gadget_bytes_
    plain`: digit bytes, s32 runs flushed every FLUSH_WORDS words) in
    the table form the float path's scans and pair grids use at n =
    16,384: 3 atoms over 2 unique columns at a row offset, one bound per
    atom, and a tile of the largest digits (q - 1 everywhere), each
    equal to the plain Eval on the paper-ckks keys."""
    from repro_torch.core import sampling
    from repro_torch.kernels import cmp_eval as CK
    _, tks = _paper_ckks_keys()
    p = tks.params
    K, n = p.num_towers, p.n
    gen = sampling.make_generator(6, "cpu")
    cols = sampling.uniform_poly(p, gen, (2, 2, 12))       # [c0/c1, U, W]
    bounds = sampling.uniform_poly(p, gen, (2, 3))
    big = (tks.ring.q_arr - 1).expand(2, 1, 4, K, n).contiguous()
    args = (tks.cek_rev, tks.ring.q_arr[:, 0], p.scale,
            p.profile.gadget_log_base)
    for u0, u1, off, rows, sel, b0, b1 in (
            (cols[0], cols[1], 3, 8, [0, 1, 0], bounds[0], bounds[1]),
            (big[0], big[1], 0, 4, [0], big[0, :, 0], big[1, :, 0])):
        got = CK.eval_coeff0_gadget_bytes_plain(
            u0, u1, off, rows, sel, b0, b1, *args, cek_bytes=tks.cek_rev_bytes)
        assert torch.equal(got, CK.eval_coeff0_gadget_plain(
            u0, u1, off, rows, sel, b0, b1, *args))


# ---------------------------------------------------------------------------
# on the card: the float path's kernel shapes at n = 16,384
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_paper_ckks_gadget_eval_equals_plain(cuda):
    """The gadget Eval at n = 16,384 (its s32 sums flushed every 4,096
    words) in the float path's forms: a scan tile of 3 atoms over two
    unique columns at a row offset, the lane form with a bound per lane
    (sort stages, probes), and a tile of the largest digits; each equal
    to its plain version, one launch per unique column."""
    from repro_torch.core import sampling
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    ks = torch_keygen(torch_make_params("paper-ckks", mode="gadget"), 5,
                      device=cuda)
    p = ks.params
    K, n = p.num_towers, p.n
    gen = sampling.make_generator(6, cuda)
    cols = sampling.uniform_poly(p, gen, (2, 2, 96))     # [c0/c1, U, W]
    args = (ks.cek_rev, ks.ring.q_arr[:, 0], p.scale,
            p.profile.gadget_log_base)
    bounds = sampling.uniform_poly(p, gen, (2, 3))        # one per atom
    lanes = sampling.uniform_poly(p, gen, (2, 1, 40))
    per_lane = sampling.uniform_poly(p, gen, (2, 1, 40))  # one per lane
    big = (ks.ring.q_arr - 1).expand(2, 1, 64, K, n).contiguous()
    cases = [
        (cols[0], cols[1], 16, 64, [0, 1, 0], bounds[0], bounds[1], 2),
        (lanes[0], lanes[1], 0, 40, [0], per_lane[0], per_lane[1], 1),
        (big[0], big[1], 0, 64, [0], big[0, :, 0], big[1, :, 0], 1),
    ]
    for u0, u1, off, rows, sel, b0, b1, per in cases:
        before = _build.LAUNCHES["eval_coeff0_gadget"]
        got = CK.eval_coeff0_gadget(u0, u1, off, rows, sel, b0, b1, *args,
                                    cek_bytes=ks.cek_rev_bytes)
        assert _build.LAUNCHES["eval_coeff0_gadget"] == before + per
        want = CK.eval_coeff0_gadget_plain(u0, u1, off, rows, sel, b0, b1,
                                           *args)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_paper_ckks_multiplies_and_ntt_equal_plain(cuda):
    """The float path's key multiply (ingest and inserts), two-varying
    multiply (keygen's a⊛sk) and forward `ntt_br` (keygen's eval-domain
    CEK and key transforms) at n = 16,384, each equal to its plain
    version."""
    from repro_torch.core import sampling
    from repro_torch.kernels import ntt as NK
    ks = torch_keygen(torch_make_params("paper-ckks", mode="gadget"), 7,
                      device=cuda)
    p, ring = ks.params, ks.ring
    gen = sampling.make_generator(8, cuda)
    a = sampling.uniform_poly(p, gen, (819,))
    br, pairs = ks.key_br("pk0")
    assert torch.equal(NK.negacyclic_mul_ntt(a, br, ring, pairs),
                       NK.negacyclic_mul_ntt_plain(a, br, ring))
    x, y = (sampling.uniform_poly(p, gen) for _ in range(2))
    assert torch.equal(NK.negacyclic_mul(x, y, ring),
                       NK.negacyclic_mul_plain(x, y, ring))
    flat = ks.cek_gadget.reshape(-1, p.num_towers, p.n)
    assert torch.equal(NK.ntt_br(flat, ring), NK.ntt_br_plain(flat, ring))


@pytest.mark.gpu
def test_cuda_float_engine_equals_cpu(cuda):
    """A float table at paper-ckks on the card and the same ciphertexts
    on the CPU: an ε-band Eq and a Range, scanned and indexed, give the
    same rows, and the plaintext's."""
    ks = torch_keygen(torch_make_params("paper-ckks", mode="gadget"), 9,
                      device=cuda)
    rng = np.random.default_rng(10)
    vals = np.round(rng.uniform(0, 100, 40) / GRID) * GRID
    t = TDB.Table.from_arrays(ks, "f", {"v": vals}, 11)
    ks_cpu = type(ks).from_numpy(
        ks.params, device="cpu", cek_gadget=ks.cek_gadget.cpu().numpy(),
        **{k: getattr(ks, k).cpu().numpy() for k in ("sk", "pk0", "pk1")})
    t_cpu = TDB.Table.from_ciphertexts(
        "f", {"v": TE.Ciphertext(t.columns["v"].c0.cpu(),
                                 t.columns["v"].c1.cpu())}, t.n_rows)
    x, lo, hi = float(vals[7]), 20 - GRID / 2, 60 + GRID / 2
    cts = [TE.encrypt(ks, v, 12 + i) for i, v in enumerate((x, lo, hi))]
    cpu = [TE.Ciphertext(c.c0.cpu(), c.c1.cpu()) for c in cts]
    for kk, tt, c in ((ks, t, cts), (ks_cpu, t_cpu, cpu)):
        ix = {"v": TDB.SortedIndex.build(kk, tt, "v")}
        for use in (None, ix):
            eq = TDB.execute(kk, tt, TP.Eq("v", c[0], eps=2 * GRID + GRID / 2),
                             indexes=use)
            rg = TDB.execute(kk, tt, TP.Range("v", c[1], c[2]), indexes=use)
            assert np.array_equal(eq.mask, np.abs(vals - x) <= 2.5 * GRID)
            assert np.array_equal(rg.mask, (vals >= lo) & (vals <= hi))
