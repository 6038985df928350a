"""Float (CKKS) columns on sharded tables against the reference.

What `test_torch_ckks.py` leaves out of the sharded engine under CKKS
(after the ckks cases of `tests/test_db_shard.py`,
`tests/test_db_mutations.py` and `tests/test_db_join.py`): the
`ShardedIndex` of a float column with duplicates and its ε-band point
lookups, a `ShardedQueryServer` batch of indexed float lanes each with
its own decode threshold, float inserts, deletes and updates on a
`ShardedTable` with union reads and compaction (and a sharded server
with writes on its queue), the ε-band join over sharded sides with both
strategies, and a float table placed on a CPU shard mesh against the
unplaced one.  Everything runs on the session's test-ckks KeySet
(`tests/conftest.py`), bridged as `test_torch_ckks.py` bridges it: the
port's tables re-partition the reference's rows with the reference's
pad rows, its inserts take the reference's encryption samples, so every
ciphertext, answer and counter must be equal, with no tolerance.  Two
cases hold the compaction's and the index's memory repairs (each
temporary dies as soon as its last reader is done).  The `gpu` case
holds the sharded float phase's kernel shapes at n = 16,384 against
their plain versions on the card.
"""
import functools
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro.db import plan as RP
from repro.db.shard import table as RST
from repro_torch import db as TDB
from repro_torch.core import ckks as TCK
from repro_torch.db import plan as TP
from repro_torch.db.shard import executor as TSX
from repro_torch.db.shard import join as TSJ

from test_torch_ckks import EPS_BAND, GRID, Floats, _float_side
from test_torch_join import JOIN_STATS, Side, _same_ct, _want_pairs
from test_torch_shard import (BATCH_STATS, COMPACTION, _ref_zeros,
                              _same_result, _same_state)
from test_torch_write import _samples
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")

CPU = torch.device("cpu")
PAD_SEED = 0x5AAD                  # the reference's partition pads


def _sharded(S, side=None, spec=None):
    """(reference, port) S-shard tables over `side` (the 22-row float
    table by default), the port's padded and folded with the reference's
    encryptions of 0; fresh ones (the write cases mutate them)."""
    sc, base, _ = _float_side()
    side = side or base
    ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                      spec=RDB.ShardSpec.create(S))
    st = TDB.ShardedTable.from_table(
        sc.ks, side.t, spec=spec or TDB.ShardSpec.create(S),
        pad_rows=_ref_zeros(sc.ref_ks, PAD_SEED))
    st.fold_pad_rows = _ref_zeros(sc.ref_ks, RST._FOLD_PAD_SEED)
    return ref, st


@functools.lru_cache(maxsize=None)
def _shared(S):
    """`_sharded(S)` and both engines' ShardedIndex on v, shared by the
    read-only cases."""
    sc, _, _ = _float_side()
    ref, st = _sharded(S)
    return (ref, st, RDB.ShardedIndex.build(sc.ref_ks, ref, "v"),
            TDB.ShardedIndex.build(sc.ks, st, "v"))


def _float_plans(sc, v, target, lo, hi, eps):
    """(reference plan, port plan, plaintext truth): an ε-band Eq on
    `target` and a Range [lo, hi] (off-lattice bounds) widened by
    `eps`."""
    (r_x, t_x), (r_lo, t_lo), (r_hi, t_hi) = (
        sc.enc(x) for x in (target, lo - GRID / 2, hi + GRID / 2))
    return [(RP.Eq("v", r_x, eps=EPS_BAND), TP.Eq("v", t_x, eps=EPS_BAND),
             np.abs(v - target) <= EPS_BAND),
            (RP.Range("v", r_lo, r_hi, eps=eps),
             TP.Range("v", t_lo, t_hi, eps=eps),
             (v > lo - GRID / 2 - eps) & (v < hi + GRID / 2 + eps))]


# ---------------------------------------------------------------------------
# the fan-out index on a float column
# ---------------------------------------------------------------------------

def test_sharded_float_index_matches_reference():
    """ShardedIndex over 4 shards of a float column with duplicates
    (rows 3 and 9 equal row 0, row 17 a lattice step above): each
    shard's run (perm and ciphertexts) and its global ids in plaintext
    order, the build's
    compares, the fan-out search's positions and probe counts under a
    τ a lane, the ε-band point lookup and ε-inclusive range masks, and
    indexed execution, against the reference and the plaintext.  Each
    shard's run is a view of the stacked runs the probes read (the
    column's sorted rows are held once)."""
    sc, _, data = _float_side()
    v = data["v"]
    ref, st, want, got = _shared(4)
    assert got.build_compares == want.build_compares
    assert np.array_equal(got.counts, want.counts)
    for s, (g, w) in enumerate(zip(got.shards, want.shards)):
        assert np.array_equal(g.perm, w.perm)
        _same_ct(g.sorted_ct, w.sorted_ct)
        assert g.build_compares == w.build_compares
        assert np.all(np.diff(v[st.global_ids(s)[g.perm]]) >= 0)
        for half in ("c0", "c1"):
            assert (getattr(g.sorted_ct, half).untyped_storage().data_ptr()
                    == getattr(got._sorted, half).untyped_storage()
                    .data_ptr())
    from repro.db.index import _stack_cts as ref_stack
    from repro_torch.db.index import _stack_cts
    cts = [sc.enc(x) for x in (v[0], v[0], 10 * GRID, 45 * GRID)]
    strict = np.array([False, True, False, True])
    taus = np.array([TCK.eps_to_tau(sc.ks.params, e)
                     for e in (EPS_BAND, EPS_BAND, GRID, GRID)])
    pos = got.search(sc.ks, _stack_cts([t for _, t in cts]), strict, taus)
    assert np.array_equal(pos, want.search(
        sc.ref_ks, ref_stack([r for r, _ in cts]), strict, taus))
    assert np.array_equal(got.last_probe_counts, want.last_probe_counts)
    N = st.n_padded_per_shard
    r_x, t_x = cts[0]
    for g, w in zip(got.shard_masks_eq(sc.ks, t_x, N, eps=EPS_BAND),
                    want.shard_masks_eq(sc.ref_ks, r_x, N, eps=EPS_BAND)):
        assert np.array_equal(g, w)
    for g, w in zip(
            got.shard_masks_range(sc.ks, cts[2][1], cts[3][1], N, eps=GRID),
            want.shard_masks_range(sc.ref_ks, cts[2][0], cts[3][0], N,
                                   eps=GRID)):
        assert np.array_equal(g, w)
    for ref_q, q, truth in _float_plans(sc, v, v[0], 10 * GRID, 45 * GRID,
                                        GRID):
        res = TDB.execute(sc.ks, st, q, indexes={"v": got})
        _same_result(res, RDB.execute(sc.ref_ks, ref, ref_q,
                                      indexes={"v": want}))
        assert np.array_equal(res.mask, truth)
    assert got.search_compares == want.search_compares


# ---------------------------------------------------------------------------
# the batched server: indexed float lanes, each with its own τ
# ---------------------------------------------------------------------------

def test_sharded_server_float_lanes_own_tau():
    """One ShardedQueryServer batch over 4 shards: ε-band Eqs and
    ε-inclusive Ranges through the fan-out index, each leaf with its own
    ε (so its own τ; one at the native τ), and a TopK lane through the
    merge networks: rows, masks and ShardedExecStats of every query,
    ShardedBatchStats, each answer the plaintext's and equal to its own
    `execute`."""
    sc, _, data = _float_side()
    v = data["v"]
    ref, st, ref_ix, ix = _shared(4)
    specs = [("eq", v[0], 0.3), ("eq", v[5], 0.8), ("eq", v[2], None),
             ("range", (8, 40), 0.5), ("range", (20, 30), 1.2)]
    queries = []
    for kind, x, eps in specs:
        if kind == "eq":
            r, t = sc.enc(x)
            queries.append((RP.Eq("v", r, eps=eps), TP.Eq("v", t, eps=eps),
                            np.abs(v - x) <= (eps or 0.0)))
        else:
            lo, hi = x[0] * GRID - GRID / 2, x[1] * GRID + GRID / 2
            (r_lo, t_lo), (r_hi, t_hi) = sc.enc(lo), sc.enc(hi)
            queries.append((RP.Range("v", r_lo, r_hi, eps=eps),
                            TP.Range("v", t_lo, t_hi, eps=eps),
                            (v > lo - eps) & (v < hi + eps)))
    ref_rng, rng = queries[3][:2]
    band = queries[3][2]
    queries.append((RP.Query(where=ref_rng, top_k=RP.TopK("v", 2)),
                    TP.Query(where=rng, top_k=TP.TopK("v", 2)), band))
    taus = {TCK.eps_to_tau(sc.ks.params, e) if e is not None
            else sc.ks.params.tau for _, _, e in specs}
    assert len(taus) == len(specs)
    ref_srv = RDB.ShardedQueryServer(sc.ref_ks, ref, indexes={"v": ref_ix},
                                     batch=8)
    srv = TDB.ShardedQueryServer(sc.ks, st, indexes={"v": ix}, batch=8)
    ref_ids = [ref_srv.submit(rq) for rq, _, _ in queries]
    ids = [srv.submit(tq) for _, tq, _ in queries]
    want, got = ref_srv.run(), srv.run()
    assert ids == ref_ids and len(srv.batch_log) == 1
    for qid, (_, tq, truth) in zip(ids, queries):
        _same_result(got[qid], want[qid])
        assert np.array_equal(got[qid].mask, truth)
        assert np.array_equal(got[qid].row_ids, TDB.execute(
            sc.ks, st, tq, indexes={"v": ix}).row_ids)
    assert v[got[ids[-1]].row_ids].tolist() == sorted(
        v[band].tolist(), reverse=True)[:2]
    for f in BATCH_STATS:
        assert (getattr(srv.batch_log[0], f)
                == getattr(ref_srv.batch_log[0], f)), f
    assert srv.batch_log[0].index_compares > 0
    assert srv.batch_log[0].merge_compares > 0


# ---------------------------------------------------------------------------
# the write path on a sharded float table
# ---------------------------------------------------------------------------

def _route_samples(sc, st, data, key):
    """The reference's encryption samples of each receiving shard's
    chunk of an insert into `st` (routed as `ShardedTable.insert`
    routes it: `fold_in(key, s)` per shard)."""
    counts = st.route_counts(len(data["v"]))
    offs = np.concatenate([[0], np.cumsum(counts)])
    return {s: _samples(sc.ref_ks, {c: x[offs[s]:offs[s + 1]]
                                    for c, x in data.items()},
                        jax.random.fold_in(key, s))
            for s in range(st.num_shards) if counts[s]}


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_float_writes_and_compaction_match_reference(S):
    """Float inserts routed to the least-loaded shards' delta runs, a
    delete, an update, then an ε-band Eq or an ε-inclusive Range over
    base ∪ delta (scan and fan-out index), `compact` (each shard's index
    merge, the fold with its pad rows), the reads again: every stack,
    counter and answer equals the reference's and the plaintext's."""
    sc, _, data = _float_side()
    ref, st = _sharded(S)
    ref_ix = {"v": RDB.ShardedIndex.build(sc.ref_ks, ref, "v")}
    ix = {"v": TDB.ShardedIndex.build(sc.ks, st, "v")}
    v = data["v"]
    new = {"v": sc.vals([int(v[0] / GRID), int(v[0] / GRID) + 1, 33, 5])}
    key = jax.random.PRNGKey(61)
    samples = _route_samples(sc, st, new, key)
    assert np.array_equal(st.insert(sc.ks, new, samples=samples),
                          ref.insert(sc.ref_ks, new, key))
    assert st.delete([2]) == ref.delete([2]) == 1
    upd, key = {"v": sc.vals([int(v[0] / GRID) - 1])}, jax.random.PRNGKey(62)
    samples = _route_samples(sc, st, upd, key)
    assert np.array_equal(st.update(sc.ks, [4], upd, samples=samples),
                          ref.update(sc.ref_ks, [4], upd, key))
    allv = np.concatenate([v, new["v"], upd["v"]])
    _same_state(st, ref)
    assert np.abs(st.decrypt_column(sc.ks, "v") - allv).max() < \
        TCK.equality_tolerance(sc.ks.params)
    # the ε-band Eq and the Range as the two leaves of one plan: one
    # fused scan, or two fan-out searches plus each delta run's
    (r_eq, t_eq, w_eq), (r_rg, t_rg, w_rg) = _float_plans(
        sc, allv, v[0], 8 * GRID, 35 * GRID, GRID)
    ref_q, q, truth = RP.Or(r_eq, r_rg), TP.Or(t_eq, t_rg), w_eq | w_rg

    def same_reads():
        for rix, tix in (({}, {}), (ref_ix, ix)):
            got = TDB.execute(sc.ks, st, q, indexes=tix)
            _same_result(got, RDB.execute(sc.ref_ks, ref, ref_q,
                                          indexes=rix))
            assert np.array_equal(got.mask, truth & st.alive)
    same_reads()
    want = RDB.compact(sc.ref_ks, ref, ref_ix)
    got = TDB.compact(sc.ks, st, ix)
    for f in COMPACTION:
        assert getattr(got, f) == getattr(want, f), f
    assert got.merge_compares > 0 and not st.has_delta
    _same_state(st, ref)
    for s, (g, w) in enumerate(zip(ix["v"].shards, ref_ix["v"].shards)):
        assert np.array_equal(g.perm, w.perm)
        _same_ct(g.sorted_ct, w.sorted_ct)
        assert np.all(np.diff(allv[st.global_ids(s)[g.perm]]) >= 0)
    same_reads()


def test_sharded_server_float_writes_match_reference():
    """A ShardedQueryServer over 2 shards with writes on its queue (an
    ε-band Eq, an insert, a Range, a delete, the Eq again, then
    `compact()` and the Eq once more): every query sees exactly the
    writes submitted before it; results, MutationResults,
    ShardedBatchStats and CompactionStats equal the reference's."""
    sc, _, data = _float_side()
    v = data["v"]
    ref, st = _sharded(2)
    ref_ix = {"v": RDB.ShardedIndex.build(sc.ref_ks, ref, "v")}
    ix = {"v": TDB.ShardedIndex.build(sc.ks, st, "v")}
    eq, rng = _float_plans(sc, v, v[0], 8 * GRID, 35 * GRID, GRID)
    ref_srv = RDB.ShardedQueryServer(sc.ref_ks, ref, indexes=ref_ix, batch=2)
    srv = TDB.ShardedQueryServer(sc.ks, st, indexes=ix, batch=2)
    new, key = {"v": sc.vals([int(v[0] / GRID) + 1, 20, 7])}, \
        jax.random.PRNGKey(71)
    samples = _route_samples(sc, st, new, key)
    ids = [srv.submit(eq[1]), srv.submit_insert(new, samples=samples),
           srv.submit(rng[1]), srv.submit_delete([0]), srv.submit(eq[1])]
    ref_ids = [ref_srv.submit(eq[0]), ref_srv.submit_insert(new, key),
               ref_srv.submit(rng[0]), ref_srv.submit_delete([0]),
               ref_srv.submit(eq[0])]
    assert ids == ref_ids
    want, got = ref_srv.run(), srv.run()
    allv = np.concatenate([v, new["v"]])
    for i, qid in enumerate(ids):
        if i in (1, 3):
            assert got[qid].kind == want[qid].kind
            assert np.array_equal(got[qid].row_ids, want[qid].row_ids)
            assert got[qid].deleted == want[qid].deleted
        else:
            _same_result(got[qid], want[qid])
    alive = np.arange(len(allv)) != 0
    assert np.array_equal(got[ids[2]].mask, (allv > 8 * GRID - 3 * GRID / 2)
                          & (allv < 35 * GRID + 3 * GRID / 2))
    assert np.array_equal(got[ids[4]].mask,
                          (np.abs(allv - v[0]) <= EPS_BAND) & alive)
    assert len(srv.batch_log) == len(ref_srv.batch_log)
    for g, w in zip(srv.batch_log, ref_srv.batch_log):
        for f in BATCH_STATS:
            assert getattr(g, f) == getattr(w, f), f
    cw, cg = ref_srv.compact(), srv.compact()
    for f in COMPACTION:
        assert getattr(cg, f) == getattr(cw, f), f
    _same_state(st, ref)
    qid, rqid = srv.submit(eq[1]), ref_srv.submit(eq[0])
    _same_result(srv.run()[qid], ref_srv.run()[rqid])


def test_sharded_compaction_frees_old_index_and_stacks_before_fold():
    """Compaction lets each temporary die as soon as its last reader is
    done: when the fold builds a column's grown stack, the replaced
    ShardedIndex's stacked runs and every column stack already folded
    are freed (a stack of n = 16,384 rows is 512 KiB a row, so holding
    them all at once does not fit on one card)."""
    sc = Floats()
    rng = np.random.default_rng(3)
    data = {"v": sc.vals(rng.integers(0, 40, 16)),
            "aux": sc.vals(rng.integers(0, 40, 16))}
    side = Side(sc.ref_ks, "w", data, 5)
    st = TDB.ShardedTable.from_table(sc.ks, side.t,
                                     spec=TDB.ShardSpec.create(2))
    ix = {"v": TDB.ShardedIndex.build(sc.ks, st, "v")}
    new = {"v": sc.vals([1, 2, 3]), "aux": sc.vals([4, 5, 6])}
    st.insert(sc.ks, new, 9)
    old_index = weakref.ref(ix["v"]._sorted.c0)
    old_stacks = {c: weakref.ref(ct.c0.slabs[0])
                  for c, ct in st.columns.items()}
    seen, pads = [], st.fold_pad_rows

    def watching(ks, cname, count, salt):
        gc.collect()
        seen.append((cname, old_index() is None,
                     {c: r() is None for c, r in old_stacks.items()}))
        return pads(ks, cname, count, salt)
    st.fold_pad_rows = watching
    TDB.compact(sc.ks, st, ix)
    assert [c for c, _, _ in seen] == ["v", "v", "aux", "aux"]
    assert all(index_freed for _, index_freed, _ in seen)
    assert all(freed == {"v": c == "aux", "aux": False}
               for c, _, freed in seen)
    assert st.n_padded_per_shard == 16 and not st.has_delta
    for c in data:
        dec = st.decrypt_column(sc.ks, c)
        assert np.abs(dec - np.concatenate([data[c], new[c]])).max() < \
            TCK.equality_tolerance(sc.ks.params)


# ---------------------------------------------------------------------------
# the ε-band join over sharded sides
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _right_side():
    """A float right side of 13 rows on a chained grid: each key within
    ε of its neighbour, not of its second neighbour."""
    sc = Floats()
    rk = sc.vals([0, 1, 2, 4, 8, 9, 12, 2, 30, 31, 45, 46, 59])
    return Side(sc.ref_ks, "R", {"v": rk}, 8), rk


@pytest.mark.parametrize("left_kind", ["sharded", "table"])
@pytest.mark.parametrize("strategy", ["sort_merge", "nested"])
def test_sharded_float_join_matches_reference(strategy, left_kind):
    """The ε-band join of the 22-row float table (sharded in 4, or a
    plain Table that wraps as one shard) against a sharded chained-grid
    right side (2 shards): pairs, masks and JoinStats equal the
    reference's and the plaintext's {(i, j): |l_i - r_j| <= ε}; the
    sort-merge runs come from ShardedIndexes on sharded sides and the
    verify pass keeps the band non-transitive."""
    sc, base, data = _float_side()
    right, rk = _right_side()
    ref_r, st_r = _sharded(2, right)
    if left_kind == "sharded":
        ref_l, st_l, ref_li, li = _shared(4)
    else:
        ref_l, st_l = base.ref, base.t
    # sort-merge reuses a ShardedIndex's runs; a plain side's runs are
    # built by the join (a SortedIndex has no per-shard runs)
    idx = ({"v": ref_li} if left_kind == "sharded" else {},
           {"v": RDB.ShardedIndex.build(sc.ref_ks, ref_r, "v")},
           {"v": li} if left_kind == "sharded" else {},
           {"v": TDB.ShardedIndex.build(sc.ks, st_r, "v")})
    if strategy == "nested":
        idx = ({}, {}, {}, {})
    want = RDB.execute_join(sc.ref_ks, ref_l, ref_r,
                            RP.Join(None, None, on="v", eps=EPS_BAND),
                            strategy=strategy, left_indexes=idx[0],
                            right_indexes=idx[1])
    got = TDB.execute_join(sc.ks, st_l, st_r,
                           TP.Join(None, None, on="v", eps=EPS_BAND),
                           strategy=strategy, left_indexes=idx[2],
                           right_indexes=idx[3])
    assert np.array_equal(got.pairs, want.pairs)
    assert np.array_equal(got.left_mask, want.left_mask)
    assert np.array_equal(got.right_mask, want.right_mask)
    for f in JOIN_STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert np.array_equal(got.pairs, _want_pairs(data["v"], rk, eps=EPS_BAND))
    assert got.stats.shards == ((4 if left_kind == "sharded" else 1), 2)
    if strategy == "sort_merge":
        assert got.stats.verify_compares > 0
        assert (got.stats.build_compares == 0) == (left_kind == "sharded")


# ---------------------------------------------------------------------------
# placed on a CPU shard mesh: the placed path against the unplaced one
# ---------------------------------------------------------------------------

def test_placed_float_table_matches_unplaced():
    """The 22-row float table in 4 shards placed on `[cpu] * 4` (four
    slabs, each slab's Evals through `kernels.ops.shard_eval_values`)
    against the same rows unplaced: the raw fused-scan values of an
    ε-band Eq and an ε-inclusive Range, the [4 x 3] join grid, the
    ε-band sort-merge join's verify values and pairs, and the masks,
    TopK and ShardedIndex probes, equal byte for byte; the scan equals
    the reference's too."""
    sc, _, data = _float_side()
    v = data["v"]
    ref, flat, _, flat_ix = _shared(4)
    _, placed = _sharded(4, spec=TDB.ShardSpec.create(4, devices=[CPU] * 4))
    assert placed.spec.shard_map_ok and placed.columns["v"].c0.num_slabs == 4
    plans = _float_plans(sc, v, v[0], 10 * GRID, 45 * GRID, GRID)
    atoms = [a for _, q, _ in plans
             for a in TP.compile_plan(q).scan_atoms(0)]
    ref_atoms = [a for rq, _, _ in plans
                 for a in RP.compile_plan(rq).scan_atoms(0)]
    want = TSX.sharded_fused_eval(sc.ks, flat, atoms)
    assert np.array_equal(TSX.sharded_fused_eval(sc.ks, placed, atoms), want)
    from repro.db.shard import executor as RSX
    assert np.array_equal(want, RSX.sharded_fused_eval(sc.ref_ks, ref,
                                                       ref_atoms))
    placed_ix = TDB.ShardedIndex.build(sc.ks, placed, "v")
    for _, q, truth in plans + [(None, TP.Query(
            where=plans[1][1], top_k=TP.TopK("v", 3)), plans[1][2])]:
        for ixs in ((None, None), (flat_ix, placed_ix)):
            a = TDB.execute(sc.ks, flat, q, indexes=ixs[0] and {"v": ixs[0]})
            b = TDB.execute(sc.ks, placed, q,
                            indexes=ixs[1] and {"v": ixs[1]})
            assert np.array_equal(a.mask, b.mask)
            assert np.array_equal(a.row_ids, b.row_ids)
            assert np.array_equal(a.mask, truth)
            assert b.stats.mesh_devices == 4
    right, rk = _right_side()
    _, r_flat = _sharded(2, right)
    assert np.array_equal(
        TSJ.sharded_pair_eval(sc.ks, placed, r_flat, "v", "v"),
        TSJ.sharded_pair_eval(sc.ks, flat, r_flat, "v", "v"))
    from repro_torch.db import join as TJ
    verified, inner = [], TJ._class_values

    def recording(*args):
        verified.append(inner(*args))
        return verified[-1]
    join = TP.Join(None, None, on="v", eps=EPS_BAND)
    r_ix = {"v": TDB.ShardedIndex.build(sc.ks, r_flat, "v")}
    pairs = []
    for st, ix in ((flat, flat_ix), (placed, placed_ix)):
        TJ._class_values = recording
        try:
            pairs.append(TDB.execute_join(
                sc.ks, st, r_flat, join, strategy="sort_merge",
                left_indexes={"v": ix}, right_indexes=r_ix).pairs)
        finally:
            TJ._class_values = inner
    half = len(verified) // 2
    assert half and all(np.array_equal(a, b) for a, b in
                        zip(verified[:half], verified[half:]))
    assert np.array_equal(pairs[0], pairs[1])
    assert np.array_equal(pairs[0], _want_pairs(v, rk, eps=EPS_BAND))


# ---------------------------------------------------------------------------
# on the card: the sharded float phase's kernel shapes at n = 16,384
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_sharded_float_shapes_equal_plain():
    """At paper-ckks (n = 16,384) on the card, the gadget Eval kernel at
    the sharded float phase's shapes against its plain version on the
    same residues, with its launches counted: a shard's fused-scan tile
    of an ε-band Range (two atoms on one column of (b)'s 4,096-slot
    block and a 256-slot delta block, 1,024 rows at a row offset), a
    merge stage of the sharded join (16,384 lanes, a bound a lane) and
    a verify class tile (16 left rows against 1,019 right rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core import sampling
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    cuda = torch.device("cuda", 0)
    ks = keygen(make_params("paper-ckks", mode="gadget"), 22, device=cuda)
    p = ks.params
    args = (ks.cek_rev, ks.ring.q_arr[:, 0], p.scale,
            p.profile.gadget_log_base)
    gen = sampling.make_generator(7, cuda)
    for U, W, off, rows, per_lane, sel in (
            (1, 4096 + 256, 1024, 1024, False, [0, 0]),
            (1, 16384, 0, 16384, True, [0]),
            (1, 1019, 0, 1019, False, [0] * 16)):
        u0, u1 = sampling.uniform_poly(p, gen, (2, U, W))
        b0, b1 = sampling.uniform_poly(
            p, gen, (2, len(sel), rows) if per_lane else (2, len(sel)))
        before = _build.LAUNCHES["eval_coeff0_gadget"]
        got = CK.eval_coeff0_gadget(u0, u1, off, rows, sel, b0, b1, *args,
                                    cek_bytes=ks.cek_rev_bytes)
        assert _build.LAUNCHES["eval_coeff0_gadget"] == before + 1
        want = CK.eval_coeff0_gadget_plain(u0, u1, off, rows, sel, b0, b1,
                                           *args)
        assert torch.equal(got, want), (U, W, rows, per_lane, len(sel))
