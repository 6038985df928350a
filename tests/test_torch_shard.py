"""The port's sharded engine (`repro_torch.db.shard`) against the reference.

Reference tables are encrypted by `repro.db`, re-partitioned by both
engines with `ShardedTable.from_table` (the port's pad rows are the
reference's encryptions of 0, bridged), and the same plans run through
both on the CPU at S ∈ {1, 2, 3, 4} logical shards.  Ciphertext stacks,
raw scan values, masks, row ids, `ShardedExecStats`, index positions,
server and compaction counters and join pairs must be equal.  Cases
follow `tests/test_db_shard.py`, `tests/test_db_mutations.py` (the
sharded write path) and `tests/test_db_join.py` (the [S_l, S_r] joins),
on one table of 22 rows per scheme.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro import obs as RO
from repro.core import encrypt as RE
from repro.db import plan as RP
from repro.db.shard import executor as RSX
from repro.db.shard import table as RST
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.core.encrypt import Ciphertext
from repro_torch.db import executor as TX
from repro_torch.db import plan as TP
from repro_torch.db.shard import executor as TSX
from repro_torch.db.shard.table import partition_offsets
from repro_torch.kernels import ops as TKO

from test_torch_core import ct_to_torch, n_
from test_torch_join import Scheme, Side, _same_ct, _same_join
from test_torch_write import _samples
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


SHARDS = (1, 2, 3, 4)
N_ROWS = 22
STATS = ("eval_calls", "scan_compares", "index_compares", "scan_leaves",
         "indexed_leaves", "order_compares", "delta_build_compares",
         "shards", "mesh_devices", "per_shard_scan_compares",
         "per_shard_order_compares", "merge_compares")
BATCH_STATS = ("queries", "shards", "eval_calls", "scan_compares",
               "per_shard_scan_compares", "index_compares",
               "delta_build_compares", "merge_compares")
COMPACTION = ("n_base", "n_delta", "shards", "merge_compares",
              "merge_rounds", "rebuild_compares", "indexes_merged")


def _ref_zeros(ref_ks, seed):
    """The reference's encryptions of 0 under fold_in(PRNGKey(seed),
    salt), bridged, in the port's (ks, column, count, salt) form."""
    def pads(_ks, _cname, count, salt):
        return ct_to_torch(RE.encrypt(
            ref_ks, jnp.zeros(count, jnp.int64),
            jax.random.fold_in(jax.random.PRNGKey(seed), salt)))
    return pads


@functools.lru_cache(maxsize=None)
def _fixture(profile):
    """(scheme, base table pair, data) for one profile: columns v and s."""
    sc = Scheme(profile)
    rng = np.random.default_rng(11)
    v = rng.integers(0, 40, N_ROWS)
    v[[3, 9, 17]] = v[0]                                 # duplicates
    data = {"v": sc.vals(v), "s": sc.vals(rng.integers(0, 200, N_ROWS))}
    return sc, Side(sc.ref_ks, "t", data, 2), data


def _sharded(profile, S, side=None):
    """(reference, port) ShardedTables re-partitioning the same rows
    (fresh ones: the write-path test mutates them)."""
    sc, base, _ = _fixture(profile)
    side = side or base
    ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                      spec=RDB.ShardSpec.create(S))
    st = TDB.ShardedTable.from_table(
        sc.ks, side.t, spec=TDB.ShardSpec.create(S),
        pad_rows=_ref_zeros(sc.ref_ks, 0x5AAD))
    st.fold_pad_rows = _ref_zeros(sc.ref_ks, RST._FOLD_PAD_SEED)
    return ref, st


@functools.lru_cache(maxsize=None)
def _shared(profile, S):
    """`_sharded` of the base table, shared by the read-only tests."""
    return _sharded(profile, S)


@functools.lru_cache(maxsize=None)
def _shared_index(profile, S, column="v"):
    """Both engines' ShardedIndex over `_shared`, shared the same way."""
    sc, _, _ = _fixture(profile)
    ref, st = _shared(profile, S)
    return (RDB.ShardedIndex.build(sc.ref_ks, ref, column),
            TDB.ShardedIndex.build(sc.ks, st, column))


def _same_result(got, want):
    assert np.array_equal(got.row_ids, want.row_ids)
    assert np.array_equal(got.mask, want.mask)
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert set(got.columns) == set(want.columns)
    for name, ct in got.columns.items():
        _same_ct(ct, want.columns[name])


def _same_state(st, ref):
    for f in ("n_rows", "n_total", "n_delta", "num_shards",
              "n_padded_per_shard", "delta_block", "shard_scan_width",
              "version", "ciphertext_bytes"):
        got, want = getattr(st, f), getattr(ref, f)
        if f == "ciphertext_bytes":
            got, want = got(), want()
        assert got == want, f
    assert np.array_equal(st.alive, ref.alive)
    assert np.array_equal(st.shard_rows, ref.shard_rows)
    for c in st.columns:
        _same_ct(st.columns[c], ref.columns[c])
        _same_ct(st.scan_stack(c), ref.scan_stack(c))
    for s in range(st.num_shards):
        assert np.array_equal(st.shard_slot_gids(s), ref.shard_slot_gids(s))
        assert np.array_equal(st.shard_slot_valid(s), ref.shard_slot_valid(s))
    rows = np.arange(st.n_total)[::-1]
    _same_ct(st.gather_global("v", rows), ref.gather_global("v", rows))


def _queries(sc, data):
    """(name, reference plan, port plan): the filter / order matrix."""
    v = data["v"]
    c = {k: sc.enc(x) for k, x in dict(
        eq=v[0], lo=sc.bound(sc.vals(8), -1), hi=sc.bound(sc.vals(30), +1),
        s_lo=sc.bound(sc.vals(0), -1), s_hi=sc.bound(sc.vals(110), +1),
        s_eq=data["s"][7]).items()}

    def both(build):
        return build(RP, lambda k: c[k][0]), build(TP, lambda k: c[k][1])
    specs = {
        "eq": lambda P, t: P.Eq("v", t("eq")),
        "and": lambda P, t: P.And(P.Range("v", t("lo"), t("hi")),
                                  P.Range("s", t("s_lo"), t("s_hi"))),
        "or_not": lambda P, t: P.Or(P.Eq("s", t("s_eq")),
                                    P.Not(P.Range("v", t("lo"), t("hi")))),
        "order_desc": lambda P, t: P.Query(
            where=P.And(P.Range("v", t("lo"), t("hi")),
                        P.Range("s", t("s_lo"), t("s_hi"))),
            order_by=P.OrderBy("v", descending=True), limit=P.Limit(5)),
        "topk": lambda P, t: P.Query(top_k=P.TopK("v", 6), select=("v",)),
    }
    return [(name,) + both(b) for name, b in specs.items()]


# ---------------------------------------------------------------------------
# the table: partition, round trip, re-partitioned ciphertexts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_table_matches_reference(S):
    """`from_table` moves the SAME ciphertext rows into `[S, N_sp]`
    stacks equal to the reference's, pads included; `from_arrays` with
    the port's own seeds decrypts back; id algebra agrees."""
    sc, base, data = _fixture("test-bfv")
    assert np.array_equal(partition_offsets(N_ROWS, S),
                          RST.partition_offsets(N_ROWS, S))
    ref, st = _shared("test-bfv", S)
    _same_state(st, ref)
    assert np.array_equal(st.offsets, ref.offsets)
    ids = np.arange(N_ROWS)
    for got, want in zip(st.locate(ids), ref.locate(ids)):
        assert np.array_equal(got, want)
    s, pos = st.locate([N_ROWS - 1])
    _same_ct(st.gather("v", int(s[0]), pos), ref.gather("v", int(s[0]), pos))
    assert np.array_equal(st.decrypt_column(sc.ks, "v"), data["v"])
    own = TDB.ShardedTable.from_arrays(sc.ks, "own", data, 5,
                                       spec=TDB.ShardSpec.create(S))
    assert own.n_padded_per_shard == st.n_padded_per_shard
    for c in data:
        assert np.array_equal(own.decrypt_column(sc.ks, c), data[c])
    assert repr(st) == repr(ref)
    with pytest.raises(ValueError):
        TDB.ShardSpec(num_shards=0)


# ---------------------------------------------------------------------------
# the executor: raw scan values, masks, order / top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_execute_matches_reference(S):
    """The shard-stacked scan's raw [S, A, W] values (one tile; at S = 3
    also four under a small lane budget), then And, OrderBy with
    duplicates, TopK with ties (and at S = 3 Eq and Or-Not): row ids,
    masks, projections and ShardedExecStats equal the reference's."""
    sc, _, data = _fixture("test-bfv")
    ref, st = _shared("test-bfv", S)
    queries = _queries(sc, data)
    _, rq, tq = queries[1]                           # the And: 2 columns
    ratoms = [a for i in range(2) for a in RP.compile_plan(rq).scan_atoms(i)]
    tatoms = [a for i in range(2) for a in TP.compile_plan(tq).scan_atoms(i)]
    for budget in ((None, 4 * S * len(tatoms)) if S == 3 else (None,)):
        with RO.tracing():
            want = RSX.sharded_fused_eval(sc.ref_ks, ref, ratoms,
                                          lane_budget=budget)
            ref_counts = {k: RO.REGISTRY.value(k) for k in
                          ("eval.launches", "eval.tiles", "eval.lanes",
                           "bytes.moved")}
        with TO.tracing():
            got = TSX.sharded_fused_eval(sc.ks, st, tatoms,
                                         lane_budget=budget)
            counts = {k: TO.REGISTRY.value(k) for k in ref_counts}
        assert np.array_equal(got, want)
        assert counts == ref_counts
    for name, rq, tq in queries:
        if S == 3 or name not in ("eq", "or_not"):
            _same_result(TDB.execute(sc.ks, st, tq),
                         RDB.execute(sc.ref_ks, ref, rq))
    v = data["v"]
    res = TDB.execute(sc.ks, st, queries[-1][2])
    assert v[res.row_ids].tolist() == sorted(v.tolist(), reverse=True)[:6]
    if S > 1:
        assert res.stats.merge_compares > 0


# ---------------------------------------------------------------------------
# the fan-out index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_index_matches_reference(S):
    """Per-shard sorted runs (perms and ciphertexts), build counts, the
    fan-out search's [S, B] positions and per-lane probe counts, and
    indexed execution (Eq; at S = 3 also the And and Or-Not)."""
    sc, _, data = _fixture("test-bfv")
    ref, st = _shared("test-bfv", S)
    want, got = _shared_index("test-bfv", S)
    assert got.build_compares == want.build_compares
    assert np.array_equal(got.counts, want.counts)
    for g, w in zip(got.shards, want.shards):
        assert np.array_equal(g.perm, w.perm)
        _same_ct(g.sorted_ct, w.sorted_ct)
        assert g.build_compares == w.build_compares
    from repro.db.index import _stack_cts as ref_stack
    from repro_torch.db.index import _stack_cts
    cts = [sc.enc(x) for x in (data["v"][0], 5, 25, 39)]
    strict = np.array([False, True, False, True])
    pos = got.search(sc.ks, _stack_cts([t for _, t in cts]), strict)
    assert np.array_equal(pos, want.search(
        sc.ref_ks, ref_stack([r for r, _ in cts]), strict))
    assert np.array_equal(got.last_probe_counts, want.last_probe_counts)
    for _, rq, tq in _queries(sc, data)[:3 if S == 3 else 1]:
        _same_result(TDB.execute(sc.ks, st, tq, indexes={"v": got}),
                     RDB.execute(sc.ref_ks, ref, rq, indexes={"v": want}))
    assert got.search_compares == want.search_compares
    with pytest.raises(TypeError, match="ShardedIndex"):
        TDB.execute(sc.ks, st, _queries(sc, data)[0][2],
                    indexes={"v": got.shards[0]})


# ---------------------------------------------------------------------------
# the server and the write path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_server_matches_reference(S):
    """One batch of four queries over S shards (indexed leaves in one
    fan-out search, scan atoms in one pass, a TopK through the merge
    networks; at S = 4 also the batch without indexes): results,
    ShardedBatchStats and tenant billing."""
    sc, _, data = _fixture("test-bfv")
    ref, st = _shared("test-bfv", S)
    ref_ix, ix = ({"v": x} for x in _shared_index("test-bfv", S))
    queries = [q for q in _queries(sc, data)
               if q[0] in ("eq", "and", "or_not", "topk")]
    results = []
    for rix, tix in ((({}, {}),) if S == 4 else ()) + ((ref_ix, ix),):
        ref_srv = RDB.ShardedQueryServer(sc.ref_ks, ref, indexes=rix,
                                         batch=4)
        srv = TDB.ShardedQueryServer(sc.ks, st, indexes=tix, batch=4)
        with RO.tracing():
            rids = [ref_srv.submit(q, tenant=f"t{i % 2}")
                    for i, (_, q, _) in enumerate(queries)]
            want = ref_srv.run()
            ref_bill = [RO.REGISTRY.value("server.compares", tenant=t)
                        for t in ("t0", "t1")]
        with TO.tracing():
            ids = [srv.submit(q, tenant=f"t{i % 2}")
                   for i, (_, _, q) in enumerate(queries)]
            got = srv.run()
            bill = [TO.REGISTRY.value("server.compares", tenant=t)
                    for t in ("t0", "t1")]
        assert ids == rids and bill == ref_bill
        for qid in ids:
            _same_result(got[qid], want[qid])
        assert len(srv.batch_log) == 1
        for f in BATCH_STATS:
            assert (getattr(srv.batch_log[0], f)
                    == getattr(ref_srv.batch_log[0], f)), f
        results.append(srv.batch_log[0])
    assert results[0].eval_calls == 1 and results[-1].index_compares > 0


def _insert(sc, ref, st, vals, seed):
    """The same insert into both tables, the port's rows encrypted from
    the reference's samples of each receiving shard."""
    data = {"v": sc.vals(vals), "s": sc.vals(np.arange(len(vals)))}
    key = jax.random.PRNGKey(seed)
    counts = st.route_counts(len(vals))
    offs = np.concatenate([[0], np.cumsum(counts)])
    samples = {s: _samples(sc.ref_ks, {c: x[offs[s]:offs[s + 1]]
                                       for c, x in data.items()},
                           jax.random.fold_in(key, s))
               for s in range(st.num_shards) if counts[s]}
    want = ref.insert(sc.ref_ks, data, key)
    got = st.insert(sc.ks, data, samples=samples)
    assert np.array_equal(got, want)
    return data


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_writes_and_compaction_match_reference(S):
    """Inserts routed to the least-loaded shards' delta runs (at S = 3
    one grown twice), a tombstone, reads over base ∪ delta (scan and
    fan-out index), `compact` (per-shard index merges, the fold with its
    pad rows), the reads again, (at S = 3) an insert after compaction:
    every stack, counter and answer equals the reference's; the
    decrypted view is the data's.  Off S = 3 the reads are the Eq by the
    index and the And by the scan."""
    full = S == 3
    sc, _, data = _fixture("test-bfv")
    ref, st = _sharded("test-bfv", S)
    ref_ix = {"v": RDB.ShardedIndex.build(sc.ref_ks, ref, "v")}
    ix = {"v": TDB.ShardedIndex.build(sc.ks, st, "v")}
    new = [_insert(sc, ref, st, [5, 17, 3, data["v"][0]], 40)]
    if full:
        new.append(_insert(sc, ref, st, [33, 8], 41))
    allv = np.concatenate([data["v"]] + [d["v"] for d in new])
    assert ref.delete([1, N_ROWS + 1]) == st.delete([1, N_ROWS + 1]) == 2
    _same_state(st, ref)
    assert np.array_equal(st.decrypt_column(sc.ks, "v"), allv)
    eq, both = _queries(sc, data)[:2]                # Eq, the And
    reads = ([(q, ix_pair) for ix_pair in (({}, {}), (ref_ix, ix))
              for q in (eq, both)] if full
             else [(eq, (ref_ix, ix)), (both, ({}, {}))])

    def same_reads():
        for (_, rq, tq), (rix, tix) in reads:
            _same_result(TDB.execute(sc.ks, st, tq, indexes=tix),
                         RDB.execute(sc.ref_ks, ref, rq, indexes=rix))
    same_reads()
    with RO.tracing():
        want = RDB.compact(sc.ref_ks, ref, ref_ix)
        ref_counts = {k: RO.REGISTRY.value(k) for k in
                      ("compact.runs", "compact.merge_compares",
                       "compact.indexes_merged")}
    with TO.tracing():
        got = TDB.compact(sc.ks, st, ix)
        counts = {k: TO.REGISTRY.value(k) for k in ref_counts}
    for f in COMPACTION:
        assert getattr(got, f) == getattr(want, f), f
    assert counts == ref_counts and not st.has_delta
    _same_state(st, ref)
    for g, w in zip(ix["v"].shards, ref_ix["v"].shards):
        assert np.array_equal(g.perm, w.perm)
    same_reads()
    if not full:
        return
    later = _insert(sc, ref, st, [4], 42)
    assert np.array_equal(st.decrypt_column(sc.ks, "v"),
                          np.concatenate([allv, later["v"]]))
    assert TDB.compact(sc.ks, st, ix).merge_rounds == 1


# ---------------------------------------------------------------------------
# the [S_l, S_r] join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_join_matches_reference(S):
    """S_l = S_r = S: the shard-pair grid's raw values and nested pairs,
    and (S = 3) sort-merge pairs from a ShardedIndex and one built on the
    fly, equal the reference's and the unsharded join's; a Table x
    ShardedTable join wraps the plain side as one shard."""
    sc, base, data = _fixture("test-bfv")
    rk = data["s"][:13] % 40
    right = Side(sc.ref_ks, "R", {"v": rk}, 3)
    ref_l, st_l = _shared("test-bfv", S)
    ref_r, st_r = _sharded("test-bfv", S, right)
    from repro.db.shard import join as RSJ
    from repro_torch.db.shard import join as TSJ
    assert np.array_equal(
        TSJ.sharded_pair_eval(sc.ks, st_l, st_r, "v", "v"),
        RSJ.sharded_pair_eval(sc.ref_ks, ref_l, ref_r, "v", "v"))
    rj, tj = RP.Join(None, None, on="v"), TP.Join(None, None, on="v")
    flat = TDB.execute_join(sc.ks, base.t, right.t, tj, strategy="nested")
    want_pairs = np.argwhere(data["v"][:, None] == rk[None, :])
    assert np.array_equal(flat.pairs, want_pairs)
    runs = [("nested", ({}, {}), ({}, {}))]
    if S == 3:
        # the left index is shared, the right one built by the join
        lidx = _shared_index("test-bfv", S)
        runs.append(("sort_merge", ({"v": lidx[0]}, {}),
                     ({"v": lidx[1]}, {})))
    for strategy, (rli, rri), (tli, tri) in runs:
        g = TDB.execute_join(sc.ks, st_l, st_r, tj, strategy=strategy,
                             left_indexes=tli, right_indexes=tri)
        _same_join(g, RDB.execute_join(sc.ref_ks, ref_l, ref_r, rj,
                                       strategy=strategy, left_indexes=rli,
                                       right_indexes=rri))
        assert np.array_equal(g.pairs, want_pairs), strategy
        assert g.stats.shards == (S, S)
    if S == 2:
        mixed = TDB.execute_join(sc.ks, base.t, st_r, tj, strategy="nested")
        assert np.array_equal(mixed.pairs, want_pairs)
        assert mixed.stats.shards == (1, S)


# ---------------------------------------------------------------------------
# on the card: one shard-stacked scan tile against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_cuda_sharded_scan_tile_equals_plain(mode):
    """A tile of the `[S, U, W]` scan through the kernels
    (`kernels.ops.slab_scan_values` over the one slab: per shard, per
    unique column, addressed by offset; paper mode also once on the
    bounds per shard) equals the CPU's plain tile."""
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cuda = torch.device("cuda", 0)
    sc = Scheme("test-bfv", mode)
    rng = np.random.default_rng(5)
    data = {"v": rng.integers(0, 40, N_ROWS), "s": rng.integers(0, 40, N_ROWS)}
    side = Side(sc.ref_ks, "t", data, 4)
    st = TDB.ShardedTable.from_table(sc.ks, side.t,
                                     spec=TDB.ShardSpec.create(3))
    uniq, sel = TX.dedup_atom_columns(st, [
        TP.Atom("v", ">=", None), TP.Atom("s", "<=", None),
        TP.Atom("v", "<=", None)], st.scan_stack)
    uniq = Ciphertext(uniq.c0.full(), uniq.c1.full())
    b = sc.enc(7)[1]
    bounds = Ciphertext(torch.stack([b.c0] * 3)[:, None],
                        torch.stack([b.c1] * 3)[:, None])
    ks_gpu = type(sc.ks).from_numpy(
        sc.ks.params, sk=n_(sc.ks.sk), pk0=n_(sc.ks.pk0), pk1=n_(sc.ks.pk1),
        cek=None if sc.ks.cek is None else n_(sc.ks.cek),
        cek_gadget=(None if sc.ks.cek_gadget is None
                    else n_(sc.ks.cek_gadget)), device=cuda)

    def on(ct):
        return Ciphertext(ct.c0.to(cuda), ct.c1.to(cuda))
    want = TKO.slab_scan_values(sc.ks, uniq, sel, bounds, 2, 5)
    kernel = f"eval_coeff0_{mode}"
    before = _build.LAUNCHES[kernel]
    got = TKO.slab_scan_values(ks_gpu, on(uniq), sel, on(bounds), 2, 5)
    per_shard = 2 if mode == "gadget" else 3        # U = 2 columns (+ bounds)
    assert _build.LAUNCHES[kernel] == before + 3 * per_shard
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_cuda_placed_scan_tile_equals_plain(mode):
    """A table placed on four mesh positions over the cards (a card may
    fill several): every fused-scan tile runs per slab on its card
    (`kernels.ops.shard_eval_values`: one launch per shard per unique
    column, paper mode one more on the bounds), and the raw values equal
    the CPU's unplaced plain scan of the same rows and pads."""
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cards = torch.cuda.device_count()
    positions = [torch.device("cuda", j % cards) for j in range(4)]
    home = positions[0]
    sc = Scheme("test-bfv", mode)
    rng = np.random.default_rng(6)
    data = {"v": rng.integers(0, 40, N_ROWS), "s": rng.integers(0, 40, N_ROWS)}
    side = Side(sc.ref_ks, "t", data, 4)
    pads = _ref_zeros(sc.ref_ks, 0x5AAD)

    def on(ct):
        return Ciphertext(ct.c0.to(home), ct.c1.to(home))
    ks_gpu = type(sc.ks).from_numpy(
        sc.ks.params, sk=n_(sc.ks.sk), pk0=n_(sc.ks.pk0), pk1=n_(sc.ks.pk1),
        cek=None if sc.ks.cek is None else n_(sc.ks.cek),
        cek_gadget=(None if sc.ks.cek_gadget is None
                    else n_(sc.ks.cek_gadget)), device=home)
    flat = TDB.ShardedTable.from_table(
        sc.ks, side.t, spec=TDB.ShardSpec.create(4, use_mesh=False),
        pad_rows=pads)
    card = TDB.Table.from_ciphertexts(
        "t", {c: on(ct) for c, ct in side.t.columns.items()}, side.t.n_rows)
    st = TDB.ShardedTable.from_table(
        ks_gpu, card, spec=TDB.ShardSpec.create(4, devices=positions),
        pad_rows=lambda _ks, c, count, salt: on(pads(_ks, c, count, salt)))
    assert st.spec.shard_map_ok and st.columns["v"].c0.num_slabs == 4
    b = sc.enc(7)[1]
    atoms = [TP.Atom("v", ">=", b), TP.Atom("s", "<=", b)]
    want = TSX.sharded_fused_eval(sc.ks, flat, atoms, lane_budget=32)
    kernel = f"eval_coeff0_{mode}"
    before = _build.LAUNCHES[kernel]
    got = TSX.sharded_fused_eval(
        ks_gpu, st, [TP.Atom(a.column, a.op, on(a.value)) for a in atoms],
        lane_budget=32)
    tiles = -(-st.shard_scan_width // (32 // (4 * len(atoms))))
    per_tile = 4 * (2 if mode == "gadget" else 3)     # 2 columns (+ bounds)
    assert _build.LAUNCHES[kernel] == before + tiles * per_tile
    assert np.array_equal(got, want)
