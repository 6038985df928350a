"""The port's serving loop in front of sharded tables against the
reference's (`tests/test_serve_loop.py`'s sharded cases, and the loop's
writes and float lanes on a `ShardedQueryServer`).

Reference tables are encrypted by `repro.db` and bridged into the port
(`test_torch_join.Side`), trapdoors too; both packages re-partition the
same rows into S shards (`ShardedTable.from_table`), build a
`ShardedIndex` and serve the same plans through their own `ServeLoop`.
Ticket statuses, classes, batch shapes, `LoopStats`, per-tenant
counters, row ids and masks must be equal, and equal to the plaintext.
The port's tables run meshless and placed on `[cpu] * S` mesh
positions (S slabs); the reference in-process is meshless.  Writes
through the loop encrypt under each package's own sampler, so they are
held by their answers and the decrypted column, not by ciphertexts.
Keys come from the port's keygen, handed to a reference `KeySet`
(`test_torch_join.gadget_keys`, `test_torch_write._keys`): test-bfv in
gadget and paper mode, test-ckks in gadget mode.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro import obs as RO
from repro.db import plan as RP
from repro.db import serve_loop as RSL
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.db import plan as TP
from repro_torch.db import serve_loop as TSL

from test_torch_join import EPS_BAND, GRID, Scheme, Side
from test_torch_write import _keys
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")

CPU = torch.device("cpu")
N_ROWS = 20                  # 2 shards of 16 slots, 4 of 8: pads in each
WIDE = 2.2 * GRID            # a second ε-band: two lattice steps, not three


def _spec(S, placed):
    """Meshless, or one mesh position a shard on the CPU (S slabs)."""
    if placed:
        return TDB.ShardSpec.create(S, devices=[CPU] * S)
    return TDB.ShardSpec.create(S, use_mesh=False)


class World:
    """One sharded table in both packages: the reference's
    `ShardedTable` + `ShardedIndex` and the port's over the same bridged
    rows, and their servers behind each package's `ServeLoop`."""

    def __init__(self, sc, side, S, *, placed=False, column="v", batch=4,
                 compact_threshold=None, clock=None):
        self.sc = sc
        kw = {} if clock is None else {"clock": clock}
        self.ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                               spec=RDB.ShardSpec.create(S))
        self.st = TDB.ShardedTable.from_table(sc.ks, side.t,
                                              spec=_spec(S, placed))
        self.ref_srv = RDB.ShardedQueryServer(
            sc.ref_ks, self.ref, batch=batch,
            indexes={column: RDB.ShardedIndex.build(sc.ref_ks, self.ref,
                                                    column)},
            compact_threshold=compact_threshold)
        self.srv = TDB.ShardedQueryServer(
            sc.ks, self.st, batch=batch,
            indexes={column: TDB.ShardedIndex.build(sc.ks, self.st, column)},
            compact_threshold=compact_threshold)
        self.ref_loop = RSL.ServeLoop(batch=batch, **kw)
        self.loop = TSL.ServeLoop(batch=batch, **kw)
        self.ref_loop.register("sh", self.ref_srv)
        self.loop.register("sh", self.srv)

    def submit(self, tenant, plans, **kw):
        """Each (reference plan, port plan) into its loop; the ticket
        pairs."""
        return [(self.ref_loop.submit(tenant, "sh", rq, **kw),
                 self.loop.submit(tenant, "sh", q, **kw))
                for rq, q in plans]

    def run(self):
        return self.ref_loop.run_until_idle(), self.loop.run_until_idle()


def _same_loops(w, want, got, pairs):
    """Every ticket's status, class and error, and each OK answer's rows
    and mask, equal the reference loop's; so do the batch shapes and
    the loop's totals."""
    assert w.loop.batch_shapes == w.ref_loop.batch_shapes
    assert vars(w.loop.stats) == vars(w.ref_loop.stats)
    for rt, t in pairs:
        r, g = want[rt], got[t]
        assert (g.status, g.klass, g.tenant) == (r.status, r.klass, r.tenant)
        assert g.error.split(":")[0] == r.error.split(":")[0]
        if g.status != TSL.OK:
            continue
        assert np.array_equal(g.result.row_ids, r.result.row_ids)
        if hasattr(r.result, "mask"):
            assert np.array_equal(g.result.mask, r.result.mask)
        if hasattr(r.result, "deleted"):
            assert g.result.kind == r.result.kind
            assert g.result.deleted == r.result.deleted


# ---------------------------------------------------------------------------
# reads: points, Ranges and a TopK at S = 2 and 4, meshless and placed
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gadget():
    """(scheme, side, data, plans): a 20-row gadget test-bfv table with
    an indexed `v` (duplicates) and an unindexed `w`, and the plan matrix
    as (name, reference plan, port plan, truth rows or None)."""
    sc = Scheme("test-bfv")
    rng = np.random.default_rng(23)
    v = rng.integers(0, 40, N_ROWS)
    v[[4, 11, 17]] = v[2]
    data = {"v": sc.vals(v), "w": sc.vals(rng.integers(0, 9, N_ROWS))}
    side = Side(sc.ref_ks, "t", data, 5)
    c = {k: sc.enc(x) for k, x in dict(
        p2=v[2], p0=v[0], lo=8, hi=30, lo2=0, hi2=12, wlo=2,
        whi=6).items()}

    def both(build):
        def make(P, side):
            q = build(P, lambda k: c[k][side])
            return q if isinstance(q, P.Query) else P.Query(where=q)
        return make(RP, 0), make(TP, 1)

    def truth(mask):
        return np.nonzero(mask)[0]
    w = data["w"]
    specs = [
        ("point", lambda P, t: P.Eq("v", t("p2")), truth(v == v[2])),
        ("point0", lambda P, t: P.Eq("v", t("p0")), truth(v == v[0])),
        ("range", lambda P, t: P.Range("v", t("lo"), t("hi")),
         truth((v >= 8) & (v <= 30))),
        ("range2", lambda P, t: P.Range("v", t("lo2"), t("hi2")),
         truth(v <= 12)),
        ("scan", lambda P, t: P.Range("w", t("wlo"), t("whi")),
         truth((w >= 2) & (w <= 6))),
        ("and", lambda P, t: P.And(P.Range("v", t("lo"), t("hi")),
                                   P.Range("w", t("wlo"), t("whi"))),
         truth((v >= 8) & (v <= 30) & (w >= 2) & (w <= 6))),
        ("topk", lambda P, t: P.Query(where=P.Range("v", t("lo"), t("hi")),
                                      top_k=P.TopK("v", 3)), None),
    ]
    plans = {name: (*both(b), want) for name, b, want in specs}
    return sc, side, data, plans


POINTS = ("point", "point0", "range", "range2")


@pytest.mark.parametrize("placed", [False, True], ids=["meshless", "placed"])
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_loop_reads_match_reference(S, placed):
    """Alice's points on the fan-out index (Eqs and Ranges, classified
    `point`: every leaf has a `ShardedIndex`) and bob's bulk requests (a
    scan, an And, a Range sent as bulk, and a TopK 3 at S = 4, an Eq
    sent as bulk at S = 2: the reference's TopK merge costs seconds of
    compiles at each S) through both loops: the same classes, batch
    shapes and answers as the reference loop, and the plaintext's;
    placed on `[cpu] * S`, S slabs and the stats' `mesh_devices` S."""
    sc, side, data, plans = _gadget()
    w = World(sc, side, S, placed=placed)
    bulk = ("scan", "and", "topk" if S == 4 else "point", "range")
    pairs = (w.submit("alice", [plans[k][:2] for k in POINTS])
             + w.submit("bob", [plans[k][:2] for k in bulk], klass=TSL.BULK))
    want, got = w.run()
    _same_loops(w, want, got, pairs)
    assert [(k, n) for _, k, n in w.loop.batch_shapes] == [
        (TSL.POINT, 4), (TSL.BULK, 4)]
    for (_, t), name in zip(pairs, POINTS + bulk):
        r = got[t]
        assert r.status == TSL.OK
        assert isinstance(r.result.row_ids, np.ndarray)
        if plans[name][2] is not None:
            assert np.array_equal(np.sort(r.result.row_ids), plans[name][2])
        assert r.result.stats.mesh_devices == (S if placed else 1)
    assert [w.loop.response(t).klass for _, t in pairs[:4]] == [
        TSL.POINT] * 4
    v = data["v"]
    top = got[pairs[6][1]].result.row_ids
    if S == 4:
        assert v[top].tolist() == sorted(v[(v >= 8) & (v <= 30)].tolist(),
                                         reverse=True)[:3]
    assert w.st.columns["v"].c0.num_slabs == (S if placed else 1)


# ---------------------------------------------------------------------------
# admission, reconciliation and the recovery API on a sharded server
# ---------------------------------------------------------------------------

def test_join_on_sharded_server_rejected_at_admission():
    """A join against a sharded table is REJECTED at admission, as in
    the reference: never enqueued, never drafted, the loop's counters
    and the queue unchanged but for one submitted and one rejected."""
    sc, side, _, plans = _gadget()
    w = World(sc, side, 2)
    pairs = w.submit("alice", [plans["point"][:2]])
    before = vars(w.loop.stats).copy()
    rt = w.ref_loop.submit_join("alice", "sh", RP.Join(None, None, on="v"),
                                side.ref)
    t = w.loop.submit_join("alice", "sh", TP.Join(None, None, on="v"),
                           side.t)
    r, g = w.ref_loop.response(rt), w.loop.response(t)
    assert g.status == r.status == TSL.REJECTED
    assert g.error == r.error and "does not support joins" in g.error
    assert vars(w.loop.stats) == dict(before, submitted=2, rejected=1)
    assert w.loop.queue_depth() == 1 and w.loop.batch_shapes == []
    want, got = w.run()
    _same_loops(w, want, got, pairs + [(rt, t)])
    assert w.loop.stats.failed == 0 and w.loop.stats.served == 1


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_per_tenant_reconciliation_sharded_server():
    """Two tenants' points, a bulk scan, a poisoned plan in a shared
    drain and a shed request on a sharded server: the per-tenant
    `server.queries`, `server.compares` and `serve.*` counters equal the
    reference loop's and sum to the loop's totals; per tenant,
    submitted = ok + rejected + shed + failed."""
    sc, side, _, plans = _gadget()
    clock = FakeClock()
    w = World(sc, side, 2, clock=clock)
    byname = {k: p[:2] for k, p in plans.items()}
    bad = (RP.Query(where=RP.Eq("nope", byname["point"][0].where.value)),
           TP.Query(where=TP.Eq("nope", byname["point"][1].where.value)))
    tenants = ("alice", "bob")
    with RO.tracing(), TO.tracing():
        pairs = (w.submit("alice", [byname["point"]])
                 + w.submit("bob", [byname["scan"], bad, byname["and"]],
                            klass=TSL.BULK)
                 + w.submit("alice", [byname["point0"]], deadline=1.0))
        clock.t = 2.0
        pairs += w.submit("alice", [byname["range"]])
        want, got = w.run()
        _same_loops(w, want, got, pairs)
        keys = [(name, t) for name in ("server.queries", "server.compares",
                                       "serve.shed", "serve.failed",
                                       "serve.rejected",
                                       "serve.deadline_miss")
                for t in tenants]
        counts = {k: TO.REGISTRY.value(k[0], tenant=k[1]) for k in keys}
        assert counts == {k: RO.REGISTRY.value(k[0], tenant=k[1])
                          for k in keys}
    stats = w.loop.stats
    assert (stats.served, stats.failed, stats.shed) == (4, 1, 1)
    assert sum(counts[("server.queries", t)] for t in tenants) == 4
    for name, total in (("serve.shed", stats.shed),
                        ("serve.failed", stats.failed)):
        assert sum(counts[(name, t)] for t in tenants) == total
    for t in tenants:
        mine = [r for r in got.values() if r.tenant == t]
        ok = [r for r in mine if r.status == TSL.OK]
        assert counts[("server.compares", t)] == sum(
            r.result.stats.filter_compares for r in ok)
        assert len(mine) == len(ok) + sum(
            counts[(k, t)] for k in ("serve.shed", "serve.failed",
                                     "serve.rejected"))
    assert got[pairs[2][1]].status == TSL.FAILED
    assert "nope" in got[pairs[2][1]].error


def test_clear_queue_and_batch_size_on_sharded_server():
    """The loop's fault recovery rides the sharded server's public API
    (`tests/test_serve_loop.py::test_clear_queue_and_batch_size_public_
    api`): `clear_queue` drops queued requests, `batch_size` restores the
    configured size, also when the drain raises."""
    sc, side, _, plans = _gadget()
    st = TDB.ShardedTable.from_table(sc.ks, side.t, spec=_spec(2, False))
    srv = TDB.ShardedQueryServer(sc.ks, st, batch=3)
    srv.submit(plans["point"][1])
    srv.submit(plans["point0"][1])
    assert srv.clear_queue() == 2 and srv.run() == {}
    with srv.batch_size(4):
        assert srv.batch == 4
    assert srv.batch == 3
    with pytest.raises(RuntimeError, match="boom"):
        with srv.batch_size(5):
            raise RuntimeError("boom")
    assert srv.batch == 3
    qid = srv.submit(plans["point"][1])
    assert np.array_equal(np.sort(srv.run()[qid].row_ids),
                          plans["point"][2])


# ---------------------------------------------------------------------------
# writes through the loop: barriers, compaction at the threshold
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _paper():
    """Paper-mode test-bfv keys (port keygen, the reference KeySet on the
    same material) with a trapdoor encryptor, and a 10-row table: 2
    shards of 5 rows in 8 slots, so compaction keeps the block."""
    ref_ks, ks, _ = _keys("test-bfv")
    sc = Scheme.__new__(Scheme)
    sc.ref_ks, sc.ks, sc.ckks, sc._seed = ref_ks, ks, False, 900
    base = np.array([3, 14, 15, 9, 26, 5, 35, 8, 30, 41], np.int64)
    return sc, Side(ref_ks, "t", {"v": base}, 3), base


@pytest.mark.parametrize("placed", [False, True], ids=["meshless", "placed"])
def test_sharded_loop_writes_and_compaction_match_reference(placed):
    """Queries, inserts (the second crossing `compact_threshold`, so the
    per-shard compaction runs between the write and the queries queued
    behind it), a delete and an update through both loops over a
    paper-mode 2-shard table: every answer after each barrier equals the
    reference loop's and the running plaintext's, the insert ids and
    compaction stats agree, and the port's decrypted column is the
    data."""
    sc, side, base = _paper()
    w = World(sc, side, 2, placed=placed, compact_threshold=4)
    vals, alive = list(base), [True] * len(base)

    def query(lo, hi):
        (r_lo, t_lo), (r_hi, t_hi) = sc.enc(lo), sc.enc(hi)
        v, a = np.asarray(vals), np.asarray(alive)
        want = np.nonzero((v >= lo) & (v <= hi) & a)[0]
        if lo == hi:
            plans = [(RP.Eq("v", r_lo), TP.Eq("v", t_lo))]
        else:
            plans = [(RP.Range("v", r_lo, r_hi), TP.Range("v", t_lo, t_hi))]
        return w.submit("alice", plans), want

    def insert(new, seed):
        data = {"v": np.asarray(new, np.int64)}
        vals.extend(new)
        alive.extend([True] * len(new))
        return (w.ref_loop.submit_insert("bob", "sh", data,
                                         jax.random.PRNGKey(seed)),
                w.loop.submit_insert("bob", "sh", data, seed))
    reads, writes = [query(41, 41)], []
    writes.append(insert([41, 7, 19], 60))
    reads += [query(41, 41), query(0, 20)]
    writes.append(insert([41, 2], 61))                 # 5 >= 4: compact
    reads += [query(41, 41), query(0, 20)]
    writes.append((w.ref_loop.submit_delete("bob", "sh", [1, 11]),
                   w.loop.submit_delete("bob", "sh", [1, 11])))
    alive[1] = alive[11] = False
    data = {"v": np.array([50], np.int64)}
    writes.append((w.ref_loop.submit_update("bob", "sh", [2], data,
                                            jax.random.PRNGKey(62)),
                   w.loop.submit_update("bob", "sh", [2], data, 62)))
    alive[2] = False
    vals.append(50)
    alive.append(True)
    reads += [query(50, 50), query(0, 60)]
    want, got = w.run()
    _same_loops(w, want, got, [p for ps, _ in reads for p in ps] + writes)
    for ps, truth in reads:
        (_, t), = ps
        assert np.array_equal(np.sort(got[t].result.row_ids), truth)
    assert [got[t].result.row_ids.tolist() for _, t in writes] == [
        [10, 11, 12], [13, 14], [], [15]]
    assert [got[t].result.deleted for _, t in writes] == [0, 0, 2, 1]
    assert [s for _, s, _ in w.loop.batch_shapes].count(TSL.WRITE) == 4
    (cg,), (cw,) = w.srv.compaction_log, w.ref_srv.compaction_log
    for f in ("n_base", "n_delta", "shards", "merge_compares",
              "merge_rounds", "rebuild_compares", "indexes_merged"):
        assert getattr(cg, f) == getattr(cw, f), f
    assert w.st.n_delta == w.ref.n_delta == 1
    assert w.st.n_padded_per_shard == 8
    assert np.array_equal(w.st.decrypt_column(sc.ks, "v"), vals)
    assert np.array_equal(w.st.alive, alive)
    assert w.st.columns["v"].c0.num_slabs == (2 if placed else 1)


# ---------------------------------------------------------------------------
# a float tenant: ε-band points, Ranges and a TopK at test-ckks
# ---------------------------------------------------------------------------

def test_float_tenant_eps_band_matches_reference():
    """A test-ckks float table of 22 rows (duplicates and lattice
    neighbours) in 2 shards behind both loops: ε-band point Eqs (each
    its own ε, so its own τ a lane) classify `point` and answer the
    band, and so do a Range and an ε-widened Range by the index (one
    point batch of four lanes' τs); an ε-band Eq by the scan and an And
    of an ε-widened Range and an ε-band Eq run as bulk; every answer the
    reference loop's and the plaintext's."""
    sc = Scheme("test-ckks")
    rng = np.random.default_rng(31)
    ints = rng.integers(0, 60, 22)
    ints[[3, 9]] = ints[0]
    ints[17] = ints[0] + 1
    v, aux = sc.vals(ints), sc.vals(rng.integers(0, 8, 22))
    side = Side(sc.ref_ks, "f", {"v": v, "aux": aux}, 9)
    w = World(sc, side, 2)
    (r_x, t_x), (r_y, t_y), (r_lo, t_lo), (r_hi, t_hi), (r_a, t_a) = (
        sc.enc(x) for x in (v[0], v[5], 10 * GRID - GRID / 2,
                            40 * GRID + GRID / 2, aux[2]))
    lo, hi = 10 * GRID - GRID / 2, 40 * GRID + GRID / 2
    rng_q = lambda P, lo_, hi_: P.Range("v", lo_, hi_, eps=GRID)  # noqa: E731
    plans = [
        (RP.Eq("v", r_x, eps=EPS_BAND), TP.Eq("v", t_x, eps=EPS_BAND),
         np.abs(v - v[0]) <= EPS_BAND, TSL.POINT),
        (RP.Eq("v", r_y, eps=WIDE), TP.Eq("v", t_y, eps=WIDE),
         np.abs(v - v[5]) <= WIDE, TSL.POINT),
        (rng_q(RP, r_lo, r_hi), rng_q(TP, t_lo, t_hi),
         (v > lo - GRID) & (v < hi + GRID), TSL.POINT),
        (RP.Range("v", r_lo, r_hi), TP.Range("v", t_lo, t_hi),
         (v > lo) & (v < hi), TSL.POINT),
        (RP.Eq("aux", r_a, eps=EPS_BAND), TP.Eq("aux", t_a, eps=EPS_BAND),
         np.abs(aux - aux[2]) <= EPS_BAND, TSL.BULK),
        (RP.And(rng_q(RP, r_lo, r_hi), RP.Eq("aux", r_a, eps=EPS_BAND)),
         TP.And(rng_q(TP, t_lo, t_hi), TP.Eq("aux", t_a, eps=EPS_BAND)),
         (v > lo - GRID) & (v < hi + GRID)
         & (np.abs(aux - aux[2]) <= EPS_BAND), TSL.BULK),
    ]
    pairs = w.submit("alice", [(rq, q) for rq, q, _, _ in plans])
    want, got = w.run()
    _same_loops(w, want, got, pairs)
    for (_, t), (_, _, truth, klass) in zip(pairs, plans):
        r = got[t]
        assert r.status == TSL.OK and r.klass == klass
        assert np.array_equal(r.result.mask, truth)
    assert [(k, n) for _, k, n in w.loop.batch_shapes] == [
        (TSL.POINT, 4), (TSL.BULK, 2)]
