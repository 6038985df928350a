"""The port's always-on serving loop (`repro_torch.db.serve_loop`) against
the reference's (`repro.db.serve_loop`).

  * A differential scheduling test: each scenario of the reference's
    `tests/test_serve_loop.py` (admission caps, ACLs, classification,
    point-before-bulk, no starvation, pow2 buckets, fair share, shed and
    miss, write barriers, FIFO, faults, retention and `forget`) drives the
    reference loop and the port's with the same scripted stream, on a
    fake clock, each against a stub server built from its own package's
    plan module — no crypto.  Ticket statuses, error strings, timestamps,
    what each drain received, `batch_shapes`, `LoopStats` and every
    `serve.*` counter and histogram must be identical.
  * Real-server cases at test-bfv (n = 256) on bridged tables: answers
    equal the port's `QueryServer`, a sharded server and a join through
    the loop, a query sees exactly the writes admitted before it (the
    reference's encryption samples injected, so the written ciphertexts
    and the answers equal the reference loop's), per-tenant counters
    reconcile, and the daemon thread serves and stops.
"""
import contextlib
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro import obs as RO
from repro.db import plan as RP
from repro.db import serve_loop as RSL
from repro.launch import elastic as REL
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.db import plan as TP
from repro_torch.db import serve_loop as TSL
from repro_torch.launch import elastic as TEL

from test_torch_db import _fixture
from test_torch_write import Pair, _samples
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


REF = {"SL": RSL, "P": RP, "EL": REL, "obs": RO}
PORT = {"SL": TSL, "P": TP, "EL": TEL, "obs": TO}


# ---------------------------------------------------------------------------
# the differential scheduling test
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Ct:
    """A stand-in trapdoor: a plaintext value with ciphertext identity
    (the plan IR dedups leaves by `id(c0)`)."""

    def __init__(self, v):
        self.v, self.c0, self.c1 = v, object(), object()


class Stub:
    """A server with the loop-facing API of `QueryServer`: `indexes`,
    `submit*`, `run`, `clear_queue`, `batch_size`.  Plans compile with
    its package's plan module; `run` resolves each request to a tuple of
    what it saw, raises KeyError for an unknown column (a poisoned plan)
    and, `transient` times, RuntimeError for a drain of several
    requests (a device error the per-request retry survives)."""

    def __init__(self, P, clock, *, columns=("v", "w"), indexes=("v",),
                 joins=True, slow=0.0, transient=0):
        self.P, self.clock = P, clock
        self.columns, self.indexes = set(columns), dict.fromkeys(indexes)
        self.slow, self.transient = slow, transient
        self.batch = 8
        self.drains = 0
        self._queue, self._next = [], 0
        if joins:
            self.submit_join = self._submit_join

    def _enq(self, item):
        qid = self._next
        self._next += 1
        self._queue.append((qid, item))
        return qid

    def submit(self, query, *, tenant=None):
        return self._enq(("query", query, tenant))

    def _submit_join(self, join, right, *, right_indexes=None,
                     strategy="auto", tenant=None):
        self.P.compile_join(join)
        return self._enq(("join", (join.on, right, strategy), tenant))

    def submit_insert(self, data, seed_or_key, *, samples=None, tenant=None):
        return self._enq(("insert", (sorted(data), seed_or_key), tenant))

    def submit_delete(self, rows, *, tenant=None):
        return self._enq(("delete", tuple(np.asarray(rows).tolist()),
                          tenant))

    def submit_update(self, rows, data, seed_or_key, *, samples=None,
                      tenant=None):
        return self._enq(("update", (tuple(np.asarray(rows).tolist()),
                                     sorted(data), seed_or_key), tenant))

    def clear_queue(self):
        n, self._queue = len(self._queue), []
        return n

    @contextlib.contextmanager
    def batch_size(self, n):
        old, self.batch = self.batch, max(1, int(n))
        try:
            yield self
        finally:
            self.batch = old

    def run(self):
        self.drains += 1
        if self.slow:
            self.clock.advance(self.slow)
        chunk = list(self._queue)
        if self.transient and len(chunk) > 1:
            self.transient -= 1
            raise RuntimeError("device lost (injected)")
        out = {}
        for qid, (kind, item, tenant) in chunk:
            if kind == "query":
                plan = self.P.compile_plan(item)
                cols = tuple(leaf.column for leaf in plan.leaves)
                bad = [c for c in cols if c not in self.columns]
                if bad:
                    raise KeyError(bad[0])
                vals = tuple((leaf.value if hasattr(leaf, "value")
                              else leaf.lo).v for leaf in plan.leaves)
                item = (cols, vals)
            elif kind in ("insert", "update"):
                bad = [c for c in item[-2] if c not in self.columns]
                if bad:
                    raise ValueError(f"insert columns {bad}")
            out[qid] = (kind, item, tenant, self.drains, len(chunk),
                        self.batch)
        self._queue = []
        return out


class World:
    """One package's loop, fake clock and stub servers, driven by a
    scenario; every call's outcome (ticket or exception) is recorded."""

    def __init__(self, pkg, **loop_kw):
        self.pkg, self.P, self.SL = pkg, pkg["P"], pkg["SL"]
        self.clock = FakeClock()
        policy = loop_kw.pop("policy", None)
        if policy is not None:
            loop_kw["policy"] = self.SL.AdmissionPolicy(**policy)
        monitor = loop_kw.pop("monitor", None)
        if monitor:
            EL = pkg["EL"]
            self.monitor = EL.FleetMonitor(
                EL.ElasticConfig(beat_interval_s=1.0, dead_after=3),
                [0, 1], now=0.0)
            loop_kw.update(monitor=self.monitor, monitor_host=0)
        self.loop = self.SL.ServeLoop(clock=self.clock, **loop_kw)
        self.servers = {}
        self.log = []

    def serve(self, name, tenants=None, **kw):
        self.servers[name] = Stub(self.P, self.clock, **kw)
        self.loop.register(name, self.servers[name], tenants=tenants)
        return self.servers[name]

    def call(self, fn, *args, **kw):
        try:
            out = fn(*args, **kw)
            self.log.append(("ok", out))
            return out
        except Exception as e:          # noqa: BLE001 — recorded, compared
            self.log.append(("raise", type(e).__name__, str(e)))
            return None

    def eq(self, col, v, **kw):
        return self.P.Query(where=self.P.Eq(col, Ct(v)), **kw)

    def rng(self, col, lo, hi, **kw):
        return self.P.Query(where=self.P.Range(col, Ct(lo), Ct(hi)), **kw)

    def submit(self, tenant, table, query, **kw):
        return self.call(self.loop.submit, tenant, table, query, **kw)

    def insert(self, tenant, table, data, **kw):
        # the reference's key and the port's seed are one positional slot
        return self.call(self.loop.submit_insert, tenant, table, data, 9,
                         **kw)

    def pump(self):
        return self.call(self.loop.pump)

    def idle(self):
        return self.call(lambda: sorted(self.loop.run_until_idle()))

    def record(self):
        """Everything the loop decided, in comparable form."""
        obs = self.pkg["obs"]
        resp = {}
        for t, r in sorted(self.loop.responses().items()):
            resp[t] = (r.tenant, r.table, r.klass, r.status, r.error,
                       r.deadline, r.deadline_missed, r.submit_t,
                       r.start_t, r.done_t, r.result)
        serve = {k: v for k, v in obs.REGISTRY.snapshot().items()
                 if k.startswith("serve.")}
        out = {"log": self.log, "responses": resp,
               "shapes": list(self.loop.batch_shapes),
               "stats": dataclasses.asdict(self.loop.stats),
               "serve_metrics": serve,
               "depth": self.loop.queue_depth(),
               "tables": self.loop.tables(),
               "drains": {n: s.drains for n, s in self.servers.items()}}
        if hasattr(self, "monitor"):
            out["beats"] = len(self.monitor.hosts[0].step_times)
            out["dead"] = self.monitor.dead_hosts(
                now=self.monitor.hosts[0].last_beat + 1.0)
        return out


# each scenario: (loop kwargs, script(world)); the script is identical
# for both packages and builds its plans with the world's plan module

def _tenant_cap(w):
    w.serve("t")
    for v in (15, 26, 35):
        w.submit("alice", "t", w.eq("v", v))
    w.call(w.loop.queue_depth, "alice")
    w.idle()


def _total_cap(w):
    w.serve("t")
    for tenant, v in (("alice", 15), ("bob", 26), ("carol", 35)):
        w.submit(tenant, "t", w.eq("v", v))
    w.idle()


def _acl(w):
    w.serve("alice_t", tenants=("alice",))
    w.serve("open")
    w.submit("alice", "alice_t", w.eq("v", 15))
    w.submit("bob", "alice_t", w.eq("v", 15))
    w.submit("bob", "open", w.eq("v", 15))
    w.idle()


def _unknown_table(w):
    w.serve("t")
    w.submit("alice", "nope", w.eq("v", 1))
    w.insert("alice", "nope", {"v": np.array([1])})
    w.call(w.loop.response, 99)
    w.idle()


def _join_unsupported(w):
    w.serve("sh", joins=False)
    w.serve("t")
    j = w.P.Join(None, None, on="v")
    w.call(w.loop.submit_join, "alice", "sh", j, "right")
    w.call(w.loop.submit_join, "alice", "t", j, "right", strategy="nested")
    w.idle()


def _unknown_klass(w):
    w.serve("t")
    w.submit("a", "t", w.eq("v", 15), klass="interactive")
    w.submit("a", "t", w.eq("v", 15), klass="bulk")
    w.idle()


def _classification(w):
    w.serve("t")
    w.serve("plain", indexes=())
    w.submit("a", "t", w.eq("v", 15))
    w.submit("a", "t", w.rng("v", 3, 26, top_k=w.P.TopK("v", 2)))
    w.submit("a", "t", w.P.Query())
    w.submit("a", "t", w.eq("v", 15), klass="bulk")
    w.submit("a", "t", w.P.Eq("v", Ct(4)))           # a bare predicate
    w.submit("a", "t", w.P.And(w.P.Eq("v", Ct(1)), w.P.Eq("w", Ct(2))))
    w.submit("a", "t", w.rng("v", 1, 2, order_by=w.P.OrderBy("v")))
    w.submit("a", "plain", w.eq("v", 15))
    w.idle()


def _point_before_bulk(w):
    w.serve("t")
    w.submit("a", "t", w.rng("v", 3, 97), klass="bulk")
    w.submit("a", "t", w.eq("v", 15))
    w.idle()


def _no_starvation(w):
    w.serve("t")
    for i in range(8):
        w.submit("a", "t", w.eq("v", i))
    w.submit("a", "t", w.rng("v", 3, 97), klass="bulk")
    w.pump()
    w.idle()


def _pow2(w):
    w.serve("t")
    for i in range(7):
        w.submit("a", "t", w.eq("v", i))
    w.idle()


def _fair_share(w):
    w.serve("t")
    for i in range(6):
        w.submit("a", "t", w.eq("v", i))
    w.submit("b", "t", w.eq("v", 97))
    w.submit("b", "t", w.eq("v", 93))
    w.pump()
    w.idle()


def _deadline_order(w):
    """Tenants drafted in order of their head's (deadline, admit seq)."""
    w.serve("t")
    w.submit("a", "t", w.eq("v", 1))
    w.submit("b", "t", w.eq("v", 2), deadline=50.0)
    w.submit("c", "t", w.eq("v", 3), deadline=20.0)
    w.submit("a", "t", w.eq("v", 4))
    w.idle()


def _shed(w):
    w.serve("t")
    w.submit("a", "t", w.eq("v", 15), deadline=5.0)
    w.submit("b", "t", w.eq("v", 26))
    w.clock.advance(6.0)
    w.pump()
    w.idle()


def _miss(w):
    w.serve("t", slow=10.0)
    w.submit("a", "t", w.eq("v", 15), deadline=5.0)
    w.submit("b", "t", w.eq("v", 16), deadline=50.0)
    w.pump()


def _writes_never_shed(w):
    w.serve("t")
    w.insert("a", "t", {"v": np.array([41])}, deadline=1.0)
    w.clock.advance(5.0)
    w.idle()


def _barrier(w):
    w.serve("t")
    w.submit("a", "t", w.eq("v", 41))
    w.insert("a", "t", {"v": np.array([41])})
    w.submit("a", "t", w.eq("v", 41))
    w.call(w.loop.submit_delete, "a", "t", [0, 3])
    w.call(w.loop.submit_update, "b", "t", [1], {"v": np.array([7])}, 4)
    w.submit("b", "t", w.rng("v", 0, 9), klass="bulk")
    w.idle()


def _fifo(w):
    w.serve("t")
    for i in range(5):
        w.clock.advance(0.5)
        w.submit("a", "t", w.eq("v", i))
    w.idle()


def _two_tables(w):
    """Writes first, then one point batch per table across all tables,
    then one bulk batch per table."""
    w.serve("t1")
    w.serve("t2")
    w.submit("a", "t1", w.rng("v", 1, 9), klass="bulk")
    w.submit("a", "t2", w.rng("v", 1, 9), klass="bulk")
    w.submit("a", "t1", w.eq("v", 1))
    w.insert("a", "t2", {"v": np.array([3])})
    w.submit("a", "t2", w.eq("v", 3))
    w.idle()


def _poisoned(w):
    w.serve("t")
    w.submit("a", "t", w.rng("v", 3, 97), klass="bulk")
    w.submit("b", "t", w.eq("nope", 15))
    w.submit("a", "t", w.rng("v", 5, 35), klass="bulk")
    w.idle()
    w.submit("b", "t", w.eq("v", 26))
    w.idle()


def _transient(w):
    w.serve("t", transient=1)
    for i in range(4):
        w.submit("a", "t", w.eq("v", i))
    w.idle()


def _persistent(w):
    w.serve("t", transient=5)
    w.submit("alice", "t", w.rng("v", 3, 97), klass="bulk")
    w.submit("bob", "t", w.eq("nope", 15))
    w.submit("bob", "t", w.rng("v", 5, 35), klass="bulk")
    w.idle()


def _failed_write(w):
    w.serve("t", columns=("v",))
    w.insert("a", "t", {"wrong_col": np.array([1])})
    w.submit("a", "t", w.eq("v", 15))
    w.idle()


def _retention(w):
    w.serve("t")
    tks = [w.submit("a", "t", w.eq("v", i)) for i in range(4)]
    w.idle()
    for t in tks:
        w.call(lambda t=t: w.loop.response(t).status)


def _forget(w):
    w.serve("t")
    t1 = w.submit("a", "t", w.eq("v", 15))
    w.idle()
    t2 = w.submit("a", "t", w.eq("v", 26))
    w.call(w.loop.forget, t2)
    w.idle()
    w.call(lambda: w.loop.forget(t1).status)
    w.call(w.loop.forget, t1)
    w.call(w.loop.response, t1)
    w.call(lambda: w.loop.response(t2).status)


def _heartbeat(w):
    w.serve("t")
    w.submit("a", "t", w.eq("v", 3))
    w.idle()
    w.pump()


def _overload(w):
    """The benchmark's admission demo: a late request, then a burst past
    a tenant cap of 4."""
    w.serve("alice_t", tenants=("alice",))
    w.submit("alice", "alice_t", w.eq("v", 0), deadline=-1.0)
    for i in range(8):
        w.submit("alice", "alice_t", w.eq("v", i))
    w.idle()


SCENARIOS = {
    "tenant_cap": ({"policy": {"tenant_queue_cap": 2}}, _tenant_cap),
    "total_cap": ({"policy": {"total_queue_cap": 2}}, _total_cap),
    "acl": ({}, _acl),
    "unknown_table": ({}, _unknown_table),
    "join_unsupported": ({}, _join_unsupported),
    "unknown_klass": ({}, _unknown_klass),
    "classification": ({}, _classification),
    "point_before_bulk": ({}, _point_before_bulk),
    "no_starvation": ({"batch": 4}, _no_starvation),
    "pow2": ({"batch": 8}, _pow2),
    "pow2_off": ({"batch": 8, "pow2_buckets": False}, _pow2),
    "fair_share": ({"policy": {"fair_share": 2}, "batch": 8}, _fair_share),
    "deadline_order": ({"policy": {"fair_share": 1}, "batch": 2},
                       _deadline_order),
    "shed": ({}, _shed),
    "miss": ({}, _miss),
    "writes_never_shed": ({}, _writes_never_shed),
    "barrier": ({}, _barrier),
    "fifo": ({"batch": 2}, _fifo),
    "two_tables": ({}, _two_tables),
    "poisoned": ({}, _poisoned),
    "transient": ({}, _transient),
    "persistent": ({}, _persistent),
    "failed_write": ({}, _failed_write),
    "retention": ({"max_responses": 2}, _retention),
    "forget": ({}, _forget),
    "heartbeat": ({"monitor": True}, _heartbeat),
    "overload": ({"policy": {"tenant_queue_cap": 4}, "batch": 8},
                 _overload),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scheduling_equals_reference(name):
    kw, script = SCENARIOS[name]
    records = []
    for pkg in (REF, PORT):
        w = World(pkg, **dict(kw))
        with pkg["obs"].tracing():
            script(w)
            records.append(w.record())
    want, got = records
    for key in want:
        assert got[key] == want[key], key
    assert got["stats"]["submitted"] > 0 or name == "unknown_table"


# ---------------------------------------------------------------------------
# real servers on bridged tables (test-bfv, n = 256)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    """(port ks, bridged table, port index, data, enc) from the shared
    test-bfv fixture of test_torch_db."""
    _, tks, _, table, data, enc = _fixture("test-bfv")
    return tks, table, TDB.SortedIndex.build(tks, table, "a"), data, enc


def _truth(vals, lo, hi):
    return np.nonzero((vals >= lo) & (vals <= hi))[0]


def test_answers_match_plain_query_server(bridged):
    """Point and bulk requests through the loop: the same row ids and
    masks as the port's plain server, the truth, and host results."""
    tks, table, idx, data, enc = bridged
    a = data["a"]
    bounds = [(int(a[2]), int(a[2])), (-10, 20), (-50, 0)]
    cts = {v: enc(v)[1] for pair in bounds for v in pair}
    plans = [TP.Query(where=TP.Eq("a", cts[bounds[0][0]])),
             TP.Query(where=TP.Range("a", cts[-10], cts[20])),
             TP.Query(where=TP.Or(TP.Range("a", cts[-50], cts[0]),
                                  TP.Eq("a", cts[bounds[0][0]])))]
    loop = TSL.ServeLoop(batch=4)
    loop.register("t", TDB.QueryServer(tks, table, indexes={"a": idx},
                                       batch=4))
    tickets = [loop.submit("alice", "t", q) for q in plans]
    tickets.append(loop.submit("bob", "t", plans[1], klass=TSL.BULK))
    res = loop.run_until_idle()
    plain = TDB.QueryServer(tks, table, indexes={"a": idx}, batch=4)
    qids = [plain.submit(q) for q in plans + [plans[1]]]
    want = plain.run()
    truths = [_truth(a, *bounds[0]), _truth(a, -10, 20),
              np.union1d(_truth(a, -50, 0), _truth(a, *bounds[0])),
              _truth(a, -10, 20)]
    assert [loop.response(t).klass for t in tickets] == [
        TSL.POINT, TSL.POINT, TSL.POINT, TSL.BULK]
    for t, q, truth in zip(tickets, qids, truths):
        r = res[t].result
        assert isinstance(r.row_ids, np.ndarray)
        assert isinstance(r.mask, np.ndarray)
        assert np.array_equal(r.row_ids, want[q].row_ids)
        assert np.array_equal(r.mask, want[q].mask)
        assert np.array_equal(np.sort(r.row_ids), truth)


def test_sharded_loop_matches_plain(bridged):
    tks, table, idx, data, enc = bridged
    stable = TDB.ShardedTable.from_table(tks, table,
                                         spec=TDB.ShardSpec.create(2))
    sidx = {"a": TDB.ShardedIndex.build(tks, stable, "a")}
    loop = TSL.ServeLoop()
    loop.register("sh", TDB.ShardedQueryServer(tks, stable, indexes=sidx))
    lo, hi = enc(-10)[1], enc(20)[1]
    v = int(data["a"][2])
    plans = [TP.Query(where=TP.Eq("a", enc(v)[1])),
             TP.Query(where=TP.Range("a", lo, hi))]
    tickets = [loop.submit("a", "sh", q) for q in plans]
    j = loop.submit_join("a", "sh", TP.Join(None, None, on="a"), table)
    res = loop.run_until_idle()
    assert all(loop.response(t).klass == TSL.POINT for t in tickets)
    for t, truth in zip(tickets, (_truth(data["a"], v, v),
                                  _truth(data["a"], -10, 20))):
        assert np.array_equal(np.sort(np.asarray(res[t].result.row_ids)),
                              truth)
    assert res[j].status == TSL.REJECTED
    assert "does not support joins" in res[j].error


def test_join_through_loop_matches_execute_join(bridged):
    tks, table, _, data, _ = bridged
    keys = (data["b"] % 4).astype(np.int64)
    left = TDB.Table.from_arrays(tks, "jl", {"a": keys}, 11)
    right = TDB.Table.from_arrays(tks, "jr", {"a": keys[:6]}, 12)
    loop = TSL.ServeLoop()
    loop.register("t", TDB.QueryServer(tks, left))
    j = TP.Join(None, None, on="a")
    t = loop.submit_join("a", "t", j, right, strategy="nested")
    res = loop.run_until_idle()
    want = TDB.execute_join(tks, left, right, j, strategy="nested")
    assert res[t].klass == TSL.BULK
    assert isinstance(res[t].result.pairs, np.ndarray)
    assert np.array_equal(res[t].result.pairs, want.pairs)
    assert np.array_equal(res[t].result.pairs,
                          np.argwhere(keys[:, None] == keys[None, :6]))


def test_query_sees_exactly_the_writes_admitted_before_it():
    """query, insert, query, delete, query through both loops over a
    bridged paper-mode table: the port's insert encrypts with the
    reference's samples, and every answer equals the reference loop's."""
    base = np.array([3, 14, 15, 9, 26, 5, 35, 8], np.int64)
    p = Pair("test-bfv", {"v": base}, 3)
    (r41, t41) = p.enc(41)
    r_rng, t_rng = p.range(0, 40)
    data = {"v": np.array([41, 7], np.int64)}
    key = jax.random.PRNGKey(10)
    rloop, tloop = RSL.ServeLoop(), TSL.ServeLoop()
    rloop.register("t", RDB.QueryServer(p.ref_ks, p.ref))
    tloop.register("t", TDB.QueryServer(p.ks, p.t))
    rt = [rloop.submit("a", "t", RP.Eq("v", r41)),
          rloop.submit_insert("a", "t", data, key),
          rloop.submit("a", "t", RP.Eq("v", r41)),
          rloop.submit_delete("a", "t", [1, 8]),
          rloop.submit("a", "t", r_rng)]
    tt = [tloop.submit("a", "t", TP.Eq("v", t41)),
          tloop.submit_insert("a", "t", data, 7,
                              samples=_samples(p.ref_ks, data, key)),
          tloop.submit("a", "t", TP.Eq("v", t41)),
          tloop.submit_delete("a", "t", [1, 8]),
          tloop.submit("a", "t", t_rng)]
    want, got = rloop.run_until_idle(), tloop.run_until_idle()
    assert tloop.batch_shapes == rloop.batch_shapes
    assert [s for (_, s, _) in tloop.batch_shapes] == [
        TSL.BULK, TSL.WRITE, TSL.BULK, TSL.WRITE, TSL.BULK]
    for r, t in zip(rt, tt):
        assert got[t].status == want[r].status == TSL.OK
        assert np.array_equal(got[t].result.row_ids, want[r].result.row_ids)
    assert len(got[tt[0]].result.row_ids) == 0
    assert np.array_equal(got[tt[2]].result.row_ids, [8])
    assert np.array_equal(got[tt[1]].result.row_ids, [8, 9])
    assert np.array_equal(np.sort(got[tt[4]].result.row_ids),
                          [0, 2, 3, 4, 5, 6, 7, 9])
    for c in ("c0", "c1"):
        assert np.array_equal(getattr(p.t.scan_column("v"), c).numpy(),
                              np.asarray(getattr(p.ref.scan_column("v"), c)))


def test_per_tenant_reconciliation(bridged):
    """Per-tenant registry counters sum to the loop totals (served reads,
    compare lanes, shed, misses, failures) across a point, a bulk scan, a
    poisoned plan, a shed request and a write."""
    tks, _, _, data, enc = bridged
    table = TDB.Table.from_arrays(tks, "t_rec", {"a": data["a"]}, 13)
    idx = {"a": TDB.SortedIndex.build(tks, table, "a")}
    clock = FakeClock()
    loop = TSL.ServeLoop(clock=clock)
    loop.register("t", TDB.QueryServer(tks, table, indexes=idx))
    with TO.tracing():
        loop.submit("alice", "t", TP.Eq("a", enc(int(data["a"][0]))[1]))
        loop.submit("bob", "t", TP.Range("a", enc(-20)[1], enc(20)[1]),
                    klass=TSL.BULK)
        loop.submit("bob", "t", TP.Eq("nope", enc(1)[1]))
        loop.submit("alice", "t", TP.Eq("a", enc(2)[1]), deadline=1.0)
        clock.advance(2.0)
        loop.submit_insert("alice", "t", {"a": np.array([60], np.int64)},
                           14)
        loop.submit("bob", "t", TP.Eq("a", enc(60)[1]))
        res = loop.run_until_idle()
        reg = TO.REGISTRY
        tenants = ("alice", "bob")
        reads = [r for r in res.values()
                 if r.status == TSL.OK and r.klass != TSL.WRITE]
        assert sum(reg.value("server.queries", tenant=t)
                   for t in tenants) == len(reads) == 3
        for t in tenants:
            assert reg.value("server.compares", tenant=t) == sum(
                r.result.stats.filter_compares for r in reads
                if r.tenant == t)
        for name, total in (("serve.shed", loop.stats.shed),
                            ("serve.failed", loop.stats.failed),
                            ("serve.deadline_miss",
                             loop.stats.deadline_miss)):
            assert sum(reg.value(name, tenant=t) for t in tenants) == total
    assert (loop.stats.shed, loop.stats.failed, loop.stats.served) == (
        1, 1, 4)
    last = max(res)
    assert np.array_equal(res[last].result.row_ids, [len(data["a"])])


def test_background_thread_serves_and_stops(bridged):
    """The always-on mode: the daemon pump serves two client threads'
    submissions exactly, then stops (joined)."""
    tks, table, idx, data, enc = bridged
    loop = TSL.ServeLoop(batch=4)
    loop.register("t", TDB.QueryServer(tks, table, indexes={"a": idx},
                                       batch=4))
    values = [int(v) for v in data["a"][:6]]
    cts = {v: enc(v)[1] for v in values}
    tickets = {}

    def client(vs):
        for v in vs:
            tickets[loop.submit("c", "t", TP.Eq("a", cts[v]))] = v
    loop.start(interval_s=0.001)
    try:
        threads = [threading.Thread(target=client, args=(values[i::2],))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        deadline = time.monotonic() + 120.0
        while (any(not loop.response(t).done for t in tickets)
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        loop.stop()
    assert loop._thread is None
    for t, v in tickets.items():
        r = loop.response(t)
        assert r.status == TSL.OK
        assert np.array_equal(np.sort(r.result.row_ids),
                              _truth(data["a"], v, v))


def test_serve_loop_cli_on_cpu():
    out = TSL.main(["--device", "cpu", "--rows", "48", "--requests", "6",
                    "--batch", "4"])
    assert out["correct"] == "6/6" and out["served"] == 6
    assert out["device"] == "cpu"


@pytest.mark.gpu
def test_cuda_loop_threads_exact():
    """On the card: two client threads encrypt and submit while the
    daemon pump serves them; every answer exact, none FAILED."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import encrypt as E
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    ks = keygen(make_params("test-bfv", mode="gadget"), 5, device="cuda")
    vals = np.random.default_rng(5).integers(0, 500, 300).astype(np.int64)
    table = TDB.Table.from_arrays(ks, "t", {"a": vals}, 6)
    loop = TSL.ServeLoop(batch=4)
    loop.register("t", TDB.QueryServer(
        ks, table, indexes={"a": TDB.SortedIndex.build(ks, table, "a")}))
    tickets = {}

    def client(seed):
        for i, v in enumerate(vals[seed::7][:6]):
            ct = E.encrypt(ks, int(v), 100 * seed + i)
            tickets[loop.submit(f"c{seed}", "t", TP.Eq("a", ct))] = int(v)
    loop.start(interval_s=0.001)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        deadline = time.monotonic() + 300.0
        while (any(not loop.response(t).done for t in tickets)
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        loop.stop()
    assert loop.stats.failed == 0 and loop.stats.served == len(tickets)
    for t, v in tickets.items():
        assert np.array_equal(np.sort(loop.response(t).result.row_ids),
                              _truth(vals, v, v))


@pytest.mark.parametrize("case", ["dead_host", "stragglers", "plan_mesh"])
def test_fleet_monitor_copy_matches_reference(case):
    """The port's copy of launch/elastic (the loop heartbeats its
    FleetMonitor) decides as the reference's: the cases of
    tests/test_fault_tolerance.py on both."""
    out = []
    for EL in (REL, TEL):
        if case == "dead_host":
            mon = EL.FleetMonitor(EL.ElasticConfig(beat_interval_s=1.0,
                                                   dead_after=3),
                                  [0, 1, 2, 3], now=0.0)
            for t in (1.0, 2.0, 3.0, 4.0):
                for h in (0, 1, 2):
                    mon.heartbeat(h, now=t)
            dead = mon.dead_hosts(now=4.0)
            mon.evict(dead)
            out.append((dead, mon.surviving()))
        elif case == "stragglers":
            mon = EL.FleetMonitor(EL.ElasticConfig(straggler_factor=3.0,
                                                   straggler_strikes=2),
                                  [0, 1, 2, 3], now=0.0)
            seen = []
            for step in range(3):
                for h in (0, 1, 2):
                    mon.heartbeat(h, step_time=1.0, now=float(step))
                mon.heartbeat(3, step_time=10.0 if step < 2 else 1.0,
                              now=float(step))
                seen.append(mon.stragglers())
            out.append((seen, dict(mon.strikes)))
        else:
            out.append([EL.plan_mesh(n, m) for n, m in
                        ((512, 16), (496, 16), (8, 16), (1, 16), (12, 4))])
    assert out[0] == out[1]
    if case == "dead_host":
        assert out[1] == ([3], [0, 1, 2])
    if case == "stragglers":
        assert out[1][0][:2] == [[], [3]]
