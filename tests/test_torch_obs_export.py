"""The port's observability layer (`repro_torch.obs`, with `export`)
against the reference's.

Two halves:

  * the layer itself — the same scripted events (nested spans, labelled
    counters, histogram samples, launch signatures) recorded through both
    packages give equal `metrics_dump` snapshots, nearest-rank
    percentiles, `bench_fields`, retrace counts and span trees
    (`tree_lines`, durations masked); `validate_chrome_trace` judges
    documents as the reference does, and the port's trace files are
    valid;
  * the engine's reconciliation contract (`tests/test_obs.py`'s engine
    half) on bridged tables: the reference's table and trapdoors run
    through both engines traced, and span trees and counters equal the
    reference's; per-query compare lanes sum to the batch totals, each
    query's share of the fused launch is 1, tenants are billed their
    own lanes.
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro import obs as RO
from repro.db import plan as RP
from repro.db.index import SortedIndex as RefIndex
from repro.db.query_serve import QueryServer as RefServer
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.db import plan as TP
from repro_torch.db.index import SortedIndex as TorchIndex
from repro_torch.db.query_serve import QueryServer as TorchServer

from test_torch_db import N_ROWS, _fixture
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


# a wall-clock histogram: its count is compared, its values are times
TIMED = ("server.batch_wall_s",)

# the port's spans and counters that the reference has no counterpart of
# (tests/test_torch_obs_trace.py holds where each is made); the trees and
# snapshots compared with the reference's leave them out, a left-out
# span's children taking its place
PORT_ONLY_SPANS = (
    "executor.tile_launch", "executor.tile_wait", "executor.tile_copy",
    "server.combine", "index.probe_step", "index.probe_wait",
    "delta.index_sort", "compact.delta_index", "compact.pad_blocks",
    "compact.fold")
PORT_ONLY_COUNTERS = ("compact.bytes", "mem.cuda_mallocs")


def _masked_tree(tracer, skip=()):
    return [re.sub(r"\d+\.\d+ms", "_ms", ln)
            for ln in tracer.tree_lines(*((skip,) if skip else ()))]


def _comparable(snapshot):
    """A metrics snapshot with the wall-clock histograms cut to counts and
    the port-only counters left out."""
    return {k: ({"count": v["count"]} if k.split("{")[0] in TIMED else v)
            for k, v in snapshot.items()
            if k.split("{")[0] not in PORT_ONLY_COUNTERS}


# ---------------------------------------------------------------------------
# the layer itself
# ---------------------------------------------------------------------------

def _script(obs):
    """One fixed stream of events through either package's obs."""
    with obs.tracing() as tr:
        with obs.span("outer", k=np.int64(3), f=np.float32(0.5)) as sp:
            sp.set(extra="x")
            with obs.span("inner", n=1):
                obs.count("eval.launches", 2)
                obs.count("eval.lanes", 96)
                with obs.span("leaf"):
                    obs.jit_launch("site.a", np.zeros((4, 2), np.int64))
            with obs.span("inner", n=2):
                obs.jit_launch("site.a", np.zeros((4, 2), np.int64))
                obs.jit_launch("site.a", np.zeros((8, 2), np.int64))
                obs.jit_launch("site.b", (3, 5), np.zeros((2,), np.int32))
        assert obs.current_span() is None
        for v in (5.0, 1.0, 4.0, 2.0, 3.0, 9.5, 0.25):
            obs.observe("serve.queue_wait_s", v, klass="point")
        obs.observe("pad.waste", 1.6)
        obs.count("server.queries", 3, tenant="alice")
        obs.count("server.queries", 1, tenant="bob")
        obs.count("jit.extra", 0)
        return {"dump": obs.metrics_dump(), "fields": obs.bench_fields(),
                "retraces": obs.jit_retraces(),
                "sites": sorted(obs.jit_signatures()),
                "tree": _masked_tree(tr),
                "roots": [s.name for s in tr.roots()],
                "chrome": tr.chrome_trace(),
                "depths": sorted((s.name, s.depth) for s in tr.spans)}


def test_same_events_export_equal_reference():
    want, got = _script(RO), _script(TO)
    assert got["dump"]["metrics"] == want["dump"]["metrics"]
    assert list(got["dump"]) == list(want["dump"]) == \
        ["metrics", "jit_signatures"]
    assert got["dump"]["jit_signatures"] == want["dump"]["jit_signatures"]
    assert got["fields"] == want["fields"] == {
        "eval_launches": 2, "compare_lanes": 96, "jit_retraces": 1}
    assert got["retraces"] == want["retraces"] == 1
    assert got["sites"] == want["sites"] == ["site.a", "site.b"]
    assert got["tree"] == want["tree"]
    assert got["tree"][0].startswith("outer  _ms  [k=3 f=0.5 extra=x]")
    assert got["roots"] == want["roots"] == ["outer"]
    assert got["depths"] == want["depths"]
    assert TO.validate_chrome_trace(got["chrome"]) == []
    assert [e["name"] for e in got["chrome"]["traceEvents"]] == \
        [e["name"] for e in want["chrome"]["traceEvents"]]
    assert not TO.is_enabled() and not RO.is_enabled()


@pytest.mark.parametrize("values", [
    [], [7.0], [3.0, 1.0], [5.0, 1.0, 4.0, 2.0, 3.0],
    list(np.arange(100.0)), list(np.linspace(-1, 1, 37)),
    [2.0] * 9 + [100.0]])
def test_percentiles_nearest_rank_equal_reference(values):
    th, rh = TO.Histogram(), RO.Histogram()
    for v in values:
        th.observe(v)
        rh.observe(v)
    for p in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert th.percentile(p) == rh.percentile(p), p
    assert th.summary() == rh.summary()
    assert (th.count, th.total) == (rh.count, rh.total)
    if values:                       # nearest rank: ceil(p/100 n)-th value
        xs = sorted(values)
        assert th.percentile(50) == xs[-(-50 * len(xs) // 100) - 1]


@pytest.mark.parametrize("doc", [
    {"traceEvents": []},
    {"traceEvents": [{"ph": "X", "ts": 0, "pid": 1, "name": "a",
                      "tid": 2, "dur": 1.0}]},
    '{"traceEvents": [{"ph": "i", "ts": 0, "pid": 1}]}',
    "{not json",
    {"events": []},
    [1, 2],
    {"traceEvents": [3, {"ph": "X"}, {"ts": 1, "pid": 0}]},
    {"traceEvents": [{"ph": "X", "ts": 0, "pid": 1, "tid": 1}]},
], ids=["empty", "complete", "string", "bad-json", "no-list", "not-dict",
        "missing-keys", "complete-missing"])
def test_validate_chrome_trace_equals_reference(doc):
    got = TO.validate_chrome_trace(doc)
    want = RO.validate_chrome_trace(doc)
    if isinstance(doc, str) and doc.startswith("{not"):
        assert got and got[0].startswith("not JSON")
        assert want and want[0].startswith("not JSON")
    else:
        assert got == want


def test_disabled_layer_is_a_noop():
    assert not TO.is_enabled()
    s1, s2 = TO.span("a", x=1), TO.span("b")
    assert s1 is s2                      # no allocation on the hot path
    with s1 as sp:
        sp.set(y=2)
        assert sp.sync(123) == 123       # identity, never blocks
    before = dict(TO.REGISTRY.snapshot())
    TO.count("eval.launches", 5)
    TO.observe("pad.waste", 2.0)
    TO.jit_launch("nowhere", np.zeros((2, 2)))
    assert TO.REGISTRY.snapshot() == before
    assert TO.current_span() is None and TO.get_tracer() is TO.TRACER
    pairs = len(TO.TRACER.clock_pairs)
    TO.mark_clock()
    assert TO.stamp() == 0.0 and len(TO.TRACER.clock_pairs) == pairs
    assert TO.count_mallocs("compact", torch.device("cuda", 0)) is s1


def test_trace_and_metrics_files_from_a_served_batch(tmp_path):
    """A traced port server run writes a valid Chrome trace and a metrics
    file whose counters are the registry's."""
    _, tks, _, table, _, enc = _fixture("test-bfv")
    srv = TorchServer(tks, table, batch=2)
    srv.submit(TP.Eq("a", enc(3)[1]), tenant="alice")
    srv.submit(TP.Range("a", enc(-10)[1], enc(10)[1]), tenant="bob")
    with TO.tracing() as tr:
        srv.run()
        TO.write_chrome_trace(tmp_path / "t.json")
        TO.write_metrics(tmp_path / "m.json")
        snap = TO.REGISTRY.snapshot()
    doc = json.loads((tmp_path / "t.json").read_text())
    assert TO.validate_chrome_trace(doc) == []
    assert TO.validate_chrome_trace((tmp_path / "t.json").read_text()) == []
    assert {e["name"] for e in doc["traceEvents"]} >= {
        "server.batch", "executor.fused_eval"}
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["metrics"] == json.loads(json.dumps(snap))
    assert m["metrics"]["server.batches"] == 1
    assert "executor.fused_eval" in "\n".join(tr.tree_lines())
    assert TO.chrome_trace(tr) == tr.chrome_trace()


# ---------------------------------------------------------------------------
# the engine's reconciliation contract, on bridged tables
# ---------------------------------------------------------------------------

def _both_traced(run_ref, run_port):
    """Run each engine's case traced; returns (reference, port) records
    of (result, snapshot, masked tree, spans); the port's tree and
    snapshot without its port-only spans and counters."""
    out = []
    for obs, run, skip in ((RO, run_ref, ()), (TO, run_port,
                                                PORT_ONLY_SPANS)):
        with obs.tracing() as tr:
            res = run()
            out.append((res, _comparable(obs.REGISTRY.snapshot()),
                        _masked_tree(tr, skip), list(tr.spans)))
    return out


@pytest.mark.parametrize("name", PORT_ONLY_SPANS + PORT_ONLY_COUNTERS)
def test_port_only_names_are_recorded(name):
    """Each port-only name is recorded by a traced run through the loop
    (an insert, an indexed and a scanned read, a compaction), or, for
    the allocator's counter, around a span on a card."""
    from test_torch_obs_trace import traced_scenario
    run = traced_scenario()
    if name == "mem.cuda_mallocs":       # CUDA only: the reads stubbed
        reads = iter([{"segment.all.allocated": 2}] * 2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "memory_stats",
                       lambda device=None: next(reads))
            with TO.tracing():
                with TO.count_mallocs("compact", torch.device("cuda", 0)):
                    pass
                snap = TO.REGISTRY.snapshot()
        assert snap == {"mem.cuda_mallocs{span=compact}": 0}
    elif name in PORT_ONLY_COUNTERS:
        assert any(k.split("{")[0] == name for k in run["snap"])
    else:
        assert name in {s.name for s in run["spans"]}
    scenario = TO.Tracer()
    scenario.spans = run["spans"]
    assert name not in "\n".join(_masked_tree(scenario, PORT_ONLY_SPANS))


def _indexes():
    _, tks, ref_table, table, _, _ = _fixture("test-bfv")
    ref_ks = _fixture("test-bfv")[0]
    return (RefIndex.build(ref_ks, ref_table, "a"),
            TorchIndex.build(tks, table, "a"))


def test_traced_scan_query_span_tree_equals_reference():
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    r, t = enc(int(_fixture("test-bfv")[4]["a"][2]))
    (rres, rsnap, rtree, _), (tres, tsnap, ttree, spans) = _both_traced(
        lambda: RDB.execute(ref_ks, ref_table, RP.Eq("a", r)),
        lambda: TDB.execute(tks, table, TP.Eq("a", t)))
    assert np.array_equal(tres.row_ids, rres.row_ids)
    assert ttree == rtree and tsnap == rsnap
    names = [s.name for s in spans]
    assert names.count("executor.fused_eval") == tres.stats.eval_calls == 1
    fe = next(s for s in spans if s.name == "executor.fused_eval")
    ex = next(s for s in spans if s.name == "executor.execute")
    assert fe.parent_sid == ex.sid               # launch nests in execute
    assert tsnap["eval.launches"] == 1
    assert tsnap["eval.lanes"] == tres.stats.scan_compares
    assert tsnap["exec.scan_compares"] == tres.stats.scan_compares


def test_traced_indexed_query_has_probe_spans():
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    ridx, tidx = _indexes()
    (rl, tl), (rh, th) = enc(-5), enc(30)
    (rres, rsnap, rtree, _), (tres, tsnap, ttree, spans) = _both_traced(
        lambda: RDB.execute(ref_ks, ref_table, RP.Range("a", rl, rh),
                            indexes={"a": ridx}),
        lambda: TDB.execute(tks, table, TP.Range("a", tl, th),
                            indexes={"a": tidx}))
    assert np.array_equal(tres.row_ids, rres.row_ids)
    assert ttree == rtree and tsnap == rsnap
    search = next(s for s in spans if s.name == "index.search")
    assert search.args["probes"] == tres.stats.index_compares
    assert tsnap["index.probes"] == tres.stats.index_compares
    assert tsnap["eval.launches"] > 0
    assert tsnap["eval.lanes"] >= tres.stats.index_compares


@pytest.mark.parametrize("indexed", [False, True])
def test_reconcile_server_batch_and_tenants_equal_reference(indexed):
    """A batch of 4 (scan or indexed): per-query lanes sum to the batch
    totals, each query's share of the fused launch is 1, each tenant is
    billed its own lanes — and the port's counters and span tree equal
    the reference's."""
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    ridx, tidx = _indexes() if indexed else (None, None)
    cts = [enc(v) for v in (-40, -3, 0, 12, 25, 49, 7)]
    bounds = [(0, 3), (1, 4), (2, 5)]

    def plans(P, side):
        qs = [P.Range("a", cts[lo][side], cts[hi][side])
              for lo, hi in bounds]
        return qs + [P.Eq("a", cts[6][side])]

    def run(Server, ks, tab, idx, P, side):
        srv = Server(ks, tab, batch=4,
                     indexes={"a": idx} if indexed else None)
        ids = [srv.submit(q, tenant=("alice", "bob")[i % 2])
               for i, q in enumerate(plans(P, side))]
        return srv, ids, srv.run()
    (rrun, rsnap, rtree, _), (trun, tsnap, ttree, _) = _both_traced(
        lambda: run(RefServer, ref_ks, ref_table, ridx, RP, 0),
        lambda: run(TorchServer, tks, table, tidx, TP, 1))
    srv, ids, res = trun
    b = srv.batch_log[-1]
    assert tsnap == rsnap and ttree == rtree
    for q in ids:
        assert np.array_equal(res[q].row_ids, rrun[2][q].row_ids)
    assert sum(res[q].stats.scan_compares for q in ids) == b.scan_compares
    assert sum(res[q].stats.index_compares for q in ids) == b.index_compares
    if indexed:
        assert b.scan_compares == 0 and b.eval_calls == 0
        assert all(res[q].stats.index_compares > 0 for q in ids)
        assert tsnap["index.probes"] == b.index_compares
    else:
        assert b.eval_calls == 1
        assert all(res[q].stats.eval_calls == 1 for q in ids)
    for i, tenant in enumerate(("alice", "bob")):
        mine = ids[i::2]
        assert tsnap[f"server.queries{{tenant={tenant}}}"] == len(mine)
        assert tsnap[f"server.compares{{tenant={tenant}}}"] == sum(
            res[q].stats.filter_compares for q in mine)
    assert tsnap["server.batches"] == 1


def test_reconcile_mutation_batch_bills_delta_probes():
    """After an insert the probe path is base ∪ delta: each query carries
    both shares and the shares sum to the batch total."""
    _, tks, _, _, data, enc = _fixture("test-bfv")
    table = TDB.Table.from_arrays(tks, "t_mut", {"a": data["a"]}, 5,
                                  )
    idx = TorchIndex.build(tks, table, "a")
    srv = TorchServer(tks, table, indexes={"a": idx}, batch=4)
    srv.submit_insert({"a": np.array([7, 50], np.int64)}, 77)
    srv.run()
    ids = [srv.submit(TP.Range("a", enc(5)[1], enc(60)[1])),
           srv.submit(TP.Eq("a", enc(50)[1]))]
    with TO.tracing() as tr:
        res = srv.run()
    b = srv.batch_log[-1]
    assert table.n_delta > 0
    assert sum(res[q].stats.index_compares for q in ids) == b.index_compares
    base_depth = max(1, (table.n_rows - 1).bit_length())
    assert all(res[q].stats.index_compares > 2 * base_depth for q in ids)
    vals = np.concatenate([data["a"], [7, 50]])
    assert np.array_equal(res[ids[0]].mask, (vals >= 5) & (vals <= 60))
    assert "delta.index_build" in {s.name for s in tr.spans}


def test_reconcile_join_batch():
    _, tks, _, _, data, _ = _fixture("test-bfv")
    keys = (data["b"] % 8).astype(np.int64)
    left = TDB.Table.from_arrays(tks, "jl", {"k": keys}, 4)
    right = TDB.Table.from_arrays(tks, "jr", {"k": keys[:6]}, 3)
    srv = TorchServer(tks, left, batch=2)
    jid = srv.submit_join(TP.Join(None, None, on="k"), right)
    with TO.tracing() as tr:
        res = srv.run()
        snap = TO.REGISTRY.snapshot()
    b = srv.batch_log[-1]
    js = res[jid].stats
    assert js.left.scan_compares + js.right.scan_compares == b.scan_compares
    assert b.pair_compares == js.pair_compares > 0
    want = np.argwhere(keys[:, None] == keys[None, :6])
    assert np.array_equal(res[jid].pairs, want)
    assert isinstance(res[jid].pairs, np.ndarray)
    assert snap["server.compares{tenant=default}"] == js.join_compares
    assert "join.pair_grid" in {s.name for s in tr.spans}


def test_reconcile_sharded_batch_and_span_nesting():
    """Sharded server: lanes reconcile and every shard search span nests
    under the batch span."""
    _, tks, _, table, data, enc = _fixture("test-bfv")
    st = TDB.ShardedTable.from_table(tks, table, spec=TDB.ShardSpec.create(2))
    idx = TDB.ShardedIndex.build(tks, st, "a")
    srv = TDB.ShardedQueryServer(tks, st, indexes={"a": idx}, batch=3)
    ids = [srv.submit(TP.Range("a", enc(-3)[1], enc(26)[1])),
           srv.submit(TP.Eq("a", enc(int(data["a"][0]))[1]))]
    with TO.tracing() as tr:
        res = srv.run()
    b = srv.batch_log[-1]
    assert sum(res[q].stats.index_compares for q in ids) == b.index_compares
    assert all(res[q].stats.index_compares > 0 for q in ids)
    spans = tr.spans
    batch = next(s for s in spans if s.name == "server.shard_batch")
    nested = [s for s in spans if s.name == "shard.index.search"]
    assert nested, "fan-out search must be traced"
    for s in nested:
        cur = s
        while cur.parent_sid != -1:
            cur = next(p for p in spans if p.sid == cur.parent_sid)
        assert cur.sid == batch.sid
    assert TO.validate_chrome_trace(TO.chrome_trace()) == []
    assert np.array_equal(np.sort(res[ids[0]].row_ids),
                          np.nonzero((data["a"] >= -3)
                                     & (data["a"] <= 26))[0])


def test_traced_compaction_has_merge_round_spans():
    _, tks, _, _, data, _ = _fixture("test-bfv")
    table = TDB.Table.from_arrays(tks, "t_cmp", {"a": data["a"]}, 6)
    indexes = {"a": TorchIndex.build(tks, table, "a")}
    table.insert(tks, {"a": np.array([7, 50, 2], np.int64)}, 5)
    with TO.tracing() as tr:
        cstats = TDB.compact(tks, table, indexes)
        snap = TO.REGISTRY.snapshot()
    names = [s.name for s in tr.spans]
    assert "compact" in names and "compact.merge_index" in names
    rounds = [s for s in tr.spans if s.name == "merge.round"]
    assert len(rounds) == cstats.merge_rounds > 0
    assert snap["compact.merge_compares"] == cstats.merge_compares
    assert snap["eval.launches"] > 0
    assert not table.has_delta
    assert N_ROWS == len(data["a"])
