"""The port's own tracing (`repro_torch.obs`), which the reference has
no counterpart of: the phase spans inside the scan, probe and write
paths, the compaction phases' bytes, the request chain from a
`ServeLoop` ticket to its spans and launch records, the launch records
themselves, the span clock on the Unix clock (`to_unix_ns`), the match
of launch records with device events (`match_launches`), and the
disabled path.  Port only, on one tiny test-bfv table: no JAX."""
import functools
import math
import time

import numpy as np
import torch

from repro_torch import db, obs
from repro_torch.core import compare as C
from repro_torch.core import encrypt as E
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.db import delta as D
from repro_torch.db.serve_loop import ServeLoop
from repro_torch.kernels import _build
from repro_torch.kernels import ops as KO

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

TILE_PHASES = ("executor.tile_launch", "executor.tile_wait",
               "executor.tile_copy")
VALS = np.array([3, 14, 15, 9, 26, 5, 35, 8, 97, 93, 23, 84], np.int64)
AUX = np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3], np.int64)


@functools.lru_cache(maxsize=None)
def _keys():
    return keygen(make_params("test-bfv", mode="gadget"), 0, device="cpu")


def _server(ks):
    table = db.Table.from_arrays(ks, "obs", {"v": VALS, "a": AUX}, 1)
    idx = db.SortedIndex.build(ks, table, "v")
    # lane_budget 8: the 16-slot scan of one atom runs in 2 tiles
    return db.QueryServer(ks, table, indexes={"v": idx}, batch=4,
                          lane_budget=8)


def _launching_tiles(monkeypatch):
    """Have each fused-scan tile record one gadget Eval launch, as the
    card's wrapper does (the CPU runs its plain version, which launches
    nothing); the launch counts are a copy, restored after."""
    real = KO.dedup_tile_values
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))

    def tile(ks, uniq, sel, bounds, lo, t):
        t_in = _build.stamp()
        out = real(ks, uniq, sel, bounds, lo, t)
        _build.count_launch("eval_coeff0_gadget", t_in, _build.stamp(),
                            lanes=len(sel) * t, rows=t, K=2, D=4, n=256,
                            uniq=1)
        return out
    monkeypatch.setattr(KO, "dedup_tile_values", tile)


@functools.lru_cache(maxsize=None)
def traced_scenario():
    """One traced run through the loop: an insert, then an indexed Range
    and a scanned Eq in one batch (the delta run's index built fresh),
    then a second insert and a compaction (its delta index fresh too).
    Returns a dict of what the run left."""
    ks = _keys()
    server = _server(ks)
    table = server.table
    loop = ServeLoop(batch=4)
    loop.register("t", server)

    def enc(v, s):
        return E.encrypt(ks, int(v), s)
    with obs.tracing() as tr:
        t_w = loop.submit_insert("w", "t", {"v": np.array([7, 50]),
                                            "a": np.array([2, 2])}, 11)
        t_r = loop.submit("r", "t", db.Range("v", enc(5, 2), enc(30, 3)))
        t_s = loop.submit("r", "t", db.Eq("a", enc(2, 4)))
        resp = loop.run_until_idle()
        base_probes = server.indexes["v"].last_probe_counts.copy()
        table.insert(ks, {"v": np.array([40]), "a": np.array([1])}, 12)
        n_base, n_delta = table.n_rows, table.n_delta
        cstats = server.compact()
        snap = obs.REGISTRY.snapshot()
        spans = list(tr.spans)
        chains = {t: tr.request_spans(t) for t in (t_w, t_r, t_s)}
    return {"ks": ks, "spans": spans, "snap": snap,
            "resp": resp, "tickets": (t_w, t_r, t_s), "chains": chains,
            "base_probes": base_probes, "n_base": n_base,
            "n_delta": n_delta, "cstats": cstats, "pumps": loop.stats.pumps,
            "pairs": list(tr.clock_pairs)}


def _kids(spans, sp):
    return sorted((s for s in spans if s.parent_sid == sp.sid),
                  key=lambda s: s.t0)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_phase_spans_nest_under_their_parents():
    run = traced_scenario()
    spans, snap = run["spans"], run["snap"]
    tiles = _named(spans, "executor.eval_tile")
    assert len(tiles) == snap["eval.tiles"] == 3     # 16 + 2 delta slots
    for tile in tiles:
        assert [k.name for k in _kids(spans, tile)] == list(TILE_PHASES)
    fused, = _named(spans, "executor.fused_eval")
    assert {k.name for k in _kids(spans, fused)} == {"executor.eval_tile"}
    # the loop drafts the Eq (point) and the Range (bulk) apart
    reads = [s for s in _named(spans, "server.batch")
             if s.args.get("queries")]
    assert len(reads) == 2
    for batch in reads:
        kids = [k for k in _kids(spans, batch)]
        combine = [k for k in kids if k.name == "server.combine"]
        assert len(combine) == 1
        assert combine[0].args["queries"] == batch.args["queries"] == 1
    assert len(_named(spans, "server.combine")) == 2
    # a search's steps: one per binary-search iteration, each with one
    # wait; every lane is active from the first step, so the base
    # search's steps are its lanes' largest probe count
    searches = _named(spans, "index.search")
    assert len(searches) == 2                    # base run + delta run
    steps = 0
    for search in searches:
        kids = _kids(spans, search)
        assert kids and {k.name for k in kids} == {"index.probe_step"}
        for step in kids:
            assert [w.name for w in _kids(spans, step)] == [
                "index.probe_wait"]
        assert len(kids) <= math.ceil(math.log2(search.args["rows"] + 1))
        steps += len(kids)
    base = next(s for s in searches if s.args["rows"] == len(VALS))
    assert len(_kids(spans, base)) == run["base_probes"].max()
    assert steps == snap["launches{site=index.probe}"]
    # the delta run's index is sorted fresh under its build span, once
    build, = _named(spans, "delta.index_build")
    assert build.args["fresh"] is True
    assert [k.name for k in _kids(spans, build)] == ["delta.index_sort"]


def test_compaction_phases_carry_bytes_from_shapes():
    run = traced_scenario()
    spans, snap, ks = run["spans"], run["snap"], run["ks"]
    compact, = _named(spans, "compact")
    assert [k.name for k in _kids(spans, compact)] == [
        "compact.delta_index", "compact.merge_index", "compact.fold"]
    merge, = _named(spans, "compact.merge_index")
    assert _kids(spans, merge)[0].name == "compact.pad_blocks"
    # the insert after the reads left the delta index stale: sorted fresh
    di, = _named(spans, "compact.delta_index")
    assert di.args["fresh"] is True
    assert [k.name for k in _kids(spans, di)] == ["delta.index_sort"]

    K, n = ks.params.num_towers, ks.params.n
    row = 2 * K * n * 8                           # c0 + c1, int64
    nb, nd = run["n_base"], run["n_delta"]
    m, L = nb + nd, C.next_pow2(max(nb, nd))
    slots = C.next_pow2(m)
    merge_compares = L * (1 + int(math.log2(L)))  # 2 runs of L merged
    assert run["cstats"].merge_compares == merge_compares
    d_pad = C.next_pow2(nd)
    sort_compares = (d_pad // 2) * sum(range(1, d_pad.bit_length()))
    want = {
        "delta_index": 4 * sort_compares * row,
        "pad_blocks": (2 * m + (2 * L - m)) * row,
        "merge_index": (4 * merge_compares + 2 * m) * row,
        "fold": 2 * (3 * slots - m) * row,        # two columns
    }
    got = {s.name.split(".", 1)[1]: s.args["bytes"] for s in spans
           if s.name in ("compact.delta_index", "compact.pad_blocks",
                         "compact.merge_index", "compact.fold")}
    assert got == want
    for phase, b in want.items():
        assert snap[f"compact.bytes{{phase={phase}}}"] == b
    assert sum(v for k, v in snap.items()
               if k.startswith("compact.bytes{")) == sum(want.values())
    assert snap["compact.runs"] == 1
    # a CPU table: no allocator to read
    assert not any(k.startswith("mem.cuda_mallocs") for k in snap)


def test_request_chain_reaches_the_tickets_tiles(monkeypatch):
    run = traced_scenario()
    t_w, t_r, t_s = run["tickets"]
    assert all(run["resp"][t].status == "OK" for t in (t_w, t_r, t_s))
    write = [s.name for s in run["chains"][t_w]]
    assert write[0] == "serve.batch" and "server.mutation" in write
    assert "server.batch" not in write
    ranged = [s.name for s in run["chains"][t_r]]
    scanned = [s.name for s in run["chains"][t_s]]
    assert ranged[0] == scanned[0] == "serve.batch"
    assert {"server.batch", "index.search", "index.probe_step",
            "server.combine"} <= set(ranged)
    assert "executor.eval_tile" not in ranged
    assert {"server.batch", "executor.eval_tile", "executor.tile_launch",
            "server.combine"} <= set(scanned)
    assert "index.search" not in scanned
    # the loop reads a clock pair at the tracing's open and each pump
    assert len(run["pairs"]) == 1 + run["pumps"]

    # launch records, made in the tile spans, are reached from a ticket
    _launching_tiles(monkeypatch)
    ks = _keys()
    loop = ServeLoop(batch=2)
    loop.register("t", _server(ks))
    with obs.tracing() as tr:
        t = loop.submit("r", "t", db.Eq("a", E.encrypt(ks, 2, 4)))
        loop.run_until_idle()
    recs = tr.request_launches(t)
    launch_spans = {s.sid: s for s in tr.request_spans(t)}
    assert len(recs) == len(tr.launches) == 2
    assert all(launch_spans[r.sid].name == "executor.tile_launch"
               for r in recs)
    assert tr.request_launches(t + 99) == []


def test_launch_records_from_count_launch(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    before = time.time_ns()
    with obs.tracing() as tr:
        with obs.span("outer") as sp:
            t_in = _build.stamp()
            t_call = _build.stamp()
            _build.count_launch("ntt_br_inv", t_in, t_call, rows=8, K=2,
                                n=16384, fwd=False, form="narrow")
        _build.count_launch("negacyclic_mul_ntt", _build.stamp(),
                            _build.stamp(), rows=3, K=2, n=4096)
        doc = tr.chrome_trace()
    after = time.time_ns()
    assert _build.LAUNCHES["ntt_br_inv"] == 1
    a, b = tr.launches
    assert (a.kernel, a.symbol, a.sid) == ("ntt_br_inv", "ntt_br_", sp.sid)
    assert a.work == {"rows": 8, "K": 2, "n": 16384, "form": "narrow",
                      "fwd": False}
    assert 0 < a.t_in <= a.t_call <= a.t_ret and a.host_s >= 0
    assert (b.symbol, b.sid) == ("negacyclic_mul_kernel<false>", -1)
    events = [e for e in doc["traceEvents"] if e.get("cat") == "launch"]
    assert [e["name"] for e in events] == ["ntt_br_inv",
                                           "negacyclic_mul_ntt"]
    assert events[0]["args"]["sid"] == sp.sid
    # spans and launches stamped in Unix µs, as the profiler's traces
    for e in doc["traceEvents"]:
        assert before / 1e3 - 1e3 <= e["ts"] <= after / 1e3 + 1e3


def test_to_unix_ns_takes_the_nearest_pair():
    tr = obs.Tracer()
    tr.clock_pairs = [(1_000_000_000, 5_000_000_000_000),
                      (2_000_000_000, 5_000_001_000_500)]   # 500 ns drift
    assert tr.to_unix_ns(1.2) == 5_000_000_000_000 + 200_000_000
    assert tr.to_unix_ns(1.9) == 5_000_001_000_500 - 100_000_000
    assert tr.to_unix_ns(0.5) == 5_000_000_000_000 - 500_000_000
    assert tr.to_unix_ns(3.0) == 5_000_001_000_500 + 1_000_000_000
    fresh = obs.Tracer()                  # no pair yet: one is read
    now = time.perf_counter()
    assert abs(fresh.to_unix_ns(now) - time.time_ns()) < 50_000_000
    assert len(fresh.clock_pairs) == 1


def test_match_launches_pairs_in_launch_order():
    tr = obs.Tracer()
    tr.clock_pairs = [(0, 10_000_000_000)]      # span clock 0 = Unix 10 s

    def rec(kernel, symbol, t_call, sid):
        return obs.Launch(kernel, symbol, t_call - 1e-6, t_call,
                          t_call + 2e-6, sid, 1, {})
    records = [rec("negacyclic_mul_ntt", "negacyclic_mul_kernel<false>",
                   0.003, 7),
               rec("eval_coeff0_gadget", "eval_gadget_kernel", 0.001, 5),
               rec("eval_coeff0_gadget", "eval_gadget_kernel", 0.002, 6)]
    events = [
        ("void eval_gadget_kernel<2, 8, 1>(long const*)",
         10_001_000_000 + 30_000, 10_001_500_000),
        ("void eval_gadget_kernel<2, 8, 1>(long const*)",
         10_002_000_000 - 4_000, 10_002_100_000),          # before its call
        ("void negacyclic_mul_kernel<false>(long const*)",
         10_003_000_000 + 9_000, 10_003_200_000),
        ("void negacyclic_mul_kernel<true>(long const*)", 1, 2),
        ("Memcpy DtoH (Device -> Pageable)", 5, 6),
    ]
    got = obs.match_launches(records, events, tr)
    assert [(m["kernel"], m["sid"], m["lead_ns"]) for m in got] == [
        ("eval_coeff0_gadget", 5, 30_000),
        ("eval_coeff0_gadget", 6, -4_000),
        ("negacyclic_mul_ntt", 7, 9_000)]
    assert got[0]["call_ns"] == 10_001_000_000
    assert obs.match_launches(records[:1], events[:2], tr) == []


def test_cuda_mallocs_are_counted_while_tracing(monkeypatch):
    reads = iter([{"segment.all.allocated": 5},
                  {"segment.all.allocated": 8}])
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device=None: next(reads))
    card = torch.device("cuda", 0)
    with obs.tracing():
        with obs.count_mallocs("compact", card):
            pass
        with obs.count_mallocs("compact", torch.device("cpu")):
            pass
        snap = obs.REGISTRY.snapshot()
    assert snap == {"mem.cuda_mallocs{span=compact}": 3}


def test_disabled_tracing_records_nothing(monkeypatch):
    """Tracing off: no span, no launch record, no clock pair, no stamp,
    and the allocator is never asked, on the scan, probe and write
    paths and around a launch."""
    def refuse(*a, **k):
        raise AssertionError("memory_stats called with tracing off")
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    assert not obs.is_enabled()
    tr = obs.get_tracer()
    marks = (len(tr.spans), len(tr.launches), len(tr.clock_pairs))
    ks = _keys()
    server = _server(ks)
    server.submit_insert({"v": np.array([7]), "a": np.array([2])}, 11)
    server.submit(db.Range("v", E.encrypt(ks, 5, 2), E.encrypt(ks, 30, 3)))
    server.submit(db.Eq("a", E.encrypt(ks, 2, 4)))
    server.run()
    server.compact()
    assert obs.count_mallocs("compact", torch.device("cuda", 0)) is \
        obs.span("x")
    assert obs.stamp() == 0.0
    obs.mark_clock()
    _build.count_launch("eval_coeff0_gadget", 0.0, 0.0, lanes=4, rows=2)
    assert _build.LAUNCHES["eval_coeff0_gadget"] == 1
    assert (len(tr.spans), len(tr.launches), len(tr.clock_pairs)) == marks
    assert server.batch_log[-1].index_compares > 0
    assert D.row_bytes(ks) == 2 * 8 * ks.params.num_towers * ks.params.n
