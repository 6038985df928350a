"""The port's query engine (`repro_torch.db`) against the reference.

Reference tables are encrypted once per scheme by `repro.db`, bridged
column by column into the port (`Table.from_ciphertexts`), and the same
plans (their trapdoors bridged too) run through both engines on the
CPU.  Row ids, masks and every engine counter must be equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as RO
from repro.core import encrypt as RE
from repro.db import executor as RX
from repro.db import plan as RP
from repro.db.index import SortedIndex as RefIndex
from repro.db.query_serve import QueryServer as RefServer
from repro.db.table import Table as RefTable
from repro_torch import obs as TO
from repro_torch.db import executor as TX
from repro_torch.db import plan as TP
from repro_torch.db import query_serve as TQS
from repro_torch.db.index import SortedIndex as TorchIndex
from repro_torch.db.query_serve import QueryServer as TorchServer
from repro_torch.db.table import Table as TorchTable
from repro_torch.db.table import column_seed, pad_rows_pow2, rows_to_mask

from conftest import get_scheme_ks
from tests.test_torch_core import ct_to_torch, ks_to_torch, n_

jax.config.update("jax_enable_x64", True)

N_ROWS = 20                      # pads to 32: pad slots are exercised

STATS = ("eval_calls", "scan_compares", "index_compares", "scan_leaves",
         "indexed_leaves", "order_compares")


@functools.lru_cache(maxsize=None)
def _fixture(profile):
    """(reference ks, port ks, reference table, port table, data, enc)
    with `enc(value)` -> (reference ct, bridged ct) of one operand."""
    ref_ks = get_scheme_ks(profile)
    rng = np.random.default_rng(3)
    if ref_ks.params.profile.scheme == "bfv":
        data = {"a": rng.integers(-50, 50, N_ROWS),
                "b": rng.integers(0, 8, N_ROWS)}
        data["a"][[4, 11, 17]] = data["a"][2]            # duplicates
    else:
        data = {"x": np.round(rng.uniform(-20, 20, N_ROWS) * 4) / 4,
                "y": np.round(rng.uniform(0, 5, N_ROWS) * 4) / 4}
        data["x"][[6, 13]] = data["x"][1] + 0.25          # inside ε=0.5
    ref_table = RefTable.from_arrays(ref_ks, "t", data,
                                     jax.random.PRNGKey(4))
    table = TorchTable.from_ciphertexts(
        "t", {c: ct_to_torch(ct) for c, ct in ref_table.columns.items()},
        N_ROWS)
    enc_j = jax.jit(lambda m, k: RE.encrypt(ref_ks, m, k))
    seeds = iter(range(100, 10_000))

    def enc(value):
        ct = enc_j(jnp.asarray(value, jnp.float64 if isinstance(value, float)
                               else jnp.int64),
                   jax.random.PRNGKey(next(seeds)))
        return ct, ct_to_torch(ct)
    return ref_ks, ks_to_torch(ref_ks), ref_table, table, data, enc


def _both(build):
    """Build one plan twice: with the reference's IR and trapdoors, and
    with the port's IR over the same trapdoors bridged.  `build(P, t)`
    gets the plan module and a trapdoor lookup `t(name)`."""
    def make(P, side):
        return build(P, lambda ct: ct[side])
    return make(RP, 0), make(TP, 1)


def _queries(profile, enc):
    """(name, reference plan, port plan) for the engine matrix."""
    if profile == "test-bfv":
        c = {k: enc(v) for k, v in
             dict(v5=5, lo=-10, hi=20, lo2=-30, hi2=30, b3=3, b0=0,
                  b10=10, lo3=-40, hi3=40).items()}
        specs = {
            "eq": lambda P, t: P.Eq("a", t(c["v5"])),
            "range": lambda P, t: P.Range("a", t(c["lo"]), t(c["hi"])),
            "and_not": lambda P, t: P.And(
                P.Range("a", t(c["lo2"]), t(c["hi2"])),
                P.Not(P.Eq("b", t(c["b3"])))),
            "or": lambda P, t: P.Or(P.Eq("a", t(c["v5"])),
                                    P.Range("b", t(c["b0"]), t(c["b10"]))),
            "order_limit": lambda P, t: P.Query(
                where=P.Range("a", t(c["lo3"]), t(c["hi3"])),
                order_by=P.OrderBy("a", descending=True), limit=P.Limit(4),
                select=("b",)),
            "topk": lambda P, t: P.Query(
                where=P.Range("b", t(c["b0"]), t(c["b10"])),
                top_k=P.TopK("a", 3)),
        }
    else:
        c = {k: enc(v) for k, v in
             dict(x=0.0, lo=-5.0, hi=7.5, y=2.0).items()}
        specs = {
            "eq_eps": lambda P, t: P.Eq("x", t(c["x"]), eps=0.5),
            "range_eps": lambda P, t: P.Range("x", t(c["lo"]), t(c["hi"]),
                                              eps=0.3),
            "mixed": lambda P, t: P.Or(
                P.Range("x", t(c["lo"]), t(c["hi"])),
                P.Eq("y", t(c["y"]), eps=1.0)),
            "topk": lambda P, t: P.Query(
                where=P.Not(P.Eq("x", t(c["x"]), eps=0.5)),
                top_k=P.TopK("y", 2)),
        }
    return [(name,) + _both(b) for name, b in specs.items()]


def _assert_same_result(got, want):
    assert np.array_equal(got.row_ids, want.row_ids)
    assert np.array_equal(got.mask, want.mask)
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert set(got.columns) == set(want.columns)
    for name, ct in got.columns.items():
        assert np.array_equal(n_(ct.c0), want.columns[name].c0)
        assert np.array_equal(n_(ct.c1), want.columns[name].c1)


# ---------------------------------------------------------------------------
# table
# ---------------------------------------------------------------------------

def test_table_geometry_and_helpers():
    ref_ks, tks, ref_table, table, data, _ = _fixture("test-bfv")
    assert table.n_padded == ref_table.n_padded == 32
    assert table.n_rows == ref_table.n_rows == N_ROWS
    assert table.n_total == ref_table.n_total
    assert table.scan_width == ref_table.scan_width
    assert np.array_equal(table.slot_global_ids, ref_table.slot_global_ids)
    assert np.array_equal(table.slot_valid, ref_table.slot_valid)
    assert table.ciphertext_bytes() == ref_table.ciphertext_bytes()
    rows = np.array([19, 0, 7, 7])
    got, want = table.gather("a", rows), ref_table.gather("a", rows)
    assert np.array_equal(n_(got.c0), want.c0)
    assert np.array_equal(n_(got.c1), want.c1)
    assert np.array_equal(table.decrypt_column(tks, "a"), data["a"])
    assert np.array_equal(
        table.decrypt_column(tks, "b", include_padding=True),
        ref_table.decrypt_column(ref_ks, "b", include_padding=True))
    from repro.db import table as RT
    for arr, target in ((np.arange(5), None), (np.arange(0), None),
                        (np.linspace(0, 1, 3), 8)):
        assert np.array_equal(pad_rows_pow2(arr, n_target=target),
                              RT.pad_rows_pow2(arr, n_target=target))
    assert np.array_equal(rows_to_mask([1, 3], 5), RT.rows_to_mask([1, 3], 5))
    assert column_seed(0, "a") != column_seed(0, "b")
    assert column_seed(1, "a") == column_seed(1, "a")


def test_from_arrays_encrypts_on_the_port(rng):
    """The port's own ingest: pad rows decrypt to 0, a fractional float
    column under bfv is refused, column streams follow the NAME."""
    _, tks, _, _, _, _ = _fixture("test-bfv")
    vals = {"a": rng.integers(-100, 100, 11), "b": np.arange(11)}
    t1 = TorchTable.from_arrays(tks, "x", vals, 9)
    t2 = TorchTable.from_arrays(tks, "x", dict(reversed(vals.items())), 9)
    assert t1.n_padded == 16
    for c in vals:
        assert np.array_equal(t1.decrypt_column(tks, c), vals[c])
        assert np.array_equal(n_(t1.columns[c].c1), n_(t2.columns[c].c1))
    assert not t1.decrypt_column(tks, "a", include_padding=True)[11:].any()
    with pytest.raises(ValueError, match="fractional"):
        TorchTable.from_arrays(tks, "x", {"a": np.array([0.5, 1.0])})


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_budget", [None, 16])
@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_execute_matches_reference(profile, lane_budget):
    ref_ks, tks, ref_table, table, data, enc = _fixture(profile)
    for name, ref_q, torch_q in _queries(profile, enc):
        want = RX.execute(ref_ks, ref_table, ref_q, lane_budget=lane_budget)
        got = TX.execute(tks, table, torch_q, lane_budget=lane_budget)
        _assert_same_result(got, want)
        assert len(got) == len(want), name


def test_fused_eval_raw_values_and_obs_match_reference():
    """One fused multi-atom scan in small tiles: the raw values, and the
    launch/lane/tile counters both engines record for it."""
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    (_, ref_q, torch_q), = [q for q in _queries("test-bfv", enc)
                            if q[0] == "and_not"]
    ref_plan, torch_plan = RP.compile_plan(ref_q), TP.compile_plan(torch_q)
    ref_atoms = [a for i in range(ref_plan.num_leaves)
                 for a in ref_plan.scan_atoms(i)]
    torch_atoms = [a for i in range(torch_plan.num_leaves)
                   for a in torch_plan.scan_atoms(i)]
    assert len(torch_atoms) == 3
    with RO.tracing():
        want = RX.fused_eval(ref_ks, ref_table, ref_atoms, lane_budget=24)
        ref_counts = {k: RO.REGISTRY.value(k) for k in
                      ("eval.launches", "eval.lanes", "eval.tiles",
                       "bytes.moved")}
    with TO.tracing() as tr:
        got = TX.fused_eval(tks, table, torch_atoms, lane_budget=24)
        counts = {k: TO.REGISTRY.value(k) for k in ref_counts}
    assert np.array_equal(got, want)
    assert counts == ref_counts
    assert counts["eval.tiles"] == 32 // 8          # 3 atoms: T = 8 rows
    names = [ev["name"] for ev in tr.chrome_trace()["traceEvents"]]
    assert names.count("executor.eval_tile") == 4
    assert "executor.fused_eval" in names


def test_paper_mode_dedup_eval_matches_reference(rng):
    """Paper mode's factored scan (column transform once per unique
    column, then gather + coefficient-0 subtract), on the CPU."""
    from repro.core.keys import keygen
    from repro.core.params import make_params
    ref_ks = keygen(make_params("test-bfv", mode="paper"),
                    jax.random.PRNGKey(42), paper_ecek_weight=0)
    tks = ks_to_torch(ref_ks)
    vals = {"a": rng.integers(-50, 50, 12), "b": rng.integers(-50, 50, 12)}
    ref_table = RefTable.from_arrays(ref_ks, "p", vals, jax.random.PRNGKey(1))
    table = TorchTable.from_ciphertexts(
        "p", {c: ct_to_torch(ct) for c, ct in ref_table.columns.items()}, 12)
    enc_j = jax.jit(lambda m, k: RE.encrypt(ref_ks, m, k))
    lo, hi = (enc_j(jnp.asarray(v), jax.random.PRNGKey(7 + i))
              for i, v in enumerate((-20, 20)))
    ref_q = RP.Or(RP.Range("a", lo, hi), RP.Eq("b", lo))
    torch_q = TP.Or(TP.Range("a", ct_to_torch(lo), ct_to_torch(hi)),
                    TP.Eq("b", ct_to_torch(lo)))
    for budget in (None, 8):
        _assert_same_result(
            TX.execute(tks, table, torch_q, lane_budget=budget),
            RX.execute(ref_ks, ref_table, ref_q, lane_budget=budget))


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _indexes(profile):
    ref_ks, tks, ref_table, table, _, _ = _fixture(profile)
    col = "a" if profile == "test-bfv" else "x"
    return (RefIndex.build(ref_ks, ref_table, col),
            TorchIndex.build(tks, table, col))


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_sorted_index_matches_reference(profile):
    ref_ks, tks, _, _, data, enc = _fixture(profile)
    ref_idx, idx = _indexes(profile)
    assert np.array_equal(idx.perm, ref_idx.perm)
    assert np.array_equal(n_(idx.sorted_ct.c0), ref_idx.sorted_ct.c0)
    assert np.array_equal(n_(idx.sorted_ct.c1), ref_idx.sorted_ct.c1)
    assert idx.build_compares == ref_idx.build_compares
    if profile == "test-bfv":
        probes = [data["a"][2], 0, -60, 60, data["a"][0]]
        eps = (None,)
    else:
        probes = [data["x"][1], 0.0, -30.0, 30.0]
        eps = (None, 0.5)
    cts = [enc(float(v) if profile == "test-ckks" else int(v))
           for v in probes]
    for e in eps:
        for (r_lo, t_lo), (r_hi, t_hi) in zip(cts, cts[1:]):
            r0, t0 = ref_idx.search_compares, idx.search_compares
            assert np.array_equal(
                idx.point_lookup(tks, t_lo, eps=e),
                ref_idx.point_lookup(ref_ks, r_lo, eps=e))
            assert np.array_equal(idx.last_probe_counts,
                                  ref_idx.last_probe_counts)
            assert np.array_equal(
                idx.mask_range(tks, t_lo, t_hi, 32, eps=e),
                ref_idx.mask_range(ref_ks, r_lo, r_hi, 32, eps=e))
            assert np.array_equal(
                idx.mask_eq(tks, t_hi, 32, eps=e),
                ref_idx.mask_eq(ref_ks, r_hi, 32, eps=e))
            assert (idx.search_compares - t0
                    == ref_idx.search_compares - r0)
    # the batched search over mixed strict/non-strict lanes
    from repro_torch.db.index import _stack_cts
    from repro.db.index import _stack_cts as ref_stack
    strict = np.array([False, True] * 2)
    got = idx.search(tks, _stack_cts([t for _, t in cts[:4]]), strict)
    want = ref_idx.search(ref_ks, ref_stack([r for r, _ in cts[:4]]), strict)
    assert np.array_equal(got, want)
    assert np.array_equal(idx.last_probe_counts, ref_idx.last_probe_counts)


def test_indexed_execute_matches_reference():
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    ref_idx, idx = _indexes("test-bfv")
    for name, ref_q, torch_q in _queries("test-bfv", enc):
        if name not in ("eq", "and_not", "or"):
            continue
        _assert_same_result(
            TX.execute(tks, table, torch_q, indexes={"a": idx}),
            RX.execute(ref_ks, ref_table, ref_q, indexes={"a": ref_idx}))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True])
def test_query_server_batch_matches_reference(indexed):
    """One batch of 4 queries (scan atoms fused, indexed leaves in one
    lane-batched search): results, BatchStats and tenant billing."""
    ref_ks, tks, ref_table, table, _, enc = _fixture("test-bfv")
    ref_idx, idx = _indexes("test-bfv")
    queries = [q for q in _queries("test-bfv", enc)
               if q[0] in ("eq", "range", "and_not", "order_limit")]
    ref_srv = RefServer(ref_ks, ref_table, batch=4,
                        indexes={"a": ref_idx} if indexed else None)
    srv = TorchServer(tks, table, batch=4,
                      indexes={"a": idx} if indexed else None)
    with RO.tracing():
        ref_ids = [ref_srv.submit(q, tenant=f"t{i % 2}")
                   for i, (_, q, _) in enumerate(queries)]
        want = ref_srv.run()
        ref_bill = {t: (RO.REGISTRY.value("server.queries", tenant=t),
                        RO.REGISTRY.value("server.compares", tenant=t))
                    for t in ("t0", "t1")}
    with TO.tracing():
        ids = [srv.submit(q, tenant=f"t{i % 2}")
               for i, (_, _, q) in enumerate(queries)]
        got = srv.run()
        bill = {t: (TO.REGISTRY.value("server.queries", tenant=t),
                    TO.REGISTRY.value("server.compares", tenant=t))
                for t in ("t0", "t1")}
    assert ids == ref_ids and len(srv.batch_log) == 1
    for qid in ids:
        _assert_same_result(got[qid], want[qid])
    g, w = srv.batch_log[0], ref_srv.batch_log[0]
    for f in ("queries", "eval_calls", "scan_compares", "index_compares"):
        assert getattr(g, f) == getattr(w, f), f
    assert bill == ref_bill
    # queue controls
    srv.submit(queries[0][2])
    with srv.batch_size(1):
        assert srv.batch == 1
    assert srv.batch == 4 and srv.clear_queue() == 1 and srv.run() == {}


def test_query_serve_cli_on_cpu():
    out = TQS.main(["--device", "cpu", "--rows", "48", "--requests", "4",
                    "--batch", "2", "--lane-budget", "64"])
    assert out["correct"] == "4/4"
    assert out["device"] == "cpu" and out["fused_eval_calls"] == 2
    assert out["scan_compares"] == 4 * 2 * 64
