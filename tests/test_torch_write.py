"""The port's write path (inserts, deletes, updates, union reads over
base ∪ delta, compaction) against the reference.

Cases follow `tests/test_db_mutations.py`.  Each runs the same writes
through a reference `repro.db.Table` and a bridged port `Table` on the
CPU: the port's inserts take the reference's own encryption samples and
its tables the reference's encryptions of 0 for re-padding, so every
ciphertext stays byte-equal and so must every answer and counter.  The
write path runs in paper mode (`paper_ecek_weight=0`, as the write
benchmark runs it) on test-bfv; the port's ε-band reads are held against
the reference in `test_torch_db.py`.
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
from repro.core.compare import next_pow2
from repro.core import ring as RR
from repro.core.keys import KeySet as RefKeySet
from repro.core.params import make_params as ref_make_params
from repro.db import plan as RP
from repro.db.executor import jitted_comparator
from repro.db import table as RT
from repro.db.shard import merge as RM
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import make_params as torch_make_params
from repro_torch.db import plan as TP
from repro_torch.db.executor import fae_comparator
from repro_torch.db.shard import merge as TM

from test_torch_core import ct_to_torch, n_, ref_encrypt_samples
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


STATS = ("eval_calls", "scan_compares", "index_compares", "scan_leaves",
         "indexed_leaves", "order_compares", "delta_build_compares")
BATCH_STATS = ("queries", "eval_calls", "scan_compares", "index_compares",
               "delta_build_compares")
COMPACTION = ("n_base", "n_delta", "shards", "merge_compares",
              "merge_rounds", "rebuild_compares", "indexes_merged",
              "merge_bound")
# one geometry for the cases below: a base of 12 rows (16 slots) and
# 5 inserted rows (a run of 8 slots), so the reference's jitted and
# eager programs compile once for the file, not once per case
N_BASE = 12


@functools.lru_cache(maxsize=None)
def _keys(profile):
    """(reference ks, port ks, jitted reference encrypt): paper-mode keys
    from the port's keygen on the CPU, the same key material handed to
    a reference KeySet (the reference's eager keygen costs 5-10 s)."""
    tks = torch_keygen(torch_make_params(profile, mode="paper"), 42,
                       device="cpu", paper_ecek_weight=0)
    rp = ref_make_params(profile, mode="paper")
    ref_ks = RefKeySet(params=rp, ring=RR.make_ring(rp),
                       **{k: jnp.asarray(n_(getattr(tks, k)))
                          for k in ("sk", "pk0", "pk1", "cek")},
                       cek_gadget=None, cek_gadget_ntt=None)
    return ref_ks, tks, jax.jit(lambda m, k: RE.encrypt(ref_ks, m, k))


def _zero_pads(ref_ks):
    """The reference's append-path encryptions of 0, bridged, as the
    port table's `zero_pad_rows`."""
    def pads(_ks, cname, count, salt):
        return ct_to_torch(RT._zero_pad_rows(ref_ks, cname, count, salt))
    return pads


def _samples(ref_ks, data, key):
    """The (u, e0, e1) the reference ingest draws per column of `data`
    (padded to a power of two) under `key`."""
    n_pad = next_pow2(len(next(iter(data.values()))))
    return {c: tuple(np.asarray(x) for x in ref_encrypt_samples(
        ref_ks.params, RT.column_key(key, c), (n_pad,))) for c in data}


class Pair:
    """One reference table and its bridged port twin, written together."""

    def __init__(self, profile, data, seed):
        self.ref_ks, self.ks, self._enc = _keys(profile)
        self.ref = RDB.Table.from_arrays(self.ref_ks, "t", data,
                                         jax.random.PRNGKey(seed))
        self.t = TDB.Table.from_ciphertexts(
            "t", {c: ct_to_torch(ct) for c, ct in self.ref.columns.items()},
            self.ref.n_rows, zero_pad_rows=_zero_pads(self.ref_ks))
        self._seed = 1000 * seed

    def enc(self, v):
        self._seed += 1
        ct = self._enc(jnp.asarray(v), jax.random.PRNGKey(self._seed))
        return ct, ct_to_torch(ct)

    def insert(self, data, seed):
        key = jax.random.PRNGKey(seed)
        want = self.ref.insert(self.ref_ks, data, key)
        got = self.t.insert(self.ks, data, 7,
                            samples=_samples(self.ref_ks, data, key))
        assert np.array_equal(got, want)
        return got

    def range(self, lo, hi):
        """The same Range over "v" in both IRs."""
        (r_lo, t_lo), (r_hi, t_hi) = self.enc(lo), self.enc(hi)
        return RP.Range("v", r_lo, r_hi), TP.Range("v", t_lo, t_hi)

    def indexes(self):
        return ({"v": RDB.SortedIndex.build(self.ref_ks, self.ref, "v")},
                {"v": TDB.SortedIndex.build(self.ks, self.t, "v")})


def _same_ct(got, want):
    assert np.array_equal(n_(got.c0), np.asarray(want.c0))
    assert np.array_equal(n_(got.c1), np.asarray(want.c1))


def _same_state(p: Pair):
    """Row-id space, masks, scan view and every ciphertext agree."""
    t, ref = p.t, p.ref
    for f in ("n_rows", "n_padded", "n_delta", "n_total", "has_delta",
              "is_mutated", "scan_width", "version", "ciphertext_bytes"):
        got, want = getattr(t, f), getattr(ref, f)
        if f == "ciphertext_bytes":
            got, want = got(), want()
        assert got == want, f
    for f in ("alive", "valid", "slot_global_ids", "slot_valid"):
        assert np.array_equal(getattr(t, f), getattr(ref, f)), f
    _same_ct(t.scan_column("v"), ref.scan_column("v"))
    rows = np.arange(t.n_total)[::-1]
    _same_ct(t.gather("v", rows), ref.gather("v", rows))
    assert np.array_equal(t.decrypt_column(p.ks, "v"),
                          np.asarray(ref.decrypt_column(p.ref_ks, "v")))


def _same_result(got, want):
    assert np.array_equal(got.row_ids, want.row_ids)
    assert np.array_equal(got.mask, want.mask)
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def _same_index(got, want):
    assert np.array_equal(got.perm, want.perm)
    _same_ct(got.sorted_ct, want.sorted_ct)
    assert got.build_compares == want.build_compares
    assert got.search_compares == want.search_compares


# ---------------------------------------------------------------------------
# table state: inserts, tombstones, updates, the scan view
# ---------------------------------------------------------------------------

def test_mutations_keep_table_state_equal():
    """Insert, grow the run (re-padded with encryptions of 0), delete,
    update: ids, masks, the union scan view and every ciphertext."""
    base = np.array([3, 8, 15, 22, 1, 9, 30, 4, 17, 11, 26, 6], np.int64)
    p = Pair("test-bfv", {"v": base}, 1)
    _same_state(p)
    p.insert({"v": np.array([5, 40, 2])}, 11)         # a new run of 4 slots
    _same_state(p)
    p.insert({"v": np.array([7, 7])}, 12)             # grows to 8 slots
    _same_state(p)
    gone = [0, N_BASE + 1]                            # one base, one delta
    assert p.t.delete(gone) == p.ref.delete(gone) == 2
    assert p.t.delete(gone[1:]) == p.ref.delete(gone[1:]) == 0  # idempotent
    _same_state(p)
    key = jax.random.PRNGKey(13)
    data = {"v": np.array([50])}
    want = p.ref.update(p.ref_ks, [1], data, key)
    got = p.t.update(p.ks, [1], data, 0,
                     samples=_samples(p.ref_ks, data, key))
    assert np.array_equal(got, want) and got.tolist() == [N_BASE + 5]
    _same_state(p)
    assert repr(p.t) == repr(p.ref)
    with pytest.raises(IndexError):
        p.t.delete([p.t.n_total])
    with pytest.raises(ValueError, match="columns"):
        p.t.insert(p.ks, {"w": np.array([1])})


def test_empty_table_grows_by_insert():
    """`Table.empty` is one pad slot; an insert into it starts the delta
    run, and a range over base ∪ delta finds exactly the new rows."""
    ref_ks, ks, _ = _keys("test-bfv")
    empty = TDB.Table.empty(ks, "e", ["v"], 3)
    assert (empty.n_rows, empty.n_padded, empty.n_total) == (0, 1, 0)
    assert not empty.valid.any()
    p = Pair("test-bfv", {"v": np.zeros(0, np.int64)}, 2)
    assert p.insert({"v": np.array([5, 9, 2])}, 21).tolist() == [0, 1, 2]
    _same_state(p)
    ref_q, q = p.range(3, 9)
    _same_result(TDB.execute(p.ks, p.t, q), RDB.execute(p.ref_ks, p.ref,
                                                        ref_q))


# ---------------------------------------------------------------------------
# union reads: fused scan over base ∪ delta, base + delta-run index probes
# ---------------------------------------------------------------------------

def test_union_reads_match_reference():
    """Scans and index probes over base ∪ delta with a tombstone and
    duplicate keys split across base and delta: row ids, masks,
    ExecStats (delta-run builds included) and the delta index."""
    base = np.array([4, 9, 12, 30, 18, 2, 26, 9, 14, 40, 21, 6])
    p = Pair("test-bfv", {"v": base}, 3)
    ref_idx, idx = p.indexes()
    p.insert({"v": np.array([9, 31, 9, 5, 17])}, 31)
    p.ref.delete([1])
    p.t.delete([1])
    ref_eq, eq_q = p.enc(9)
    plans = [(RP.Eq("v", ref_eq), TP.Eq("v", eq_q)), p.range(8, 20),
             p.range(0, 50)]
    for ref_q, q in plans:
        for ref_ix, ix in (({}, {}), (ref_idx, idx)):
            _same_result(TDB.execute(p.ks, p.t, q, indexes=ix),
                         RDB.execute(p.ref_ks, p.ref, ref_q,
                                     indexes=ref_ix))
    # the delta run's own index, built once per delta state
    _same_index(p.t.delta_index(p.ks, "v"), p.ref.delta_index(p.ref_ks, "v"))
    assert p.t.delta_index(p.ks, "v") is p.t.delta_index(p.ks, "v")
    # union-probe bound: 2 lanes x (log2 n_base + log2 n_delta), <= 2x
    got = TDB.execute(p.ks, p.t, plans[0][1], indexes=idx)
    n_b, n_d = next_pow2(p.t.n_rows), next_pow2(p.t.n_delta)
    assert got.stats.index_compares <= 2 * 2 * (
        (n_b - 1).bit_length() + (n_d - 1).bit_length())
    assert got.stats.delta_build_compares == 0          # cached


def test_query_server_fifo_mutations_match_reference():
    """Queries see exactly the writes submitted before them: results,
    MutationResults and BatchStats (delta builds included)."""
    p = Pair("test-bfv", {"v": np.array([10, 3, 7, 14, 1, 8, 20, 5, 16, 2,
                                      13, 9], np.int64)}, 4)
    ref_ix, ix = p.indexes()
    ref_srv = RDB.QueryServer(p.ref_ks, p.ref, indexes=ref_ix, batch=2)
    srv = TDB.QueryServer(p.ks, p.t, indexes=ix, batch=2)
    data, key = {"v": np.array([6, 12, 4])}, jax.random.PRNGKey(41)
    ops = [("q", p.range(5, 12)), ("ins", None), ("q", p.range(5, 12)),
           ("q", p.range(0, 9)), ("del", [0]), ("q", p.range(5, 12)),
           ("upd", [2])]
    ids, ref_ids = [], []
    for kind, q in ops:
        if kind == "q":
            ref_ids.append(ref_srv.submit(q[0]))
            ids.append(srv.submit(q[1]))
        elif kind == "ins":
            ref_ids.append(ref_srv.submit_insert(data, key))
            ids.append(srv.submit_insert(
                data, samples=_samples(p.ref_ks, data, key)))
        elif kind == "del":
            ref_ids.append(ref_srv.submit_delete(q))
            ids.append(srv.submit_delete(q))
        else:
            k2 = jax.random.PRNGKey(42)
            d2 = {"v": np.array([11])}
            ref_ids.append(ref_srv.submit_update(q, d2, k2))
            ids.append(srv.submit_update(q, d2,
                                         samples=_samples(p.ref_ks, d2, k2)))
    assert ids == ref_ids
    want, got = ref_srv.run(), srv.run()
    for qid, (kind, _) in zip(ids, ops):
        if kind == "q":
            _same_result(got[qid], want[qid])
        else:
            assert isinstance(got[qid], TDB.MutationResult)
            assert got[qid].kind == want[qid].kind
            assert np.array_equal(got[qid].row_ids, want[qid].row_ids)
            assert got[qid].deleted == want[qid].deleted
    assert len(srv.batch_log) == len(ref_srv.batch_log) == 3
    for g, w in zip(srv.batch_log, ref_srv.batch_log):
        for f in BATCH_STATS:
            assert getattr(g, f) == getattr(w, f), f
    assert sum(b.delta_build_compares for b in srv.batch_log) > 0
    _same_state(p)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def test_compaction_matches_reference():
    """Merge network, not a rebuild: CompactionStats, the merged index
    (perm and ciphertexts), the folded base (zero pads included),
    answers before and after, the obs counters, and a no-op second
    compaction."""
    rng = np.random.default_rng(5)
    base = rng.choice(np.arange(2, 200, 2), size=N_BASE, replace=False)
    p = Pair("test-bfv", {"v": base}, 5)
    ref_ix, ix = p.indexes()
    p.insert({"v": np.array([5, 101, 3, 177, 63])}, 51)
    p.ref.delete([2])
    p.t.delete([2])
    ref_q, q = p.range(50, 150)
    before = TDB.execute(p.ks, p.t, q, indexes=ix)
    _same_result(before, RDB.execute(p.ref_ks, p.ref, ref_q,
                                     indexes=ref_ix))
    with RO.tracing():
        want = RDB.compact(p.ref_ks, p.ref, ref_ix)
        ref_counts = {k: RO.REGISTRY.value(k) for k in
                      ("compact.runs", "compact.merge_compares",
                       "compact.indexes_merged", "eval.lanes")}
    with TO.tracing():
        got = TDB.compact(p.ks, p.t, ix)
        counts = {k: TO.REGISTRY.value(k) for k in ref_counts}
    for f in COMPACTION:
        assert getattr(got, f) == getattr(want, f), f
    assert counts == ref_counts
    assert 0 < got.merge_compares < got.rebuild_compares
    _same_index(ix["v"], ref_ix["v"])
    _same_state(p)
    _same_ct(p.t.columns["v"], p.ref.columns["v"])
    ref_q, q = p.range(50, 150)
    after = TDB.execute(p.ks, p.t, q, indexes=ix)
    _same_result(after, RDB.execute(p.ref_ks, p.ref, ref_q, indexes=ref_ix))
    assert np.array_equal(np.sort(after.row_ids), np.sort(before.row_ids))
    again = TDB.compact(p.ks, p.t, ix)
    assert again.merge_compares == 0 and again.n_delta == 0


def test_server_threshold_compaction_matches_reference():
    """`compact_threshold` fires after a mutation run: the compaction log
    and every answer around it agree."""
    p = Pair("test-bfv", {"v": np.arange(1, N_BASE + 1) * 3}, 6)
    ref_ix, ix = p.indexes()
    ref_srv = RDB.QueryServer(p.ref_ks, p.ref, indexes=ref_ix, batch=2,
                              compact_threshold=5)
    srv = TDB.QueryServer(p.ks, p.t, indexes=ix, batch=2,
                          compact_threshold=5)
    qids = []
    for step, vals in enumerate(([2, 11, 20], [3, 12])):
        data = {"v": np.array(vals)}
        key = jax.random.PRNGKey(60 + step)
        ref_srv.submit_insert(data, key)
        srv.submit_insert(data, samples=_samples(p.ref_ks, data, key))
        ref_q, q = p.range(1, 12)
        qids.append((ref_srv.submit(ref_q), srv.submit(q)))
    want, got = ref_srv.run(), srv.run()
    for rq, tq in qids:
        _same_result(got[tq], want[rq])
    assert len(srv.compaction_log) == len(ref_srv.compaction_log) == 1
    for f in COMPACTION:
        assert (getattr(srv.compaction_log[0], f)
                == getattr(ref_srv.compaction_log[0], f)), f
    assert not p.t.has_delta
    _same_index(ix["v"], ref_ix["v"])
    _same_state(p)


def test_merge_sorted_runs_matches_reference():
    """Ascending runs of 4, 4 and 3 rows padded into four blocks of 4
    (sentinels and an all-sentinel block, id -1) and merged in two
    rounds: the ids and the real rows' ciphertexts agree."""
    p = Pair("test-bfv", {"v": np.array([9, 1, 30, 4, 17, 22, 8, 12, 3, 25,
                                      14, 6], np.int64)}, 8)
    vals = p.t.decrypt_column(p.ks, "v")
    runs = [np.argsort(vals[i:i + 4]) + i for i in (0, 4, 8)]
    runs[2] = runs[2][:3]
    ref_ct, ref_ids = RM.pad_shard_blocks(
        p.ref_ks, [(p.ref.gather("v", r), r) for r in runs], block=4,
        pad_value=100, num_blocks=4)
    ct, ids = TM.pad_shard_blocks(
        p.ks, [(p.t.gather("v", r), r) for r in runs], block=4,
        pad_value=100, num_blocks=4)
    assert np.array_equal(ids, ref_ids)
    real = ids >= 0
    assert np.array_equal(n_(ct.c0)[real], np.asarray(ref_ct.c0)[real])
    r0, _, rid, rn = RM.merge_sorted_runs(
        p.ref_ks, jitted_comparator(p.ref_ks), ref_ct.c0, ref_ct.c1,
        jnp.asarray(ref_ids), run=4)
    c0, _, gid, cnt = TM.merge_sorted_runs(
        p.ks, fae_comparator(p.ks), ct.c0, ct.c1, torch.as_tensor(ids),
        run=4)
    assert cnt == rn == 2 * 4 * 3 + 8 * 4
    gid, rid = n_(gid), np.asarray(rid)
    assert np.array_equal(gid[gid >= 0], rid[rid >= 0])
    assert np.array_equal(vals[gid[gid >= 0]],
                          np.sort(vals[np.concatenate(runs)]))
    assert np.array_equal(n_(c0)[gid >= 0], np.asarray(r0)[rid >= 0])
    with pytest.raises(ValueError, match="runs"):
        TM.merge_sorted_runs(p.ks, fae_comparator(p.ks), ct.c0[:12],
                             ct.c1[:12], torch.as_tensor(ids[:12]), run=4)
