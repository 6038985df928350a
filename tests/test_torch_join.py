"""The port's joins (`repro_torch.db.join`, `QueryServer.submit_join`)
against the reference.

Reference tables are encrypted by `repro.db` and bridged column by
column into the port (`Table.from_ciphertexts`, the reference's
encryptions of 0 as the re-padding rows), trapdoors too, and the same
joins run through both engines on the CPU.  Pairs, masks, projected
ciphertexts and every `JoinStats` counter must be equal.  The cases
follow `tests/test_db_join.py` on one table geometry (21 x 13 rows, 32 x
16 slots), so the reference's jitted programs compile once per file.
The sharded joins are in `test_torch_shard.py`.
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
from repro.core import ring as RR
from repro.core.keys import KeySet as RefKeySet
from repro.core.params import make_params as ref_make_params
from repro.db import join as RJ
from repro.db import plan as RP
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.core import ring as TR
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import make_params as torch_make_params
from repro_torch.db import join as TJ
from repro_torch.db import plan as TP
from repro_torch.kernels import cmp_eval as TCK
from repro_torch.kernels import ops as TKO

from test_torch_core import ct_to_torch, n_
from test_torch_write import (_keys as paper_keys, _samples,
                                    _zero_pads)
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


GRID = 0.25          # ckks float grid (>> test-ckks equality tolerance)
EPS_BAND = 0.3       # captures exactly the ±1-grid-step neighbours
N_LEFT, N_RIGHT = 21, 13
JOIN_STATS = ("strategy", "eval_calls", "pair_compares", "build_compares",
              "merge_compares", "adjacency_compares", "verify_compares",
              "shards", "join_compares")
EXEC_STATS = ("eval_calls", "scan_compares", "index_compares", "scan_leaves",
              "indexed_leaves", "order_compares")


@functools.lru_cache(maxsize=None)
def gadget_keys(profile):
    """(reference ks, port ks): gadget-mode keys from the port's keygen on
    the CPU, the same key material handed to a reference KeySet (the
    reference's eager keygen costs 10-20 s)."""
    tks = torch_keygen(torch_make_params(profile, mode="gadget"), 42,
                       device="cpu")
    rp = ref_make_params(profile, mode="gadget")
    ref_ks = RefKeySet(params=rp, ring=RR.make_ring(rp),
                       **{k: jnp.asarray(n_(getattr(tks, k)))
                          for k in ("sk", "pk0", "pk1", "cek_gadget",
                                    "cek_gadget_ntt")}, cek=None)
    return ref_ks, tks


class Side:
    """One reference table and its bridged port twin."""

    def __init__(self, ref_ks, name, data, seed):
        self.ref = RDB.Table.from_arrays(ref_ks, name, data,
                                         jax.random.PRNGKey(seed))
        self.t = TDB.Table.from_ciphertexts(
            name, {c: ct_to_torch(ct) for c, ct in self.ref.columns.items()},
            self.ref.n_rows, zero_pad_rows=_zero_pads(ref_ks))


class Scheme:
    """Keys (reference + port, one key material) and a trapdoor
    encryptor for one profile and mode."""

    def __init__(self, profile, mode="gadget"):
        if mode == "gadget":
            self.ref_ks, self.ks = gadget_keys(profile)
        else:
            self.ref_ks, self.ks, _ = paper_keys(profile)
        self.ckks = self.ref_ks.params.profile.scheme == "ckks"
        self._seed = 500

    def vals(self, ints):
        ints = np.asarray(ints)
        return ints * GRID if self.ckks else ints.astype(np.int64)

    def enc(self, v):
        self._seed += 1
        m = jnp.asarray(float(v) if self.ckks else int(v))
        ct = RE.encrypt(self.ref_ks, m, jax.random.PRNGKey(self._seed))
        return ct, ct_to_torch(ct)

    def bound(self, v, side):
        return float(v) + side * GRID / 2 if self.ckks else int(v)

    def tables(self, rng, key_hi=9):
        """Left (k, v) and right (k, w) tables with duplicate-heavy keys."""
        lk = self.vals(rng.integers(0, key_hi, N_LEFT))
        rk = self.vals(rng.integers(0, key_hi, N_RIGHT))
        lv = self.vals(rng.integers(0, 200, N_LEFT))
        rw = self.vals(rng.integers(0, 200, N_RIGHT))
        left = Side(self.ref_ks, "L", {"k": lk, "v": lv}, 1)
        right = Side(self.ref_ks, "R", {"k": rk, "w": rw}, 2)
        return left, right, lk, rk, lv, rw

    def indexes(self, side, col="k"):
        return ({col: RDB.SortedIndex.build(self.ref_ks, side.ref, col)},
                {col: TDB.SortedIndex.build(self.ks, side.t, col)})


def _want_pairs(lk, rk, lmask=None, rmask=None, eps=None):
    grid = (lk[:, None] == rk[None, :] if eps is None
            else np.abs(lk[:, None] - rk[None, :]) <= eps)
    if lmask is not None:
        grid &= np.asarray(lmask)[:, None]
    if rmask is not None:
        grid &= np.asarray(rmask)[None, :]
    return np.argwhere(grid)


def _same_ct(got, want):
    assert np.array_equal(n_(got.c0), np.asarray(want.c0))
    assert np.array_equal(n_(got.c1), np.asarray(want.c1))


def _same_join(got, want):
    assert np.array_equal(got.pairs, want.pairs)
    assert np.array_equal(got.left_mask, want.left_mask)
    assert np.array_equal(got.right_mask, want.right_mask)
    for f in JOIN_STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    for side in ("left", "right"):
        for f in EXEC_STATS:
            assert (getattr(getattr(got.stats, side), f)
                    == getattr(getattr(want.stats, side), f)), (side, f)
    assert set(got.columns) == set(want.columns)
    for name, ct in got.columns.items():
        _same_ct(ct, want.columns[name])


# ---------------------------------------------------------------------------
# the ring's default device (the repair of this slice)
# ---------------------------------------------------------------------------

def test_make_ring_defaults_to_cuda():
    """A public entry point runs on the card unless asked for the CPU:
    `make_ring` without a device resolves to CUDA, and raises without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_ring(params) builds there")
    tp = torch_make_params("test-bfv")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.make_ring(tp)
    assert TR.make_ring(tp, "cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the raw pair grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_pairs", [None, 64])
@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_pair_eval_values_match_reference(mode, block_pairs, rng):
    """The raw [L, R] grid (pad rows included) in tiles of T left rows,
    the launch counters and the grid's JoinStats share."""
    sc = Scheme("test-bfv", mode)
    left, right, *_ = sc.tables(rng)
    lct, rct = left.ref.column("k"), right.ref.column("k")
    want_stats, got_stats = RJ.JoinStats(), TJ.JoinStats()
    with RO.tracing():
        want = RJ.pair_eval_values(sc.ref_ks, lct, rct,
                                   block_pairs=block_pairs, stats=want_stats)
        ref_counts = {k: RO.REGISTRY.value(k) for k in
                      ("eval.launches", "eval.tiles", "eval.lanes")}
    with TO.tracing():
        got = TJ.pair_eval_values(sc.ks, left.t.column("k"),
                                  right.t.column("k"),
                                  block_pairs=block_pairs, stats=got_stats)
        counts = {k: TO.REGISTRY.value(k) for k in ref_counts}
    assert got.shape == (32, 16)
    assert np.array_equal(got, want)
    assert counts == ref_counts
    assert counts["eval.tiles"] == (1 if block_pairs is None else 8)
    for f in JOIN_STATS:
        assert getattr(got_stats, f) == getattr(want_stats, f), f


def test_pair_grid_layout_is_not_antisymmetric(rng):
    """The gadget tile evaluates l - r through (-r) - (-l): the values
    equal the reference's eval(l, r), and differ from -eval(r, l)
    (each digit's key row carries its own noise)."""
    sc = Scheme("test-bfv")
    left, right, *_ = sc.tables(rng)
    lct, rct = left.t.column("k"), right.t.column("k")
    lr = TKO.PairGrid(sc.ks, lct, rct).tile(0, 32).numpy()
    rl = TKO.PairGrid(sc.ks, rct, lct).tile(0, 16).numpy()
    assert np.array_equal(lr, RJ.pair_eval_values(
        sc.ref_ks, left.ref.column("k"), right.ref.column("k")))
    assert not np.array_equal(lr, -rl.T)


# ---------------------------------------------------------------------------
# execute_join: nested-loop and sort-merge
# ---------------------------------------------------------------------------

def test_execute_join_matches_reference(rng):
    """Duplicate keys on both sides, for both strategies (sort-merge from
    indexes and with on-the-fly builds): plain; a left Range filter with
    projections of both sides; an empty result (a right filter nothing
    passes).  Pairs, masks, projections and JoinStats equal, and equal
    the plaintext.  (CKKS keys: `test_eps_band_join_matches_reference`.)"""
    sc = Scheme("test-bfv")
    left, right, lk, rk, lv, rw = sc.tables(rng)
    ref_li, li = sc.indexes(left)
    ref_ri, ri = sc.indexes(right)
    lo, hi = sc.bound(sc.vals(40), -1), sc.bound(sc.vals(160), +1)
    (r_lo, t_lo), (r_hi, t_hi) = sc.enc(lo), sc.enc(hi)
    r_miss, t_miss = sc.enc(sc.vals(999))
    joins = {
        "plain": (RP.Join(None, None, on="k"), TP.Join(None, None, on="k"),
                  _want_pairs(lk, rk)),
        "filtered": (
            RP.Join(RP.Query(where=RP.Range("v", r_lo, r_hi),
                             select=("v",)), RP.Query(select=("w",)), on="k"),
            TP.Join(TP.Query(where=TP.Range("v", t_lo, t_hi),
                             select=("v",)), TP.Query(select=("w",)), on="k"),
            _want_pairs(lk, rk, lmask=(lv >= lo) & (lv <= hi))),
        "empty": (RP.Join(None, RP.Eq("w", r_miss), on="k"),
                  TP.Join(None, TP.Eq("w", t_miss), on="k"),
                  np.zeros((0, 2), np.int64)),
    }
    runs = [("nested", {}, {}, {}, {}), ("auto", ref_li, li, ref_ri, ri)]
    for name, (ref_j, j, want) in joins.items():
        on_the_fly = [("sort_merge", {}, {}, {}, {})] if name == "plain" \
            else []
        for strategy, rl, tl, rr, tr in runs + on_the_fly:
            w = RDB.execute_join(sc.ref_ks, left.ref, right.ref, ref_j,
                                 strategy=strategy, left_indexes=rl,
                                 right_indexes=rr)
            g = TDB.execute_join(sc.ks, left.t, right.t, j,
                                 strategy=strategy, left_indexes=tl,
                                 right_indexes=tr)
            _same_join(g, w)
            assert np.array_equal(g.pairs, want), (name, strategy)
        if name == "empty":
            assert g.stats.build_compares == 0    # runs reused from indexes


def test_eps_band_join_matches_reference():
    """CKKS keys on a chained grid (each key within ε of its neighbour,
    not of its second neighbour): the sort-merge verification Eval keeps
    the band non-transitive; both strategies, and the native-tolerance
    join (exact key matches only)."""
    sc = Scheme("test-ckks")
    lk = sc.vals([0, 1, 2, 4, 8, 9, 12, 2])
    rk = sc.vals([1, 2, 3, 8, 30])
    left = Side(sc.ref_ks, "L", {"k": lk}, 7)
    right = Side(sc.ref_ks, "R", {"k": rk}, 8)
    ref_li, li = sc.indexes(left)
    ref_ri, ri = sc.indexes(right)
    band = (RP.Join(None, None, on="k", eps=EPS_BAND),
            TP.Join(None, None, on="k", eps=EPS_BAND))
    native = (RP.Join(None, None, on="k"), TP.Join(None, None, on="k"))
    for (ref_j, j), strategy in ((band, "nested"), (band, "sort_merge"),
                                 (native, "nested")):
        w = RDB.execute_join(sc.ref_ks, left.ref, right.ref, ref_j,
                             strategy=strategy, left_indexes=ref_li,
                             right_indexes=ref_ri)
        g = TDB.execute_join(sc.ks, left.t, right.t, j, strategy=strategy,
                             left_indexes=li, right_indexes=ri)
        _same_join(g, w)
        assert np.array_equal(g.pairs, _want_pairs(lk, rk, eps=(
            EPS_BAND if j.eps is not None else None)))
        if strategy == "sort_merge":
            assert g.stats.verify_compares > 0


def test_join_refuses_pending_delta_allows_tombstones():
    """A side with a pending delta run is refused (joins address base
    slots); tombstoned rows only drop out of the side mask."""
    sc = Scheme("test-bfv")
    left = Side(sc.ref_ks, "L", {"k": np.array([1, 2, 3, 2])}, 24)
    right = Side(sc.ref_ks, "R", {"k": np.array([2, 3, 4, 2])}, 25)
    join = TP.Join(None, None, on="k")
    left.t.delete([1])
    res = TDB.execute_join(sc.ks, left.t, right.t, join)
    assert res.pairs.tolist() == [[2, 1], [3, 0], [3, 3]]
    data, key = {"k": np.array([5])}, jax.random.PRNGKey(26)
    left.t.insert(sc.ks, data, samples=_samples(sc.ref_ks, data, key))
    for strategy in ("nested", "sort_merge"):
        with pytest.raises(ValueError, match="compact"):
            TDB.execute_join(sc.ks, left.t, right.t, join, strategy=strategy)
    with pytest.raises(ValueError, match="strategy"):
        TJ.resolve_strategy("hash", True, True)


# ---------------------------------------------------------------------------
# the QueryServer: shared launches, deduped grids, the run cache
# ---------------------------------------------------------------------------

def test_query_server_joins_match_reference(rng):
    """One batch of a query and three joins against one right table: the
    join's left leaves ride the shared scan and the three nested joins
    share ONE grid.  Then sort-merge joins without indexes: the run
    cache hits on the next batch, an insert into the right table (and its
    compaction) invalidates it.  Results, BatchStats and billing equal."""
    sc = Scheme("test-bfv")
    left, right, lk, rk, lv, rw = sc.tables(rng)
    lo, hi = 20, 90
    (r_lo, t_lo), (r_hi, t_hi) = sc.enc(lo), sc.enc(hi)
    (r_lo2, t_lo2), (r_hi2, t_hi2) = sc.enc(lo), sc.enc(hi)
    r_w, t_w = sc.enc(rw[2])
    ref_srv = RDB.QueryServer(sc.ref_ks, left.ref, batch=4)
    srv = TDB.QueryServer(sc.ks, left.t, batch=4)
    with RO.tracing():
        ref_ids = [
            ref_srv.submit(RP.Range("v", r_lo, r_hi), tenant="a"),
            ref_srv.submit_join(RP.Join(None, None, on="k"), right.ref),
            ref_srv.submit_join(RP.Join(RP.Range("v", r_lo2, r_hi2), None,
                                        on="k"), right.ref, tenant="b"),
            ref_srv.submit_join(RP.Join(None, RP.Eq("w", r_w), on="k"),
                                right.ref)]
        want = ref_srv.run()
        ref_bill = [(RO.REGISTRY.value("server.queries", tenant=t),
                     RO.REGISTRY.value("server.compares", tenant=t))
                    for t in ("a", "b", "default")]
    with TO.tracing():
        ids = [srv.submit(TP.Range("v", t_lo, t_hi), tenant="a"),
               srv.submit_join(TP.Join(None, None, on="k"), right.t),
               srv.submit_join(TP.Join(TP.Range("v", t_lo2, t_hi2), None,
                                       on="k"), right.t, tenant="b"),
               srv.submit_join(TP.Join(None, TP.Eq("w", t_w), on="k"),
                               right.t)]
        got = srv.run()
        bill = [(TO.REGISTRY.value("server.queries", tenant=t),
                 TO.REGISTRY.value("server.compares", tenant=t))
                for t in ("a", "b", "default")]
    assert ids == ref_ids and bill == ref_bill
    assert np.array_equal(got[ids[0]].mask, want[ref_ids[0]].mask)
    for qid in ids[1:]:
        _same_join(got[qid], want[qid])
    lmask = (lv >= lo) & (lv <= hi)
    assert np.array_equal(got[ids[2]].pairs, _want_pairs(lk, rk, lmask))
    b, rb = srv.batch_log[0], ref_srv.batch_log[0]
    for f in ("queries", "joins", "eval_calls", "scan_compares",
              "index_compares", "grid_evals", "pair_compares"):
        assert getattr(b, f) == getattr(rb, f), f
    assert (b.queries, b.joins, b.grid_evals, b.eval_calls) == (1, 3, 1, 1)

    # sort-merge without indexes: runs built on the fly, then cached
    def sort_merge_batch():
        rid = ref_srv.submit_join(RP.Join(None, None, on="k"), right.ref,
                                  strategy="sort_merge")
        tid = srv.submit_join(TP.Join(None, None, on="k"), right.t,
                              strategy="sort_merge")
        w, g = ref_srv.run()[rid], srv.run()[tid]
        _same_join(g, w)
        return g
    first = sort_merge_batch()
    assert first.stats.build_compares > 0 and len(srv._run_cache) == 2
    assert sort_merge_batch().stats.build_compares == 0       # cache hits
    data, key = {"k": sc.vals([3]), "w": sc.vals([7])}, jax.random.PRNGKey(9)
    right.ref.insert(sc.ref_ks, data, key)
    right.t.insert(sc.ks, data, samples=_samples(sc.ref_ks, data, key))
    RDB.compact(sc.ref_ks, right.ref)
    TDB.compact(sc.ks, right.t)
    again = sort_merge_batch()               # the right run is rebuilt
    assert 0 < again.stats.build_compares < first.stats.build_compares
    assert np.array_equal(again.pairs, _want_pairs(
        lk, np.concatenate([rk, data["k"]])))


# ---------------------------------------------------------------------------
# on the card: the pair-grid layouts against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The CUDA device, or a skip: the kernels build and run on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_cuda_pair_grid_equals_plain(cuda, mode, rng):
    """A [T, R] tile through the kernels (gadget: the negated right column
    against negated left atoms, one launch; paper: the column form of
    both sides, one launch each) equals the same tile on the CPU's plain
    versions, exactly."""
    from repro_torch.core.encrypt import Ciphertext
    from repro_torch.kernels import _build
    sc = Scheme("test-bfv", mode)
    left, right, *_ = sc.tables(rng)
    ks_gpu = type(sc.ks).from_numpy(
        sc.ks.params, sk=n_(sc.ks.sk), pk0=n_(sc.ks.pk0),
        pk1=n_(sc.ks.pk1),
        cek=None if sc.ks.cek is None else n_(sc.ks.cek),
        cek_gadget=(None if sc.ks.cek_gadget is None
                    else n_(sc.ks.cek_gadget)), device=cuda)

    def on(ct, dev):
        return Ciphertext(ct.c0.to(dev), ct.c1.to(dev))
    lct, rct = left.t.column("k"), right.t.column("k")
    want = TKO.PairGrid(sc.ks, lct, rct).tile(4, 8)
    kernel = f"eval_coeff0_{mode}"
    before = _build.LAUNCHES[kernel]
    grid = TKO.PairGrid(ks_gpu, on(lct, cuda), on(rct, cuda))
    got = grid.tile(4, 8)
    assert _build.LAUNCHES[kernel] == before + (1 if mode == "gadget" else 2)
    assert torch.equal(got.cpu(), want)
    if mode == "paper":
        assert torch.equal(grid.f_right.cpu(), TCK.eval_coeff0_paper_plain(
            rct.c0, rct.c1, sc.ks.cek_rev, sc.ks.ring.q_arr[:, 0],
            sc.ks.params.scale))
