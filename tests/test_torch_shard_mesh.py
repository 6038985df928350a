"""A sharded table placed on a shard mesh, against the reference.

The port places a `[S, ...]` stack as per-position slabs
(`parallel.sharding.ShardStack`) on a one-process mesh of devices
(`launch.mesh.make_shard_mesh`); a device may fill several positions,
so the CPU runs the placed path on `[cpu] * 2` and `[cpu] * 4`.  On
bridged ciphertexts (the reference's rows and pads) its fused-scan raw
values, masks, row ids, TopK order, the [S, S] join grid in gadget and
paper mode, and a scan after inserts and compaction equal the
reference's byte for byte, with the obs counters and
`ShardedExecStats`; placed equals unplaced, ciphertexts included.  A
subprocess runs the reference's own `shard_map` path on four forced
host devices (the flag must be set before JAX starts; the installed
JAX's `shard_map` takes the reference's `check_rep` under its newer name
`check_vma`) and holds the port on `[cpu] * 4` to it: mesh sizes, a scan
tile and the pair grid with its counts.

    python tests/test_torch_shard_mesh.py OUT.json

is that subprocess (it writes its readings to OUT.json).
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import db as RDB
from repro import obs as RO
from repro.db import plan as RP
from repro.db.shard import executor as RSX
from repro.db.shard import join as RSJ
from repro.db.shard import spec as RSS
from repro.launch import mesh as RM
from repro.parallel import sharding as RSH
from repro_torch import db as TDB
from repro_torch import obs as TO
from repro_torch.core.encrypt import Ciphertext
from repro_torch.db import executor as TX
from repro_torch.db import join as TJ
from repro_torch.db import plan as TP
from repro_torch.db.shard import executor as TSX
from repro_torch.db.shard import join as TSJ
from repro_torch.kernels import ops as TKO
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.parallel.sharding import (ShardStack, leading_sharding,
                                           shard_leading)

from test_torch_core import n_
from test_torch_join import EXEC_STATS, Scheme, Side, _same_ct
from test_torch_shard import (N_ROWS, STATS, _fixture, _insert, _queries,
                              _ref_zeros, _same_state)
from test_torch_shard import _shared as _shared_ref
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
S = 4                                   # logical shards of every table
POSITIONS = (2, 4)                      # mesh positions, all on the CPU
MESH_SHARDS = (1, 2, 3, 4, 6)
PAD_SEED = 0x5AAD                       # the reference's partition pads
SCAN_COUNTERS = ("eval.launches", "eval.tiles", "eval.lanes", "bytes.moved")


def _spec(d):
    return TDB.ShardSpec.create(S, devices=[CPU] * d)


def _placed(sc, side, d):
    """The port's S-shard table over `side`, placed on d CPU positions,
    padded with the reference's encryptions of 0."""
    return TDB.ShardedTable.from_table(sc.ks, side.t, spec=_spec(d),
                                       pad_rows=_ref_zeros(sc.ref_ks,
                                                           PAD_SEED))


def _range_atoms(sc):
    """The scan atoms (two) of one Range over v: (reference's, port's)."""
    lo, hi = sc.enc(8), sc.enc(30)
    return (list(RP.compile_plan(RP.Range("v", lo[0], hi[0])).scan_atoms(0)),
            list(TP.compile_plan(TP.Range("v", lo[1], hi[1])).scan_atoms(0)))


def _same_placed_result(got, want, d):
    """Equal answers and stats; `mesh_devices` is the port's d (the
    reference runs in this process on its one CPU device)."""
    assert np.array_equal(got.row_ids, want.row_ids)
    assert np.array_equal(got.mask, want.mask)
    for f in STATS:
        if f != "mesh_devices":
            assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.mesh_devices == d and want.stats.mesh_devices == 1
    assert set(got.columns) == set(want.columns)
    for name, ct in got.columns.items():
        _same_ct(ct, want.columns[name])


# ---------------------------------------------------------------------------
# the mesh, the spec, the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positions", range(1, 9))
def test_make_shard_mesh_matches_reference(positions, monkeypatch):
    """d is the largest divisor of S within the positions, as the
    reference picks it over `jax.devices()`; the spec's geometry
    (`mesh_devices`, `placeable`, `shard_map_ok`) follows."""
    cpu = jax.devices()[0]
    monkeypatch.setattr(RM.jax, "devices", lambda: [cpu] * positions)
    monkeypatch.setattr(RM, "_mesh", lambda shape, axes, devices=None:
                        type("Mesh", (), {"shape": dict(zip(axes, shape))}))
    devices = [CPU] * positions
    for shards in MESH_SHARDS:
        ref = RSS.ShardSpec(shards, mesh=RM.make_shard_mesh(shards))
        mesh = make_shard_mesh(shards, devices=devices)
        spec = TDB.ShardSpec.create(shards, devices=devices)
        assert mesh.shape == {"shard": ref.mesh_devices}, shards
        assert mesh.devices == tuple(devices[:ref.mesh_devices])
        assert mesh.home == CPU and mesh.distinct == (CPU,)
        for f in ("mesh_devices", "placeable", "shard_map_ok"):
            assert getattr(spec, f) == getattr(ref, f), (shards, f)
        assert repr(spec) == repr(ref)
    with pytest.raises(ValueError):
        make_shard_mesh(0, devices=devices)


def test_place_is_a_noop_without_usable_mesh():
    """No mesh, or a mesh of one position, leaves the tree as it is (the
    same objects), as the reference's `place` does; on this CPU host the
    default mesh has one position, the reference's one CPU device."""
    tree = {"c": Ciphertext(torch.arange(8).reshape(4, 2),
                            torch.arange(8).reshape(4, 2)), "n": 3}
    for spec in (TDB.ShardSpec.create(S, use_mesh=False),
                 TDB.ShardSpec.create(S),
                 TDB.ShardSpec.create(3, devices=[CPU] * 2)):
        assert spec.place(tree) is tree
        assert spec.mesh_devices == 1 and not spec.shard_map_ok
    assert TDB.ShardSpec.create(S, use_mesh=False).mesh is None
    assert not TDB.ShardSpec.create(S, use_mesh=False).placeable
    ref = RDB.ShardSpec.create(S)
    assert ref.place(tree) is tree and ref.mesh_devices == 1
    assert TDB.ShardSpec.create(S).placeable == ref.placeable
    placed = _spec(4).place(tree)
    assert placed["n"] == 3 and isinstance(placed["c"].c0, ShardStack)
    assert placed["c"].c0.num_slabs == 4
    # a table on a meshless or one-position spec holds one slab: the
    # stack it was built with
    sc, side, _ = _fixture("test-bfv")
    st = TDB.ShardedTable.from_table(sc.ks, side.t,
                                     spec=TDB.ShardSpec.create(S))
    assert all(ct.c0.num_slabs == 1 for ct in st.columns.values())


def test_shard_spec_keeps_the_home_device():
    """Position 0 is the home device: an explicit mesh starting on
    another device than the table's raises (nothing moves a table
    unasked); a mesh of the visible devices that does not start there
    leaves the table where it is, meshless."""
    meta = [torch.device("meta")] * 2
    sc, side, _ = _fixture("test-bfv")
    with pytest.raises(ValueError, match="home"):
        TDB.ShardedTable.from_table(sc.ks, side.t,
                                    spec=TDB.ShardSpec.create(
                                        S, devices=meta))
    visible = TDB.ShardSpec(S, mesh=ShardMesh(tuple(meta)), visible=True)
    st = TDB.ShardedTable.from_table(sc.ks, side.t, spec=visible)
    assert st.spec.mesh is None and st.spec.mesh_devices == 1
    assert st.home == CPU


def test_shard_leading_splits_the_leading_dim():
    """`leading_sharding` is the reference's split (its PartitionSpec,
    rows per position); `shard_leading` gives each tensor leaf its slabs,
    views of the leaf when every position is its device; the stack's
    reads equal the tensor's."""
    mesh = make_shard_mesh(S, devices=[CPU] * 2)
    ref_mesh = RM._mesh((1,), ("shard",))
    for ndim in (1, 3, 4):
        assert (tuple(leading_sharding(mesh, ndim).spec)
                == tuple(RSH.leading_sharding(ref_mesh, ndim).spec))
    assert [r for _, r in leading_sharding(mesh, 4).slices(S)] == [
        slice(0, 2), slice(2, 4)]
    x = torch.arange(S * 5 * 3).reshape(S, 5, 3)
    tree = shard_leading(mesh, {"a": Ciphertext(x, x + 1), "k": "v"})
    st = tree["a"].c0
    assert tree["k"] == "v" and st.num_slabs == 2 and st.per_slab == 2
    assert tuple(st.shape) == (S, 5, 3) and st.nbytes == x.nbytes
    assert all(s.data_ptr() == x[2 * j].data_ptr()
               for j, s in enumerate(st.slabs))
    assert torch.equal(st.full(), x) and np.array_equal(np.asarray(st), n_(x))
    assert st.locate(3) == (1, 1) and torch.equal(st.shard(3), x[3])
    shards, slots = np.array([3, 0, 1, 3, 2]), np.array([4, 0, 2, 1, 3])
    assert torch.equal(st.rows(shards, slots), x[shards, slots])
    assert torch.equal(st.rows([2, 3], [1, 0]), x[[2, 3], [1, 0]])
    again = shard_leading(mesh, tree)
    assert again["a"].c0 is st                   # already placed so
    with pytest.raises(ValueError):
        leading_sharding(make_shard_mesh(3, devices=[CPU] * 3),
                         2).slices(4)


# ---------------------------------------------------------------------------
# placed against unplaced, in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", POSITIONS)
def test_placed_table_equals_unplaced(d):
    """For the same seeds a placed table's ciphertexts equal the
    unplaced table's (`from_arrays` and `from_table`), and every reader
    answers the same on the home device."""
    sc, side, data = _fixture("test-bfv")
    own = TDB.ShardedTable.from_arrays(sc.ks, "own", data, 5, spec=_spec(d))
    flat = TDB.ShardedTable.from_arrays(
        sc.ks, "own", data, 5, spec=TDB.ShardSpec.create(S, use_mesh=False))
    ref, base = _shared_ref("test-bfv", S)
    st = _placed(sc, side, d)
    for a, b in ((own, flat), (st, base)):
        assert a.spec.mesh_devices == d and b.spec.mesh_devices == 1
        assert a.ciphertext_bytes() == b.ciphertext_bytes()
        assert repr(a).replace(f"devices={d}", "devices=1") == repr(b)
        for c in data:
            assert a.columns[c].c0.num_slabs == d
            _same_ct(a.columns[c], b.columns[c])
            assert np.array_equal(a.decrypt_column(sc.ks, c),
                                  b.decrypt_column(sc.ks, c))
        for s in range(S):
            _same_ct(a.shard(s).columns["v"], b.shard(s).columns["v"])
            _same_ct(a.gather("s", s, [1, 0]), b.gather("s", s, [1, 0]))
        rows = np.arange(N_ROWS)[::-1]
        _same_ct(a.gather_global("v", rows), b.gather_global("v", rows))
    assert np.array_equal(own.decrypt_column(sc.ks, "v"), data["v"])


# ---------------------------------------------------------------------------
# placed against the reference: scan, masks, top-k, the grid, writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", POSITIONS)
def test_placed_scan_matches_reference(d):
    """The fused scan's raw [S, A, W] values under a small lane budget
    (several tiles, each per slab), with the reference's obs counters
    and a `shard_map` span; then an And's masks and row ids and a TopK
    with ties in the reference's order, with ShardedExecStats."""
    sc, side, data = _fixture("test-bfv")
    ref, _ = _shared_ref("test-bfv", S)
    st = _placed(sc, side, d)
    ratoms, tatoms = _range_atoms(sc)
    budget = 4 * S * len(tatoms)
    with RO.tracing():
        want = RSX.sharded_fused_eval(sc.ref_ks, ref, ratoms,
                                      lane_budget=budget)
        ref_counts = {k: RO.REGISTRY.value(k) for k in SCAN_COUNTERS}
    with TO.tracing() as tr:
        got = TSX.sharded_fused_eval(sc.ks, st, tatoms, lane_budget=budget)
        counts = {k: TO.REGISTRY.value(k) for k in SCAN_COUNTERS}
        spans = [s for s in tr.spans if s.name == "shard.fused_eval"]
    assert np.array_equal(got, want)
    assert counts == ref_counts and ref_counts["eval.tiles"] > 1
    assert spans and all(s.args.get("shard_map") for s in spans)
    queries = {name: (rq, tq) for name, rq, tq in _queries(sc, data)}
    for name in ("and", "topk"):
        rq, tq = queries[name]
        _same_placed_result(TDB.execute(sc.ks, st, tq),
                            RDB.execute(sc.ref_ks, ref, rq), d)
    top = TDB.execute(sc.ks, st, queries["topk"][1])
    v = data["v"]
    assert v[top.row_ids].tolist() == sorted(v.tolist(), reverse=True)[:6]


@pytest.mark.parametrize("d", POSITIONS)
def test_shard_eval_values_splits_a_whole_stack(d):
    """`kernels.ops.shard_eval_values` handed the whole [S, U, W] stack
    and a mesh splits it over the mesh's positions: its scan tile equals
    the placed table's slabs' tile and the one-slab (unplaced) call."""
    sc, side, _ = _fixture("test-bfv")
    st = _placed(sc, side, d)
    _, tatoms = _range_atoms(sc)
    uniq, sel = TX.dedup_atom_columns(st, tatoms, st.scan_stack)
    bounds = TX.stack_atom_bounds(tatoms)
    whole = Ciphertext(uniq.c0.full(), uniq.c1.full())
    placed = TKO.shard_eval_values(sc.ks, uniq, bounds, mesh=st.spec.mesh,
                                   sel=sel, rows=(2, 5))
    split = TKO.shard_eval_values(sc.ks, whole, bounds, mesh=st.spec.mesh,
                                  sel=sel, rows=(2, 5))
    one = TKO.shard_eval_values(sc.ks, whole, bounds, sel=sel, rows=(2, 5))
    assert tuple(placed.shape) == (S, len(tatoms), 5)
    assert torch.equal(split, placed) and torch.equal(one, placed)


@pytest.fixture(scope="module")
def paper_fixture():
    """(scheme, side, data) under paper keys, shaped as `_fixture`."""
    sc = Scheme("test-bfv", "paper")
    rng = np.random.default_rng(11)
    data = {"v": sc.vals(rng.integers(0, 40, N_ROWS)),
            "s": sc.vals(rng.integers(0, 200, N_ROWS))}
    return sc, Side(sc.ref_ks, "t", data, 2), data


@pytest.mark.parametrize("mode", ["gadget", "paper"])
@pytest.mark.parametrize("d", POSITIONS)
def test_placed_pair_grid_matches_reference(d, mode, request):
    """The [S, S] shard-pair grid with the left table placed: raw values
    equal the reference's, one Eval call per right chunk (S_r·N_l·t_r
    within the pair budget) over every pair; the nested join's pairs,
    masks and projections equal the reference's."""
    if mode == "gadget":
        sc, side, data = _fixture("test-bfv")
    else:
        sc, side, data = request.getfixturevalue("paper_fixture")
    rk = data["s"][:13] % 40
    right = Side(sc.ref_ks, "R", {"v": rk}, 3)
    ref_l = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                        spec=RDB.ShardSpec.create(S))
    ref_r = RDB.ShardedTable.from_table(sc.ref_ks, right.ref,
                                        spec=RDB.ShardSpec.create(S))
    st_l, st_r = _placed(sc, side, d), _placed(sc, right, d)
    n_l, n_r = st_l.n_padded_per_shard, st_r.n_padded_per_shard
    budget = S * n_l * 2                        # two right rows a chunk
    stats = TJ.JoinStats()
    got = TSJ.sharded_pair_eval(sc.ks, st_l, st_r, "v", "v",
                                block_pairs=budget, stats=stats)
    assert np.array_equal(got, RSJ.sharded_pair_eval(
        sc.ref_ks, ref_l, ref_r, "v", "v", block_pairs=budget))
    assert stats.eval_calls == n_r // 2
    assert stats.pair_compares == S * S * n_l * n_r
    rj, tj = RP.Join(None, None, on="v"), TP.Join(None, None, on="v")
    g = TDB.execute_join(sc.ks, st_l, st_r, tj, strategy="nested")
    w = RDB.execute_join(sc.ref_ks, ref_l, ref_r, rj, strategy="nested")
    assert np.array_equal(g.pairs, np.argwhere(data["v"][:, None]
                                               == rk[None, :]))
    for f in ("pairs", "left_mask", "right_mask"):
        assert np.array_equal(getattr(g, f), getattr(w, f)), f
    assert g.stats.shards == w.stats.shards == (S, S)
    for side_name in ("left", "right"):
        gs, ws = getattr(g.stats, side_name), getattr(w.stats, side_name)
        assert gs.mesh_devices == d
        for f in EXEC_STATS:
            assert getattr(gs, f) == getattr(ws, f), (side_name, f)
    for name, ct in g.columns.items():
        _same_ct(ct, w.columns[name])


@pytest.mark.parametrize("d", POSITIONS)
def test_placed_writes_and_compaction_match_reference(d):
    """Inserts into the placed table's delta runs (routed as the
    reference routes them), a tombstone, the union scan's raw values and
    the And over base ∪ delta, `compact` (the fold re-places the
    stacks), then the scan again: state, counters and answers equal the
    reference's."""
    sc, side, data = _fixture("test-bfv")
    ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                      spec=RDB.ShardSpec.create(S))
    st = _placed(sc, side, d)
    st.fold_pad_rows = _ref_zeros(sc.ref_ks, 0xC0FD)
    new = _insert(sc, ref, st, [5, 17, 3, data["v"][0]], 40)
    assert ref.delete([1, N_ROWS + 1]) == st.delete([1, N_ROWS + 1]) == 2
    _same_state(st, ref)
    assert all(s.num_slabs == d for s in st.scan_stack("v"))
    ratoms, tatoms = _range_atoms(sc)
    queries = {name: (rq, tq) for name, rq, tq in _queries(sc, data)}

    def same_reads():
        with RO.tracing():
            want = RSX.sharded_fused_eval(sc.ref_ks, ref, ratoms,
                                          lane_budget=4 * S * 2)
            ref_counts = {k: RO.REGISTRY.value(k) for k in SCAN_COUNTERS}
        with TO.tracing():
            got = TSX.sharded_fused_eval(sc.ks, st, tatoms,
                                         lane_budget=4 * S * 2)
            counts = {k: TO.REGISTRY.value(k) for k in SCAN_COUNTERS}
        assert np.array_equal(got, want) and counts == ref_counts
        rq, tq = queries["and"]
        _same_placed_result(TDB.execute(sc.ks, st, tq),
                            RDB.execute(sc.ref_ks, ref, rq), d)
    same_reads()
    want = RDB.compact(sc.ref_ks, ref, {})
    got = TDB.compact(sc.ks, st, {})
    assert (got.n_delta, got.shards) == (want.n_delta, want.shards)
    assert not st.has_delta and st.columns["v"].c0.num_slabs == d
    _same_state(st, ref)
    same_reads()
    allv = np.concatenate([data["v"], new["v"]])
    assert np.array_equal(st.decrypt_column(sc.ks, "v"), allv)


# ---------------------------------------------------------------------------
# the reference's own shard_map path, four forced host devices
# ---------------------------------------------------------------------------

def test_matches_reference_shard_map_on_four_devices(tmp_path):
    """The reference under `--xla_force_host_platform_device_count=4`
    (a subprocess: the flag must precede JAX's start): its
    `ShardSpec.create(S).mesh_devices` for S in {1, 2, 3, 4, 6} equal the
    port's over four positions, and its `shard_map` fused-scan tile and
    pair grid (values, Eval calls, pair compares) equal the port's on
    `[cpu] * 4`."""
    was = os.environ.get("XLA_FLAGS")
    out = tmp_path / "readings.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert os.environ.get("XLA_FLAGS") == was
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(out.read_text())
    assert r["devices"] == 4
    assert r["mesh"]["ref"] == r["mesh"]["port"]
    assert r["ref_shard_map"] and r["port_mesh_devices"] == 4
    assert r["scan_equal"] and r["scan_tiles"] > 1
    assert r["grid_equal"] and r["grid_stats"]["ref"] == r["grid_stats"][
        "port"]


def _worker(out: str) -> None:
    """The subprocess of the test above: readings to `out`."""
    from repro.db import join as RJ
    from torch_fixtures import jit_reference
    from repro.kernels import ops as RKO
    jax.config.update("jax_disable_most_optimizations", True)
    shard_map = RKO._shard_map
    if "check_rep" not in inspect.signature(shard_map).parameters:
        # jax 0.8 renamed the reference's `check_rep=False` check_vma
        def _shard_map(f, *, check_rep=True, **kw):
            return shard_map(f, check_vma=check_rep, **kw)
        RKO._shard_map = _shard_map
    jit_reference()
    torch.set_num_threads(1)
    four = [CPU] * 4
    mesh = {"ref": {s: RDB.ShardSpec.create(s).mesh_devices
                    for s in MESH_SHARDS},
            "port": {s: TDB.ShardSpec.create(s, devices=four).mesh_devices
                     for s in MESH_SHARDS}}
    sc, side, data = _fixture("test-bfv")
    ref = RDB.ShardedTable.from_table(sc.ref_ks, side.ref,
                                      spec=RDB.ShardSpec.create(S))
    st = _placed(sc, side, 4)
    ratoms, tatoms = _range_atoms(sc)
    budget = 4 * S * len(tatoms)
    with RO.tracing():
        want = RSX.sharded_fused_eval(sc.ref_ks, ref, ratoms,
                                      lane_budget=budget)
        tiles = RO.REGISTRY.value("eval.tiles")
    got = TSX.sharded_fused_eval(sc.ks, st, tatoms, lane_budget=budget)
    rk = data["s"][:13] % 40
    right = Side(sc.ref_ks, "R", {"v": rk}, 3)
    ref_r = RDB.ShardedTable.from_table(sc.ref_ks, right.ref,
                                        spec=RDB.ShardSpec.create(S))
    st_r = _placed(sc, right, 4)
    budget = S * st.n_padded_per_shard * 2
    rstats, tstats = RJ.JoinStats(), TJ.JoinStats()
    gwant = RSJ.sharded_pair_eval(sc.ref_ks, ref, ref_r, "v", "v",
                                  block_pairs=budget, stats=rstats)
    ggot = TSJ.sharded_pair_eval(sc.ks, st, st_r, "v", "v",
                                 block_pairs=budget, stats=tstats)

    def counts(s):
        return [s.eval_calls, s.pair_compares]
    Path(out).write_text(json.dumps({
        "devices": jax.device_count(), "mesh": mesh,
        "ref_shard_map": ref.spec.shard_map_ok,
        "port_mesh_devices": st.spec.mesh_devices,
        "scan_equal": bool(np.array_equal(got, want)), "scan_tiles": tiles,
        "grid_equal": bool(np.array_equal(ggot, gwant)),
        "grid_stats": {"ref": counts(rstats), "port": counts(tstats)}}))


if __name__ == "__main__":
    _worker(sys.argv[1])
