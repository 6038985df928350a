"""The port's parallel substrate (`repro_torch.parallel`, the MoE's expert
parallelism) against the reference's (`repro.parallel`, `repro.models.moe`).

* Sharding rules: `param_specs` of every architecture's reduced and full
  config (the reference's trees from `jax.eval_shape`, the port's from a
  fake-tensor init) equal leaf by leaf, each P read as a tuple; the
  reference's spot checks; `cache_specs`, `data_specs`, `choose_layout`
  and `sanitize_specs` (both `allow_move` settings) equal on the
  production meshes (32 x 8, 2 x 32 x 8; the reference's built as
  `jax.sharding.AbstractMesh`).
* `constrain`: `shard` is the identity without a mesh and on a one-rank
  mesh; `resolve` equals the reference's resolution over a grid of shapes,
  meshes and batch-axes overrides (the reference's `shard` run with its
  constraint captured).
* Expert parallelism in one process: the per-rank body summed over 2 and
  4 model ranks against the reference's `_moe_apply_global`, outputs and
  gradients (float32, reduced deepseek-moe and qwen3-moe).
* A real mesh of two ranks: gloo through `torch.multiprocessing.spawn`
  with a `file://` store (tests/torch_mesh_worker.py), the reduced
  smollm (parameters placed by the rules on a (1, 2) mesh) and the
  reduced deepseek-moe (through `_moe_apply_ep`) against the plain
  forward.
"""
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro import configs as RCFG
from repro.launch import specs as RSP
from repro.models import moe as RMOE
from repro.models import serve as RSV
from repro.models import transformer as RT
from repro.parallel import constrain as RC
from repro.parallel import sharding as RSH
from repro_torch import configs as TCFG
from repro_torch.launch import specs as TSP
from repro_torch.models import moe as TMOE
from repro_torch.parallel import constrain as TC
from repro_torch.parallel import sharding as TSH
from repro_torch.parallel.constrain import AbstractMesh as TMesh, P

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

MESHES = {"32x8": ((32, 8), ("data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model"))}
# the EP body summed over ranks against the global path: float32 reads
# ~5e-7 on these configs (printed by `python tests/test_torch_parallel.py`),
# the limit is 10x that rounded up
EP_TOL = 1e-5
# the two-rank gloo mesh against the plain forward: reads ~2.6e-6
MESH_TOL = 1e-5


def _ref_mesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _port_mesh(name):
    return TMesh(*MESHES[name])


def _ref_flat(tree):
    """{"/"-joined key path: leaf} of a reference tree (P as a leaf)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = leaf
    return out


def _port_flat(tree):
    out = {}
    TSH.tree_map_with_path(
        lambda path, leaf: out.__setitem__("/".join(map(str, path)), leaf),
        tree, is_leaf=lambda x: isinstance(x, P))
    return out


def _as_tuples(flat):
    return {k: tuple(v) for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def _params(arch, full):
    """(reference abstract params, port fake params) of a config."""
    get = "get_config" if full else "get_reduced"
    rcfg, tcfg = getattr(RCFG, get)(arch), getattr(TCFG, get)(arch)
    rp = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
    return rp, TSP.params_specs(tcfg)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_param_specs_match_reference(arch, full):
    rp, tp = _params(arch, full)
    want = _as_tuples(_ref_flat(RSH.param_specs(rp)))
    got = _as_tuples(_port_flat(TSH.param_specs(tp)))
    assert got == want


def test_param_rules_spot_checks():
    _, params = _params("minitron_8b", False)
    specs = TSH.param_specs(params)
    assert specs["embed"] == P("model", None)
    assert specs["unembed"] == P(None, "model")
    g = specs["groups"]["b0"]
    assert g["attn"]["wq"] == P(None, "data", "model")
    assert g["attn"]["wo"] == P(None, "model", "data")
    assert g["ffn"]["wi"] == P(None, "data", "model")
    assert g["ffn"]["wo"] == P(None, "model", "data")
    assert g["ln1"]["scale"] == P()


def test_moe_param_rules():
    _, params = _params("qwen3_moe_30b_a3b", False)
    g = TSH.param_specs(params)["groups"]["b0"]
    assert g["moe"]["experts_wi"] == P(None, "model", "data", None)
    assert g["moe"]["experts_wo"] == P(None, "model", None, "data")
    assert g["moe"]["router"] == P(None, "data", None)


@pytest.mark.parametrize("allow_move", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["minicpm3_4b", "smollm_360m",
                                  "qwen3_moe_30b_a3b", "recurrentgemma_9b",
                                  "whisper_base"])
def test_sanitize_specs_match_reference(arch, mesh, allow_move):
    rp, tp = _params(arch, True)
    want = RSH.sanitize_specs(_ref_mesh(mesh), RSH.param_specs(rp), rp,
                              allow_move=allow_move)
    got = TSH.sanitize_specs(_port_mesh(mesh), TSH.param_specs(tp), tp,
                             allow_move=allow_move)
    assert _as_tuples(_port_flat(got)) == _as_tuples(_ref_flat(want))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_choose_layout_matches_reference(mesh):
    for arch in RCFG.ARCH_IDS:
        rcfg, tcfg = RCFG.get_config(arch), TCFG.get_config(arch)
        for meta in TSP.SHAPES.values():
            gb = meta["global_batch"]
            want = RSH.choose_layout(_ref_mesh(mesh), rcfg.param_count(), gb)
            got = TSH.choose_layout(_port_mesh(mesh), tcfg.param_count(), gb)
            assert got == want, (arch, gb)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("override", [None, ("data", "model"),
                                      ("pod", "data", "model")])
@pytest.mark.parametrize("arch", ["minicpm3_4b", "whisper_base",
                                  "recurrentgemma_9b", "xlstm_125m",
                                  "llava_next_34b"])
def test_cache_and_data_specs_match_reference(arch, override, mesh):
    rcfg, tcfg = RCFG.get_config(arch), TCFG.get_config(arch)
    gb, seq = 128, 32768
    rcache = jax.eval_shape(lambda: RSV.init_cache(rcfg, gb, seq))
    tcache = TSP.cache_specs_abstract(tcfg, gb, seq)
    rbatch = RSP.batch_specs(rcfg, seq, gb)
    tbatch = TSP.batch_specs(tcfg, seq, gb)
    try:
        RC.set_batch_axes(override)
        TC.set_batch_axes(override)
        want = _as_tuples(_ref_flat(RSH.cache_specs(_ref_mesh(mesh), rcache)))
        want_d = _as_tuples(_ref_flat(RSH.data_specs(_ref_mesh(mesh),
                                                     rbatch)))
        got = _as_tuples(_port_flat(TSH.cache_specs(_port_mesh(mesh),
                                                    tcache)))
        got_d = _as_tuples(_port_flat(TSH.data_specs(_port_mesh(mesh),
                                                     tbatch)))
    finally:
        RC.set_batch_axes(None)
        TC.set_batch_axes(None)
    assert got == want
    assert got_d == want_d


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def test_constrain_noop_without_mesh():
    x = torch.zeros((4, 8))
    assert TC.shard(x, "batch", "model") is x


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group (an in-process store) for the test."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_constrain_noop_on_one_rank_mesh(one_rank_group):
    from torch.distributed.tensor import distribute_tensor, Replicate
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (1, 1)
    x = torch.zeros((4, 8))
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with TC.use_mesh(mesh):
        assert TC.shard(x, "batch", "model") is x
        assert TC.shard(d, "batch", "model") is d


def _ref_resolve(mesh_shape, names, dims, shape):
    """The reference's `shard` resolution: its constraint captured in
    place of `with_sharding_constraint`, over a stand-in ambient mesh."""
    mesh = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, mesh_shape)))
    fake_jax = types.SimpleNamespace(lax=types.SimpleNamespace(
        with_sharding_constraint=lambda x, s: s))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(RC, "_ambient_mesh", lambda: mesh)
        mp.setattr(RC, "NamedSharding", lambda m, spec: spec)
        mp.setattr(RC, "jax", fake_jax)
        return RC.shard(types.SimpleNamespace(shape=shape), *dims)
    finally:
        mp.undo()


@pytest.mark.parametrize("override", [None, ("data", "model"),
                                      ("pod", "data", "model")])
@pytest.mark.parametrize("mesh", [((32, 8), ("data", "model")),
                                  ((2, 32, 8), ("pod", "data", "model")),
                                  ((1, 1), ("data", "model")),
                                  ((4, 2), ("data", "model"))])
def test_resolve_matches_reference(mesh, override):
    dims_grid = [("batch", None, "model", None), ("batch", "model"),
                 ("model", None, None), ("batch", None, None),
                 ("batch", "model", None, None), ("data", "model")]
    shapes = [(1, 7, 15, 64), (256, 4096, 48, 128), (4, 2, 4, 8),
              (64, 1, 8, 16), (512, 3, 1, 1)]
    try:
        RC.set_batch_axes(override)
        TC.set_batch_axes(override)
        for dims in dims_grid:
            for shape in shapes:
                shape = shape[:len(dims)]
                want = _ref_resolve(*mesh, dims, shape)
                got = TC.resolve(TMesh(*mesh), dims, shape)
                assert tuple(got) == tuple(want), (dims, shape)
    finally:
        RC.set_batch_axes(None)
        TC.set_batch_axes(None)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_case(arch):
    rcfg, tcfg = RCFG.get_reduced(arch), TCFG.get_reduced(arch)
    rparams = RMOE.moe_init(jax.random.PRNGKey(3), rcfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, rcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    return rcfg, tcfg, rparams, x, w


def _ep_sum(tcfg, params, x, n_model):
    """The routed experts' output summed over the model ranks' bodies,
    plus the shared experts (as `_moe_apply_ep` adds them)."""
    from repro_torch.models import layers as TLY
    B, S, d = x.shape
    E_loc = tcfg.num_experts // n_model
    xf = x.reshape(B * S, d)
    out = sum(TMOE._moe_ep_body(
        tcfg, xf, params["router"],
        *(params[k][r * E_loc:(r + 1) * E_loc]
          for k in ("experts_wi", "experts_wg", "experts_wo")), r)
        for r in range(n_model))
    if tcfg.num_shared_experts:
        out = out + TLY.swiglu_apply(params["shared"], xf)
    return out.reshape(B, S, d)


def _ep_readings(arch, n_model):
    rcfg, tcfg, rparams, x, w = _moe_case(arch)

    def ref_loss(p, xx):
        return jnp.sum(RMOE._moe_apply_global(p, rcfg, xx) * w)
    want = RMOE._moe_apply_global(rparams, rcfg, jnp.asarray(x))
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(rparams, jnp.asarray(x))
    tparams = jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), rparams)
    tx = torch.tensor(x, requires_grad=True)
    got = _ep_sum(tcfg, tparams, tx, n_model)
    torch.sum(got * torch.as_tensor(w)).backward()
    errs = {"out": float(np.abs(got.detach().numpy() - np.asarray(want))
                         .max()),
            "grad_x": float(np.abs(tx.grad.numpy() - np.asarray(gx)).max())}
    ref_g, port_g = _ref_flat(gp), {}
    TSH.tree_map_with_path(
        lambda path, t: port_g.__setitem__("/".join(path), t.grad), tparams)
    errs["grad_params"] = max(
        float(np.abs(port_g[k].numpy() - np.asarray(v)).max())
        for k, v in ref_g.items())
    return errs


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_moe_30b_a3b"])
def test_ep_body_sums_to_global(arch, n_model):
    errs = _ep_readings(arch, n_model)
    assert max(errs.values()) <= EP_TOL, errs


def test_moe_apply_takes_ep_path_only_on_a_model_axis(monkeypatch):
    """moe_apply's mesh check: the EP path on a mesh whose model axis
    (wider than 1) divides the experts, the global path otherwise."""
    taken = []
    monkeypatch.setattr(TMOE, "_moe_apply_ep",
                        lambda *a: taken.append("ep") or "ep")
    monkeypatch.setattr(TMOE, "_moe_apply_global",
                        lambda *a: taken.append("global") or "global")
    cfg = TCFG.get_reduced("deepseek_moe_16b")          # 8 experts
    for shape, want in (((1, 1), "global"), ((1, 2), "ep"), ((4, 8), "ep"),
                        ((2, 3), "global"), ((8, 16), "global")):
        with TC.use_mesh(TMesh(shape, ("data", "model"))):
            assert TMOE.moe_apply({}, cfg, None) == want, shape
    assert TMOE.moe_apply({}, cfg, None) == "global"


# ---------------------------------------------------------------------------
# a real mesh of two ranks
# ---------------------------------------------------------------------------

def test_two_rank_gloo_mesh_matches_plain_forward(tmp_path):
    import torch.multiprocessing as mp
    import torch_mesh_worker as W
    out = tmp_path / "result.json"
    mp.spawn(W.run, args=(str(tmp_path / "store"), str(out)), nprocs=2)
    res = json.loads(out.read_text())
    assert res["ep_calls"] == 4          # deepseek: 2 layers, forward + loss
    for arch in ("smollm-360m", "deepseek-moe-16b"):
        assert res[arch]["forward"] <= MESH_TOL, res
        assert res[arch]["loss"] <= MESH_TOL, res


if __name__ == "__main__":
    for arch in ("deepseek_moe_16b", "qwen3_moe_30b_a3b"):
        for n in (2, 4):
            print(arch, n, _ep_readings(arch, n))
