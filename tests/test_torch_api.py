"""The port's public names against the reference's.

For each module a user imports from (`core`, `core.compare`, `db`,
`db.executor`, `db.table`, `kernels.ops`, `kernels.cmp_eval`,
`kernels.ntt`, `db.shard.spec`,
`launch.elastic`, the LM's `models.layers`, `models.moe`,
`models.rglru`, `models.xlstm`, `models.serve`, `models.transformer`,
and training's `train.optimizer`, `train.compress`, `train.data`,
`train.checkpoint`, `train.train_lib` and `launch.train`, the launch
tools `launch.mesh`, `launch.specs`, `launch.roofline`, `launch.dryrun`
and `launch.report`, and `parallel.sharding` and `parallel.constrain`)
and the classes `Table` and `ShardSpec`, every public
name of the reference must exist in the port, except the intended
absences below, each with its reason.  A module's public names are
those not starting with `_` that it defines, or, for a package, that it
re-exports.  The names this diff once found missing (`compare_many`,
`fused_compare`, `Table.column_names`, `kernels.ops.negacyclic_mul` and
`core`'s exports) are also held equal to the reference on the same
inputs (the test-bfv KeySet of `tests/conftest.py`), and so are
`kernels.cmp_eval.cek_to_br` and `cek_gadget_to_br` (test-bfv and
test-ckks, both modes, on the port's keys handed to a reference
`KeySet`).
"""
import importlib
import inspect
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compare as RC
from repro.db import executor as RX
from repro.db import plan as RP
from repro.kernels import cmp_eval as RCK
from repro.kernels import ops as RKO
from repro_torch.core import compare as TC
from repro_torch.db import executor as TX
from repro_torch.db import plan as TP
from repro_torch.kernels import cmp_eval as TCK
from repro_torch.kernels import ops as TKO

from test_torch_core import jitted_ref, n_, t_
from test_torch_db import _fixture
from test_torch_join import gadget_keys
from test_torch_write import _keys as paper_keys
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

MODULES = ("core", "core.compare", "db", "db.executor", "db.table",
           "kernels.ops", "kernels.cmp_eval", "kernels.ntt", "db.shard.spec",
           "launch.elastic", "models.layers", "models.moe", "models.rglru",
           "models.xlstm", "models.serve", "models.transformer",
           "train.optimizer", "train.compress", "train.data",
           "train.checkpoint", "train.train_lib", "launch.train",
           "launch.mesh", "launch.specs", "launch.roofline", "launch.dryrun",
           "launch.report", "parallel.sharding", "parallel.constrain")
CLASSES = (("db.table", "Table"), ("db.shard.spec", "ShardSpec"))

# (module or "module.Class", name) -> why the port has no such name
ABSENT = {
    ("db.executor", "jitted_eval"):
        "a jit helper: PyTorch runs eagerly, so there is nothing to jit",
    ("db.executor", "jitted_dedup_eval"):
        "a jit helper: PyTorch runs eagerly, so there is nothing to jit",
    ("db.executor", "jitted_comparator"):
        "a jit helper: PyTorch runs eagerly, so there is nothing to jit",
    ("db.table", "column_key"):
        "a jax.random key per column; the port derives a seed per column "
        "(db.table.column_seed) for its torch.Generator",
    ("kernels.cmp_eval", "DEFAULT_BLOCK_B"):
        "the Pallas grid's rows per program; the Hopper kernels fix their "
        "own geometry (warps per 16-row tile, clusters per lane set) in "
        "csrc/cmp_eval.cu",
    ("kernels.ntt", "DEFAULT_BLOCK_B"):
        "the Pallas grid's rows per program; the Hopper kernels fix their "
        "own geometry (rows per block, minimum blocks per SM) in csrc/ntt.cu",
    ("launch.roofline", "collective_bytes"):
        "parses XLA's post-SPMD HLO text; the port has no HLO: the "
        "dry-run records each collective's kind, mesh axis and result "
        "bytes while it traces (roofline.count_collective)",
}
# reference modules with no port module at all
ABSENT_MODULES = {
    "kernels.ref": "the plain versions sit beside each port kernel as "
                   "`*_plain` (kernels/cmp_eval.py, kernels/ntt.py)",
}
# private, and so outside the diff, yet absent on purpose
ABSENT_PRIVATE = {
    ("db.executor", "_use_kernel"):
        "the engine switch; the port dispatches by the device its tensors "
        "lie on",
    ("launch.dryrun", "_depth_variant"):
        "XLA's cost analysis counts a loop body once, so the reference "
        "compiles depth 1 and 2 and extrapolates; the port's eager trace "
        "counts every layer",
    ("launch.dryrun", "_extrapolated_cost"):
        "XLA's cost analysis counts a loop body once, so the reference "
        "compiles depth 1 and 2 and extrapolates; the port's eager trace "
        "counts every layer",
}


def _import_ref(name):
    """A reference module; `repro.launch.dryrun` sets XLA_FLAGS for 512
    host devices when imported, which must reach neither this process's
    JAX (its backend starts first) nor a later subprocess."""
    jax.devices()
    was = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{name}")
    finally:
        if was is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = was


def _public(mod) -> set:
    """Names a module defines or (a package) re-exports."""
    package = hasattr(mod, "__path__")
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        owner = getattr(obj, "__module__", None)
        if callable(obj) or inspect.isclass(obj):
            if package or owner == mod.__name__:
                out.add(name)
        elif owner is None or owner == mod.__name__:
            out.add(name)
    return out


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_reference(name):
    ref = _import_ref(name)
    port = importlib.import_module(f"repro_torch.{name}")
    missing = {n for n in _public(ref) if not hasattr(port, n)}
    absent = {n for (m, n) in ABSENT if m == name}
    assert missing == absent, sorted(missing ^ absent)


@pytest.mark.parametrize("module,cls", CLASSES)
def test_public_class_members_match_reference(module, cls):
    ref = getattr(importlib.import_module(f"repro.{module}"), cls)
    port = getattr(importlib.import_module(f"repro_torch.{module}"), cls)
    missing = {n for n in dir(ref) if not n.startswith("_")
               and not hasattr(port, n)}
    absent = {n for (m, n) in ABSENT if m == f"{module}.{cls}"}
    assert missing == absent, sorted(missing ^ absent)


def test_absent_modules_and_core_exports():
    """The modules of ABSENT_MODULES and the names of ABSENT_PRIVATE have
    no port counterpart; `repro_torch.core` exports the reference's 14
    names, each the object its submodule defines."""
    for name in ABSENT_MODULES:
        importlib.import_module(f"repro.{name}")
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"repro_torch.{name}")
    for module, name in ABSENT_PRIVATE:
        assert name in vars(_import_ref(module))
        assert not hasattr(importlib.import_module(f"repro_torch.{module}"),
                           name)
    from repro import core as R
    from repro_torch import core as T
    names = {"HadesParams", "Profile", "make_params", "KeySet", "keygen",
             "Ciphertext", "encrypt_fae", "decrypt", "decrypt_raw",
             "compare_many", "compare_fae", "range_query", "encrypted_sort",
             "encrypted_topk"}
    assert names <= _public(R) and names <= _public(T)
    from repro_torch.core.keys import keygen
    assert T.keygen is keygen and T.compare_many is TC.compare_many


def _rows(ct, k):
    return type(ct)(ct.c0[:k], ct.c1[:k])


def test_compare_many_and_column_names_match_reference():
    ref_ks, tks, ref_table, table, _, _ = _fixture("test-bfv")
    assert table.column_names == ref_table.column_names == ("a", "b")
    ra, rb = _rows(ref_table.columns["a"], 12), _rows(ref_table.columns["b"],
                                                      12)
    want = jitted_ref(ref_ks, RC.compare_many)(ra, rb)
    got = TC.compare_many(tks, _rows(table.columns["a"], 12),
                          _rows(table.columns["b"], 12))
    assert np.array_equal(n_(got), np.asarray(want))
    assert set(np.asarray(want).tolist()) <= {-1, 0, 1}


def test_fused_compare_matches_reference():
    ref_ks, tks, ref_table, table, data, enc = _fixture("test-bfv")
    specs = [("a", ">=", int(data["a"][2])), ("a", "==", int(data["a"][2])),
             ("b", "<=", 3)]
    cts = [enc(v) for _, _, v in specs]
    ref_atoms = [RP.Atom(c, op, ct[0]) for (c, op, _), ct in zip(specs, cts)]
    atoms = [TP.Atom(c, op, ct[1]) for (c, op, _), ct in zip(specs, cts)]
    want = RX.fused_compare(ref_ks, ref_table, ref_atoms, lane_budget=24)
    got = TX.fused_compare(tks, table, atoms, lane_budget=24)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert set(np.unique(got).tolist()) == {-1, 0, 1}


def test_ops_negacyclic_mul_matches_reference():
    ref_ks, tks, _, _, _, _ = _fixture("test-bfv")
    rng = np.random.default_rng(16)
    q = np.asarray(ref_ks.params.qs)[:, None]
    a, b = (rng.integers(0, q, size=(3, *q.shape[:1], ref_ks.params.n))
            for _ in range(2))
    want = RKO.negacyclic_mul(jnp.asarray(a), jnp.asarray(b), ref_ks.ring,
                              interpret=True)
    got = TKO.negacyclic_mul(t_(a), t_(b), tks.ring)
    assert got.dtype == torch.int64
    assert np.array_equal(n_(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["paper", "gadget"])
@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_cek_to_br_matches_reference(profile, mode):
    """The CEK in the reference kernels' bit-reversed eval order: paper
    mode's `cek_to_br` [K, n], gadget mode's `cek_gadget_to_br` [E, K,
    n], byte-equal to the reference's on the same key material."""
    if mode == "paper":
        ref_ks, tks, _ = paper_keys(profile)
        want, got = RCK.cek_to_br(ref_ks), TCK.cek_to_br(tks)
        shape = (tks.params.num_towers, tks.params.n)
    else:
        ref_ks, tks = gadget_keys(profile)
        want, got = RCK.cek_gadget_to_br(ref_ks), TCK.cek_gadget_to_br(tks)
        p = tks.params
        shape = (p.num_towers * p.gadget_digits_per_tower, p.num_towers, p.n)
    assert tuple(got.shape) == shape and got.dtype == torch.int64
    assert np.array_equal(n_(got), np.asarray(want))
