"""The port's launch tools (`launch.specs`, `launch.roofline`,
`launch.dryrun`, `launch.report`) against the reference's.

* Specs: `cell_supported` of all 40 (architecture x shape) cells equals
  the reference's (32 runnable, the 8 skips the full-attention
  architectures at long_500k), and every leaf of every runnable cell's
  input specs has the reference's shape and dtype (the reference's trees
  from `jax.eval_shape`, traced once per architecture and cache shape).
* Roofline: `model_flops`, `memory_floor` and `_cache_bytes` equal the
  reference's exactly for every runnable cell at 256 and 512 chips; the
  terms divide by the H100 constants (bf16 989.4e12 FLOP/s, HBM3
  3.35e12 B/s, NVLink 4 450e9 B/s for `model`, InfiniBand NDR 50e9 B/s
  for `data` and `pod`), not the TPU's.
* Dry-run and report: `launch.dryrun` in a subprocess (it replaces the
  default process group) on both meshes for smollm-360m decode_32k and
  hades-cmp cmp_64k: each record `ok`, with the fields of the
  reference's record; `report.load`/`roofline_table`/`dryrun_table`
  build the tables from them.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCFG
from repro.launch import roofline as RRL
from repro.launch import specs as RSP
from repro.models import serve as RSV
from repro.train import train_lib as RTL
from repro_torch import configs as TCFG
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import report as TR
from repro_torch.launch import roofline as TRL
from repro_torch.launch import specs as TSP
from repro_torch.parallel import sharding as TSH

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

ROOT = Path(__file__).resolve().parents[1]


def _cells():
    return [(a, s) for a in RCFG.ARCH_IDS for s in RSP.SHAPES]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_40_cells_supported_as_the_reference():
    assert list(TSP.SHAPES) == list(RSP.SHAPES)
    assert TSP.SHAPES == RSP.SHAPES
    assert len(_cells()) == 40
    got = {(a, s): TSP.cell_supported(TCFG.get_config(a), s)
           for a, s in _cells()}
    want = {(a, s): RSP.cell_supported(RCFG.get_config(a), s)
            for a, s in _cells()}
    assert got == want
    assert sum(ok for ok, _ in got.values()) == 32
    skipped = sorted(a for (a, s), (ok, _) in got.items() if not ok)
    assert all(s == "long_500k" for (a, s), (ok, _) in got.items() if not ok)
    assert skipped == sorted([
        "llava_next_34b", "minitron_8b", "smollm_360m", "minicpm3_4b",
        "internlm2_20b", "deepseek_moe_16b", "qwen3_moe_30b_a3b",
        "whisper_base"])


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    cfg = RCFG.get_config(arch)
    return jax.eval_shape(lambda: RTL.init_state(cfg, RTL.TrainConfig(),
                                                 jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, gb, seq):
    cfg = RCFG.get_config(arch)
    return jax.eval_shape(lambda: RSV.init_cache(cfg, gb, seq))


def _ref_args(arch, shape):
    """The reference's input specs of a cell, from the per-architecture
    cached trees (the same trees `repro.launch.specs.input_specs`
    traces)."""
    cfg = RCFG.get_config(arch)
    meta = RSP.SHAPES[shape]
    seq, gb = meta["seq_len"], meta["global_batch"]
    state = _ref_state(arch)
    if meta["kind"] == "train":
        return (state, RSP.batch_specs(cfg, seq, gb))
    if meta["kind"] == "prefill":
        return (state.params, RSP.batch_specs(cfg, seq, gb))
    return (state.params, _ref_cache(arch, gb, seq),
            jax.ShapeDtypeStruct((gb,), jnp.int32))


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name",
                                                     getattr(k, "idx", k))))
                       for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree):
    out = {}
    TSH.tree_map_with_path(
        lambda path, t: out.__setitem__(
            "/".join(map(str, path)),
            (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tree)
    return out


@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_input_specs_match_reference(arch):
    tcfg = TCFG.get_config(arch)
    for shape in RSP.SHAPES:
        if not TSP.cell_supported(tcfg, shape)[0]:
            continue
        spec = TSP.input_specs(tcfg, shape)
        assert spec["kind"] == RSP.SHAPES[shape]["kind"]
        got, want = spec["args"], _ref_args(arch, shape)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            wl = _ref_leaves(w) if not isinstance(
                w, jax.ShapeDtypeStruct) else {
                    "": (tuple(w.shape), np.dtype(w.dtype).name)}
            gl = _port_leaves(g) if not isinstance(g, torch.Tensor) else {
                "": (tuple(g.shape), str(g.dtype).replace("torch.", ""))}
            assert gl == wl, (shape, sorted(set(gl.items()) ^
                                            set(wl.items()))[:4])


def test_specs_allocate_nothing():
    """The stand-ins are fake tensors: a 34B train state costs no memory."""
    from torch._subclasses.fake_tensor import FakeTensor
    state = TSP.train_state_specs(TCFG.get_config("llava_next_34b"),
                                  TD.TL.TrainConfig())
    leaves = list(_port_leaves(state))
    assert len(leaves) > 10
    assert isinstance(state.params["embed"], FakeTensor)
    assert isinstance(state.opt.mu["groups"]["b0"]["attn"]["wq"], FakeTensor)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chips,data_shards", [(256, 32), (512, 64)])
def test_roofline_arithmetic_matches_reference(chips, data_shards):
    n = 0
    for arch, shape in _cells():
        rcfg, tcfg = RCFG.get_config(arch), TCFG.get_config(arch)
        if not TSP.cell_supported(tcfg, shape)[0]:
            continue
        meta = RSP.SHAPES[shape]
        kind, seq, gb = meta["kind"], meta["seq_len"], meta["global_batch"]
        assert (TRL.model_flops(tcfg, kind, seq, gb, chips)
                == RRL.model_flops(rcfg, kind, seq, gb, chips))
        assert (TRL.memory_floor(tcfg, kind, seq, gb, chips, data_shards)
                == RRL.memory_floor(rcfg, kind, seq, gb, chips, data_shards))
        assert (TRL._cache_bytes(tcfg, seq, gb)
                == RRL._cache_bytes(rcfg, seq, gb))
        n += 1
    assert n == 32


def test_roofline_terms_use_h100_constants():
    assert TM.PEAK_FLOPS_BF16 == 989.4e12
    assert TM.HBM_BW == 3.35e12
    assert TM.NVLINK_BW == 450e9
    assert TM.IB_BW == 50e9
    assert TM.HBM_BYTES == 80e9
    assert TM.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}
    assert TD.chips_hbm() == 3.35e12
    coll = {}
    TRL.count_collective(coll, "all-reduce", "model", 450e9)  # counted 2x
    TRL.count_collective(coll, "all-gather", "data", 50e9)
    TRL.count_collective(coll, "reduce-scatter", "pod", 25e9)
    t = TRL.RooflineTerms(
        arch="a", shape="s", mesh="32x8", chips=256, flops_per_dev=989.4e12,
        bytes_per_dev=6.7e12, coll_bytes_per_dev=0.0, coll_by_op={},
        model_flops_per_dev=494.7e12, mem_floor_bytes=3.35e12,
        coll_by_axis=coll)
    assert t.compute_s == 1.0
    assert t.memory_s == 1.0 and t.memory_upper_s == 2.0
    assert t.collective_s == pytest.approx(2.0 + 1.0 + 0.5)
    assert t.dominant == "collective" and t.step_time_s == t.collective_s
    assert t.roofline_fraction == pytest.approx(0.5 / 3.5)
    assert TRL.by_op(coll) == {"all-reduce": 900e9, "all-gather": 50e9,
                               "reduce-scatter": 25e9}


def test_mesh_shapes():
    assert TM.PRODUCTION_SHAPE == (32, 8)
    assert TM.MULTI_POD_SHAPE == (2, 32, 8)
    with pytest.raises(RuntimeError):
        TM.make_production_mesh()            # no process group of 256


# ---------------------------------------------------------------------------
# dry-run and report
# ---------------------------------------------------------------------------

# the reference's record (launch/dryrun.py's run_cell)
REF_RECORD = {"arch", "shape", "mesh", "status", "chips", "microbatches",
              "cost_compile_s", "memfit_compile_s", "memory", "cost",
              "collectives", "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device_gib"}
REF_ROOFLINE = {"compute_s", "memory_s", "memory_upper_s", "collective_s",
                "dominant", "model_flops_per_dev", "useful_ratio",
                "roofline_fraction", "step_time_s"}


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    code = ("from repro_torch.launch import dryrun as D\n"
            f"D.main(['--arch', 'smollm-360m', '--shape', 'decode_32k', "
            f"'--both-meshes', '--out', {str(out)!r}])\n"
            f"D.main(['--arch', 'hades-cmp', '--shape', 'cmp_64k', "
            f"'--both-meshes', '--out', {str(out)!r}])\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("[ok]") == 4, proc.stdout
    return out


def test_dryrun_records_have_reference_schema(dryrun_records):
    recs = {}
    for f in dryrun_records.glob("*.json"):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    assert set(recs) == {("smollm-360m", "decode_32k", "32x8"),
                         ("smollm-360m", "decode_32k", "2x32x8"),
                         ("hades-cmp", "cmp_64k", "32x8"),
                         ("hades-cmp", "cmp_64k", "2x32x8")}
    for r in recs.values():
        assert r["status"] == "ok"
        assert REF_RECORD <= set(r)
        assert REF_MEMORY <= set(r["memory"])
        assert REF_ROOFLINE <= set(r["roofline"])
        assert r["roofline"]["step_time_s"] > 0
    lm = recs[("smollm-360m", "decode_32k", "32x8")]
    assert lm["chips"] == 256 and lm["cost"]["flops"] > 0
    assert lm["memory"]["peak_per_device_gib"] > 0
    # one decode step's model FLOPs: 2 N per token, 128 tokens, 256 chips
    cfg = TCFG.get_config("smollm-360m")
    assert lm["roofline"]["model_flops_per_dev"] == pytest.approx(
        2 * cfg.active_param_count() * 128 / 256)
    hc = recs[("hades-cmp", "cmp_64k", "2x32x8")]
    assert hc["chips"] == 512 and hc["b_dev"] == 1024
    assert hc["collectives"] == {} and hc["roofline"]["collective_s"] == 0
    assert recs[("hades-cmp", "cmp_64k", "32x8")]["b_dev"] == 2048


def test_report_builds_tables(dryrun_records):
    recs = TR.load(str(dryrun_records))
    assert set(recs) == {("smollm_360m", "decode_32k", "32x8"),
                         ("smollm_360m", "decode_32k", "2x32x8"),
                         ("hades-cmp", "cmp_64k", "32x8"),
                         ("hades-cmp", "cmp_64k", "2x32x8")}
    for mesh in TR.MESHES:
        table = TR.roofline_table(recs, mesh).splitlines()
        assert len(table) == 2 + 2
        assert any(line.startswith("| smollm_360m | decode_32k |")
                   for line in table)
        assert any(line.startswith("| hades-cmp | cmp_64k |")
                   for line in table)
    assert len(TR.dryrun_table(recs).splitlines()) == 2 + 4
    assert TR.summary(recs).startswith("cells: 4 ok, 0 skip, 0 error")
