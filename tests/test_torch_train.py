"""The port's training substrate (`repro_torch.train`, `transformer.loss_fn`,
`launch.train`, `launch.elastic.resume_plan`) against the JAX reference.

Tolerances, each from the readings on these inputs:
- AdamW and the schedule, against the reference run op by op (each op
  its own XLA program, as the optimizer's definition reads): every leaf
  within ULP_TOL = 8 ulps of its largest value (`_ulps`).  Readings
  over three steps: 0 without clipping; clipped, the global norm sums
  1,264 squares in another order and reads 2 ulps off, and the clip
  scale carries that into the moments (mu ≤ 4, nu = (1 - b2) (s g)^2
  ≤ 6) and the parameters (≤ 0.25).  (The reference jitted whole fuses
  the schedule and reads 1 ulp off in lr.)
- The int8 error-feedback compressor: exactly equal (`jnp.round` and
  `torch.round` both round half to even), against the reference op by
  op; jitted, XLA turns the division by 127 into a product and moves the
  scale by an ulp.
- `loss_fn` and its gradients in float32 against `jax.value_and_grad`:
  |loss| within LOSS_TOL = 1e-5 (readings ≤ 1e-6), every gradient leaf
  within GRAD_TOL = 5e-5 (readings ≤ 4.1e-6, xLSTM's embedding), on the
  reduced smollm, xLSTM and llava (its patch mask).
- One train step against the reference's jitted step (mb = 1, mb = 4,
  compression on): loss within LOSS_TOL, grad norm within 1e-5
  relative (readings ≤ 7e-7), lr exact, parameters within 2e-5
  (readings ≤ 2.2e-6), moments within 1e-7 (readings ≤ 6.2e-9), the
  compressor's residuals within 2e-6 (reading 1.8e-7: a residual
  carries the gradient's float32 difference whole, a moment a tenth).
`FileDataset` batches and checkpoint leaf names are exactly equal, and a
checkpoint written by either package restores in the other (bfloat16
from the reference into the port: the reference's own `restore` cannot
read back a bfloat16 leaf, see `repro_torch/train/checkpoint.py`).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCFG
from repro.launch import elastic as REL
from repro.models import transformer as RT
from repro.train import checkpoint as RCK
from repro.train import compress as RGC
from repro.train import data as RD
from repro.train import optimizer as ROPT
from repro.train import train_lib as RTL
from repro_torch import configs as TCFG
from repro_torch.launch import elastic as TEL
from repro_torch.launch import train as TLT
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as TCK
from repro_torch.train import compress as TGC
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TOPT
from repro_torch.train import train_lib as TTL

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

CPU = "cpu"
ULP_TOL = 8
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _ulps(got, want) -> float:
    """max |got - want| in ulps of the largest |want| of the leaf, in the
    leaf's dtype (a bfloat16 ulp is 2^16 float32 ulps)."""
    g, w = (np.asarray(_np(x), np.float64) for x in (got, want))
    if not w.size:
        return 0.0
    ulp = float(np.spacing(np.float32(np.max(np.abs(w)))))
    if getattr(got, "dtype", None) == torch.bfloat16:
        ulp *= 2.0 ** 16
    return float(np.max(np.abs(g - w))) / ulp


def _leaves(tree):
    return [leaf for _, leaf in TT.named_leaves(tree)]


def _max_err(got_tree, want_tree) -> float:
    got, want = _leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    return max(float(np.max(np.abs(_np(g).astype(np.float64)
                                   - _np(w).astype(np.float64))))
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# optimizer and compressor on given gradients
# ---------------------------------------------------------------------------

def _opt_cfgs(**kw):
    return ROPT.OptimizerConfig(**kw), TOPT.OptimizerConfig(**kw)


def test_schedule_matches_reference():
    """Warmup, the cosine and the floor past total_steps, step by step."""
    rcfg, tcfg = _opt_cfgs(peak_lr=3e-4, warmup_steps=7, total_steps=50)
    steps = np.arange(60, dtype=np.int32)
    want = np.array([float(ROPT.schedule(rcfg, jnp.asarray(s)))
                     for s in steps], np.float32)
    got = TOPT.schedule(tcfg, torch.as_tensor(steps))
    assert got.dtype == torch.float32
    assert _ulps(got, want) <= ULP_TOL


def _given_tree(seed, bf16_key=None, scale=1.0):
    """A parameter-like tree with a stacked matrix, a vector and a matrix
    (optionally bfloat16) as (reference, port) trees."""
    rng = np.random.default_rng(seed)
    arrs = {"w": rng.standard_normal((2, 24, 16)),
            "b": rng.standard_normal((16,)),
            "e": rng.standard_normal((40, 12))}
    ref = {k: jnp.asarray((v * scale).astype(np.float32))
           for k, v in arrs.items()}
    port = {k: torch.as_tensor((v * scale).astype(np.float32))
            for k, v in arrs.items()}
    if bf16_key:
        ref[bf16_key] = ref[bf16_key].astype(jnp.bfloat16)
        port[bf16_key] = port[bf16_key].to(torch.bfloat16)
    return ref, port


@pytest.mark.parametrize("grad_scale", [0.01, 30.0],
                         ids=["unclipped", "clipped"])
def test_apply_updates_matches_reference(grad_scale):
    """Three AdamW steps on given gradients: the clip (a gradient norm
    above clip_norm or not), decay only on leaves of ndim >= 2, a
    bfloat16 leaf rounded after its float32 update; parameters, moments,
    lr and grad norm within ULP_TOL of the reference."""
    rcfg, tcfg = _opt_cfgs(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    rp, tp = _given_tree(0, bf16_key="e")
    rg, tg = _given_tree(1, scale=grad_scale)
    rs, ts = ROPT.init_state(rp), TOPT.init_state(tp)
    assert ts.step.dtype == torch.int32 and all(
        m.dtype == torch.float32 for m in _leaves(ts.mu))
    for _ in range(3):
        rp, rs, rm = ROPT.apply_updates(rcfg, rp, rg, rs)
        tp, ts, tm = TOPT.apply_updates(tcfg, tp, tg, ts)
        assert int(ts.step) == int(rs.step)
        assert tp["e"].dtype == torch.bfloat16
        for got, want in ((tm["lr"], rm["lr"]),
                          (tm["grad_norm"], rm["grad_norm"])):
            assert _ulps(got, want) <= ULP_TOL
        for got, want in ((tp, rp), (ts.mu, rs.mu), (ts.nu, rs.nu)):
            for k in want:
                assert _ulps(got[k], want[k]) <= ULP_TOL, k
    assert (float(rm["grad_norm"]) > rcfg.clip_norm) == (grad_scale > 1)


def test_weight_decay_only_on_matrices():
    """With a zero gradient only the decay moves a leaf: the [16] vector
    stays, the matrices shrink by lr * weight_decay."""
    _, tcfg = _opt_cfgs(peak_lr=1e-2, warmup_steps=0, total_steps=10)
    _, tp = _given_tree(2)
    zeros = TT.map_params(torch.zeros_like, tp)
    new, _, m = TOPT.apply_updates(tcfg, tp, zeros, TOPT.init_state(tp))
    assert torch.equal(new["b"], tp["b"])
    lr = float(m["lr"])
    for k in ("w", "e"):
        torch.testing.assert_close(new[k], tp[k] * (1 - lr * 0.1),
                                   rtol=1e-6, atol=0)


def test_compressor_matches_reference_exactly():
    """Three rounds of int8 error feedback: the int8 values, the scales
    and the carried residuals equal to the reference's in every bit;
    decompress too."""
    rg, tg = _given_tree(3, bf16_key="e")
    rs, ts = RGC.init_state(rg), TGC.init_state(tg)
    for _ in range(3):
        rv, rsc, rs = RGC.compress(rs, rg)
        tv, tsc, ts = TGC.compress(ts, tg)
        for k in rg:
            assert tv[k].dtype == torch.int8
            assert np.array_equal(_np(tv[k]), np.asarray(rv[k]))
            assert np.array_equal(_np(tsc[k]), np.asarray(rsc[k]))
            assert np.array_equal(_np(ts.residual[k]),
                                  np.asarray(rs.residual[k]))
        rd, td = RGC.decompress(rv, rsc), TGC.decompress(tv, tsc)
        assert all(np.array_equal(_np(td[k]), np.asarray(rd[k]))
                   for k in rg)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_file_dataset_equals_reference(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(5).integers(
        0, 1000, 10_007).astype(np.int32))
    kw = dict(vocab_size=1000, seq_len=33, global_batch=6, seed=3,
              path=str(path))
    rds, tds = RD.FileDataset(RD.DataConfig(**kw)), TD.FileDataset(
        TD.DataConfig(**kw))
    assert tds.n_windows == rds.n_windows
    for i in (0, 1, 17):
        got = tds.batch(i)["tokens"]
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(rds.batch(i)["tokens"]))
    it = TD.batches(TD.DataConfig(**kw), start_index=5)
    assert torch.equal(next(it)["tokens"], tds.batch(5)["tokens"])


def test_synthetic_batch_deterministic_and_replayable():
    """Batch i is a function of (seed, i): equal when drawn again or from
    `batches(start_index=i)`, different for another index or seed; every
    other token follows the one before it, (prev * 31 + 7) % V; the
    unigram is Zipf-like (token 0 the most frequent)."""
    cfg = TD.DataConfig(vocab_size=500, seq_len=64, global_batch=16, seed=1)
    b3 = TD.synthetic_batch(cfg, 3)["tokens"]
    assert b3.shape == (16, 64) and b3.dtype == torch.int32
    assert torch.equal(b3, TD.synthetic_batch(cfg, 3)["tokens"])
    it = TD.batches(cfg, start_index=3)
    assert torch.equal(next(it)["tokens"], b3)
    assert torch.equal(next(it)["tokens"],
                       TD.synthetic_batch(cfg, 4)["tokens"])
    assert not torch.equal(b3, TD.synthetic_batch(cfg, 4)["tokens"])
    assert not torch.equal(b3, TD.synthetic_batch(
        dataclasses.replace(cfg, seed=2), 3)["tokens"])
    t = b3.long()
    odd = torch.arange(63) % 2 == 1
    assert torch.equal(t[:, 1:][:, odd], ((t[:, :-1] * 31 + 7) % 500)[:, odd])
    free = torch.cat([t[:, :1], t[:, 1:][:, ~odd]], 1)
    counts = torch.bincount(free.flatten(), minlength=500)
    assert int(torch.argmax(counts)) == 0 and int(b3.min()) >= 0 \
        and int(b3.max()) < 500


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,))},
            "step": torch.tensor(3, dtype=torch.int32)}


def test_save_restore_roundtrip_async_and_clean(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    TCK.save(d, 3, tree)
    assert TCK.latest_step(d) == 3
    got = TCK.restore(d, 3, TT.map_params(torch.zeros_like, tree))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tree),
                                                 _leaves(got)))
    assert list(got) == list(tree)
    t = TCK.save(d, 5, tree, async_=True)
    t.join(timeout=60)
    assert not t.is_alive() and TCK.latest_step(d) == 5
    # a crash mid-write leaves a .tmp directory without a commit
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert TCK.latest_step(d) == 5
    assert TCK.clean_incomplete(d) == 1
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_keep_last_shape_mismatch_and_dtype_cast(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        TCK.save(d, s, _tree())
    TCK.keep_last(d, 2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000003", "step_00000004"]
    TCK.save(d, 7, {"w": torch.ones((4,))})
    with pytest.raises(ValueError, match="ckpt"):
        TCK.restore(d, 7, {"w": torch.zeros((5,))})
    got = TCK.restore(d, 7, {"w": torch.zeros((4,), dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and bool((got["w"] == 1).all())


@functools.lru_cache(maxsize=None)
def _states(compress):
    """A reference TrainState of the reduced smollm and the port's state
    over the same params, (reference, port)."""
    rcfg, tcfg = RCFG.get_reduced("smollm_360m"), TCFG.get_reduced(
        "smollm_360m")
    rtc = RTL.TrainConfig(compress_grads=compress)
    rs = RTL.init_state(rcfg, rtc, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, rs.params),
                              device=CPU)
    ts = TTL.TrainState(tp, TOPT.init_state(tp),
                        TGC.init_state(tp) if compress else None)
    return rs, ts


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressor"])
def test_leaf_names_equal_reference(compress):
    """The port names and orders a TrainState's leaves as the reference
    does (`params__groups__b0__attn__wq`, `opt__step`, `opt__mu__…`; no
    leaf for compressor=None)."""
    rs, ts = _states(compress)
    want, _, _ = RCK._leaf_paths(rs)
    got, leaves = TCK._leaf_paths(ts)
    assert got == want
    assert "opt__step" in got and "params__groups__b0__attn__wq" in got
    assert any(n.startswith("compressor__residual__") for n in got) \
        == compress
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(rs)]


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A port checkpoint of a float32 TrainState (int32 step) restores
    in the reference, leaf for leaf, and the manifest is the
    reference's."""
    rs, ts = _states(False)
    ts = ts._replace(opt=ts.opt._replace(step=torch.tensor(
        7, dtype=torch.int32)))
    TCK.save(str(tmp_path), 7, ts)
    got = RCK.restore(str(tmp_path), 7, rs)
    assert int(got.opt.step) == 7
    assert all(np.array_equal(np.asarray(a), _np(b)) for a, b in
               zip(jax.tree.leaves(got.params), _leaves(ts.params)))
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert [e["name"] for e in man["leaves"]] == RCK._leaf_paths(rs)[0]
    assert {e["dtype"] for e in man["leaves"]} == {"float32", "int32"}


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A reference checkpoint restores in the port: float32 and int32
    leaves, and bfloat16 ones (the reference writes them as '<V2', the
    port reads the words as bfloat16); a bfloat16 port checkpoint is
    written in the same layout, byte for byte."""
    d = str(tmp_path)
    rs, ts = _states(False)
    rs = rs._replace(opt=rs.opt._replace(step=jnp.asarray(4, jnp.int32)))
    RCK.save(d, 4, rs)
    got = TCK.restore(d, 4, ts)
    assert int(got.opt.step) == 4 and got.opt.step.dtype == torch.int32
    assert all(np.array_equal(np.asarray(a), _np(b)) for a, b in
               zip(jax.tree.leaves(rs), _leaves(got)))

    rng = np.random.default_rng(8)
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    ref_tree = {"w": jnp.asarray(vals).astype(jnp.bfloat16),
                "s": jnp.asarray(2, jnp.int32)}
    RCK.save(os.path.join(d, "ref"), 1, ref_tree)
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "s": torch.zeros((), dtype=torch.int32)}
    got = TCK.restore(os.path.join(d, "ref"), 1, like)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.as_tensor(vals).to(torch.bfloat16))
    TCK.save(os.path.join(d, "port"), 1, got)
    for name in ("w.npy", "s.npy", "manifest.json"):
        ref_bytes = (tmp_path / "ref" / "step_00000001" / name).read_bytes()
        assert (tmp_path / "port" / "step_00000001" / name).read_bytes() \
            == ref_bytes, name


def test_resume_plan(tmp_path):
    """resume_plan as the reference's, also over a reference checkpoint
    and after a crash left a .tmp directory."""
    d = str(tmp_path)
    assert TEL.resume_plan(d) is None
    TCK.save(d, 7, {"w": torch.zeros((2,))})
    assert TEL.resume_plan(d) == REL.resume_plan(d) == \
        {"restore_step": 7, "next_batch_index": 7}
    RCK.save(d, 9, {"w": jnp.zeros((2,))})
    os.makedirs(tmp_path / "step_00000011.tmp")
    assert TEL.resume_plan(d) == {"restore_step": 9, "next_batch_index": 9}
    assert not (tmp_path / "step_00000011.tmp").exists()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch):
    rcfg, tcfg = RCFG.get_reduced(arch), TCFG.get_reduced(arch)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = TT.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, rparams), device=CPU)
    return rcfg, tcfg, rparams, tparams


def _batch(cfg, B, S, seed=1):
    """Seeded tokens (and llava patches) as (reference, port) batches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patches":
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_125m",
                                  "llava_next_34b"])
def test_loss_and_grads_match_reference(arch):
    """loss_fn and every gradient leaf against jax.value_and_grad in
    float32 (xLSTM at S = 21, a partial mLSTM chunk; llava with its
    patch prefix and mask); the gradients are equal with and without
    remat (recomputation changes no value)."""
    rcfg, tcfg, rparams, tparams = _model(arch)
    rb, tb = _batch(tcfg, 2, 21)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b)))(rparams, rb)
    assert tcfg.remat
    loss, grads = TTL.value_and_grad(tcfg, tparams, tb)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL
    assert _max_err(grads, rgrads) <= GRAD_TOL
    _, no_remat = TTL.value_and_grad(
        dataclasses.replace(tcfg, remat=False), tparams, tb)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(grads),
                                                 _leaves(no_remat)))
    with torch.no_grad():
        assert torch.equal(TT.loss_fn(tcfg, tparams, tb), loss)


def test_patch_mask_follows_num_patches():
    """The mask covers cfg.num_patches target positions whatever the
    batch's patches, and divides by one row's targets, as the
    reference."""
    rcfg, tcfg, rparams, tparams = _model("llava_next_34b")
    rb, tb = _batch(tcfg, 2, 12, seed=4)
    rb.pop("patches"), tb.pop("patches")
    want = RT.loss_fn(rcfg, rparams, rb)
    with torch.no_grad():
        got = TT.loss_fn(tcfg, tparams, tb)
        logits = TT.forward(tcfg, tparams, tb)[:, :-1].float()
    assert abs(float(got) - float(want)) <= LOSS_TOL
    ce = torch.nn.functional.cross_entropy(
        logits.transpose(1, 2), tb["tokens"][:, 1:].long(),
        reduction="none")
    P = tcfg.num_patches
    assert torch.allclose(got, ce[:, P:].sum() / (ce.shape[1] - P),
                          rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step, crash and resume, the CLI
# ---------------------------------------------------------------------------

def _tiny(pkg):
    return dataclasses.replace(
        pkg.get_reduced("smollm_360m"), num_layers=2, d_model=32,
        num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=128)


@pytest.mark.parametrize("mb,compress", [(1, False), (4, False), (4, True)],
                         ids=["mb1", "mb4", "mb4-compressor"])
def test_train_step_matches_reference(mb, compress):
    """One train step from the same state on the same batch: loss, lr,
    grad norm, parameters, moments and the compressor's residuals."""
    rcfg, tcfg = _tiny(RCFG), _tiny(TCFG)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20)
    rtc = RTL.TrainConfig(opt=ROPT.OptimizerConfig(**kw), microbatches=mb,
                          compress_grads=compress)
    ttc = TTL.TrainConfig(opt=TOPT.OptimizerConfig(**kw), microbatches=mb,
                          compress_grads=compress)
    rs = RTL.init_state(rcfg, rtc, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, rs.params),
                              device=CPU)
    ts = TTL.TrainState(tp, TOPT.init_state(tp),
                        TGC.init_state(tp) if compress else None)
    batch = RD.synthetic_batch(RD.DataConfig(vocab_size=128, seq_len=32,
                                             global_batch=4), 0)
    rs, rm = jax.jit(RTL.make_train_step(rcfg, rtc))(rs, batch)
    ts, tm = TTL.make_train_step(tcfg, ttc)(
        ts, {"tokens": torch.tensor(np.asarray(batch["tokens"]))})
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert float(tm["lr"]) == float(rm["lr"])
    assert abs(float(tm["grad_norm"]) / float(rm["grad_norm"]) - 1) <= 1e-5
    assert _max_err(ts.params, rs.params) <= 2e-5
    assert _max_err(ts.opt.mu, rs.opt.mu) <= 1e-7
    assert _max_err(ts.opt.nu, rs.opt.nu) <= 1e-7
    if compress:
        assert _max_err(ts.compressor.residual, rs.compressor.residual) \
            <= 2e-6
    assert int(ts.opt.step) == 1


def _run(cfg, tcfg, dcfg, steps, state, start=0):
    step = TTL.make_train_step(cfg, tcfg)
    losses = []
    for _, batch in zip(range(steps), TD.batches(dcfg, start_index=start)):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def test_crash_resume_matches_uninterrupted(tmp_path):
    """10 steps straight against 5 + checkpoint + restore into a fresh
    state + 5: the same loss trajectory (the reference's bound, rtol
    2e-4; on one CPU the two are equal)."""
    cfg = _tiny(TCFG)
    tcfg = TTL.TrainConfig(opt=TOPT.OptimizerConfig(
        peak_lr=1e-2, warmup_steps=2, total_steps=20))
    dcfg = TD.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)
    init = lambda seed: TTL.init_state(
        cfg, tcfg, torch.Generator().manual_seed(seed), device=CPU)
    _, straight = _run(cfg, tcfg, dcfg, 10, init(0))
    s1, first = _run(cfg, tcfg, dcfg, 5, init(0))
    TCK.save(str(tmp_path), 5, s1)
    s2 = TCK.restore(str(tmp_path), 5, init(99))        # a fresh process
    _, second = _run(cfg, tcfg, dcfg, 5, s2, start=5)
    np.testing.assert_allclose(straight, first + second, rtol=2e-4)
    assert straight[-1] < straight[0]


def test_injected_failure_cli(tmp_path):
    """launch/train.py --fail-at-step crashes, then --resume auto
    completes the run from the last checkpoint: the resumed losses equal
    an uninterrupted run's, the last three checkpoints are kept."""
    argv = ["--arch", "smollm-360m", "--steps", "8", "--batch", "2",
            "--seq", "32", "--log-every", "100", "--device", "cpu"]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(RuntimeError, match="injected failure"):
        TLT.main(argv + ck + ["--fail-at-step", "5"])
    assert TCK.latest_step(str(tmp_path)) == 4
    result = TLT.main(argv + ck + ["--resume", "auto"])
    assert result["start_step"] == 4 and result["steps_run"] == 4
    straight = TLT.main(argv)
    np.testing.assert_allclose(straight["losses"][4:], result["losses"],
                               rtol=2e-4)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000004", "step_00000006", "step_00000008"]
    assert TLT.get_cfg("xlstm-125m", None) == TCFG.get_reduced("xlstm_125m")
    assert TLT.get_cfg("smollm-360m", "train_100m").name == "smollm-100m"
