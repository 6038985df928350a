"""The port's MLA, MoE, hybrid (RG-LRU with local attention), xLSTM,
whisper and llava families against the JAX reference.

On the reduced minicpm3, deepseek-moe, qwen3-moe, recurrentgemma, xlstm,
whisper and llava configs (float32) the reference's random parameter
tree is carried across (`params_from_numpy`) and `forward`, `prefill`
(logits and every cache leaf) and greedy `decode_step`s run on the same
tokens (and the same seeded random whisper frames or llava patches) in
both engines: max |port − reference| ≤ TOL = 1e-4 on values of
magnitude ~1 (float32 rounding: XLA and PyTorch sum in other orders, and
the port's RG-LRU scan combines in another order than
`lax.associative_scan`).  MoE
routing is held exactly: expert ids and the dispatch `keep` mask,
including a capacity that drops slots and probabilities that tie.  The
layers are held function by function, and one bfloat16 forward per
family within `BF16_REL_TOL` with a control that must exceed it.

The reference's programs compile without XLA's optimization passes
(`_unoptimized_reference_compiles` in tests/torch_fixtures.py), which cuts
their compile time about fourfold; the float32 results stay within TOL,
and the bfloat16 readings are printed by `python
tests/test_torch_lm_families.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCFG
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import rglru as RRG
from repro.models import serve as RSV
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro_torch import configs as TCFG
from repro_torch.launch import serve as TLS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TRG
from repro_torch.models import serve as TSV
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models.config import check_supported

from test_torch_core import n_
from test_torch_lm import BF16_REL_TOL, _rel_err, _with_bumped
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

CPU = "cpu"
TOL = 1e-4
FAMILIES = ("minicpm3_4b", "deepseek_moe_16b", "qwen3_moe_30b_a3b",
            "recurrentgemma_9b", "xlstm_125m", "whisper_base",
            "llava_next_34b")
# one bfloat16 forward per family (MLA, MoE, hybrid, ssm, audio, vlm)
BF16_FAMILIES = ("minicpm3_4b", "deepseek_moe_16b", "recurrentgemma_9b",
                 "xlstm_125m", "whisper_base", "llava_next_34b")


@functools.lru_cache(maxsize=None)
def _model(arch, bf16=False):
    """(reference config, port config, reference params, port params) of
    a reduced config, the same weights in both."""
    rcfg, tcfg = RCFG.get_reduced(arch), TCFG.get_reduced(arch)
    if bf16:
        rcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16",
                                          dtype="bfloat16")
                      for c in (rcfg, tcfg))
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = TT.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, rparams), device=CPU)
    return rcfg, tcfg, rparams, tparams


@functools.lru_cache(maxsize=None)
def _ref_fns(arch):
    """The reference's forward, prefill and decode_step, jitted once."""
    rcfg = _model(arch)[0]
    return (jax.jit(functools.partial(RT.forward, rcfg)),
            jax.jit(functools.partial(RSV.prefill, rcfg),
                    static_argnames="T_max"),
            jax.jit(functools.partial(RSV.decode_step, rcfg)))


def _batch(cfg, B, S, seed=1):
    """Seeded tokens (and whisper frames or llava patches) as (reference,
    port) batches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "frames":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    err = float(np.max(np.abs(n_(got).astype(np.float64)
                              - np.asarray(want, np.float64))))
    assert err <= tol, err
    return err


def _close_trees(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k])
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert got[k].dtype == torch.float32, k
            _close(got[k], want[k])


def _jit(fn, cfg):
    """A reference layer fn(params, cfg, *args), jitted over the rest
    (eager JAX compiles every op at every shape)."""
    return jax.jit(lambda p, *a: fn(p, cfg, *a))


def _layer0(arch, block="b0"):
    rcfg, tcfg, rparams, tparams = _model(arch)
    return (rcfg, tcfg, jax.tree.map(lambda a: a[0], rparams["groups"][block]),
            TT.group_params(tparams["groups"][block], 0))


# ---------------------------------------------------------------------------
# support
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_full_configs_supported(arch):
    """Every family runs at its full config, xLSTM and llava included;
    an unknown family raises."""
    cfg = TCFG.get_config(arch)
    check_supported(cfg)
    with pytest.raises(NotImplementedError, match="unknown family"):
        check_supported(dataclasses.replace(cfg, family="unknown"))


# ---------------------------------------------------------------------------
# each family end to end against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_reference(arch):
    """forward, prefill (logits and every cache leaf, float32 where the
    reference keeps float32) and 3 greedy decode steps (the same tokens,
    logits and caches) within TOL of the reference; the last logits
    within 2e-2 of the port's forward over the grown sequence (the
    reference's tests/test_serve.py bound)."""
    rcfg, tcfg, rparams, tparams = _model(arch)
    r_fwd, r_prefill, r_decode = _ref_fns(arch)
    B, S, gen = 2, 24, 3
    rb, tb = _batch(tcfg, B, S)
    got = TT.forward(tcfg, tparams, tb)
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, r_fwd(rparams, rb))

    rl, rc = r_prefill(rparams, rb, T_max=S + gen)
    tl, tc = TSV.prefill(tcfg, tparams, tb, T_max=S + gen)
    _close(tl, rl)
    _close_trees(tc["blocks"], rc["blocks"])
    assert isinstance(tc["pos"], torch.Tensor) and int(tc["pos"]) == S
    shapes = {k: {n: tuple(v.shape) for n, v in c.items()}
              for k, c in TSV.init_cache(tcfg, B, S + gen,
                                         device=CPU)["blocks"].items()}
    assert shapes == {k: {n: tuple(v.shape) for n, v in c.items()}
                      for k, c in tc["blocks"].items()}

    grown = tb["tokens"]
    for _ in range(gen):
        rn = jnp.argmax(rl, -1).astype(jnp.int32)
        tn = torch.argmax(tl, -1).to(torch.int32)
        assert np.array_equal(n_(tn), np.asarray(rn))
        grown = torch.cat([grown, tn[:, None]], 1)
        rl, rc = r_decode(rparams, rc, rn)
        tl, tc = TSV.decode_step(tcfg, tparams, tc, tn)
        _close(tl, rl)
    _close_trees(tc["blocks"], rc["blocks"])
    assert int(tc["pos"]) == S + gen
    full = TT.forward(tcfg, tparams, {**tb, "tokens": grown})[:, -1]
    _close(tl, full.numpy(), 2e-2)


@pytest.mark.parametrize("S", [8, 24], ids=["below-window", "past-window"])
def test_local_ring_buffer_beyond_window(S):
    """recurrentgemma (window 16) prefilled below and past the window,
    then 20 greedy steps past it: every step's logits within TOL of the
    reference (the ring slots `pos % W`, the mask of slots below
    position 0), and the cache never grows."""
    rcfg, tcfg, rparams, tparams = _model("recurrentgemma_9b")
    _, r_prefill, r_decode = _ref_fns("recurrentgemma_9b")
    rb, tb = _batch(tcfg, 1, S, seed=7)
    rl, rc = r_prefill(rparams, rb, T_max=S)
    tl, tc = TSV.prefill(tcfg, tparams, tb, T_max=S)
    _close(tl, rl)
    _close_trees(tc["blocks"], rc["blocks"])
    for _ in range(20):
        tok = torch.argmax(tl, -1).to(torch.int32)
        rl, rc = r_decode(rparams, rc, jnp.asarray(n_(tok)))
        tl, tc = TSV.decode_step(tcfg, tparams, tc, tok)
        _close(tl, rl)
    assert tc["blocks"]["b2"]["k"].shape[2] == tcfg.window
    _close_trees(tc["blocks"], rc["blocks"])


# ---------------------------------------------------------------------------
# MoE routing and dispatch
# ---------------------------------------------------------------------------

def _ref_keep(idx, E, C):
    """The reference's dispatch positions (`_moe_apply_global`, the
    cumsum per routing slot), written out: it has no function of its
    own for them."""
    T, k = idx.shape
    pos = jnp.zeros((T, k), jnp.int32)
    counts = jnp.zeros((E,), jnp.int32)
    for j in range(k):
        oh = jax.nn.one_hot(idx[:, j], E, dtype=jnp.int32)
        pos_j = jnp.cumsum(oh, axis=0) - 1 + counts[None, :]
        pos = pos.at[:, j].set(jnp.take_along_axis(
            pos_j, idx[:, j][:, None], axis=1)[:, 0])
        counts = counts + jnp.sum(oh, axis=0)
    return np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("arch,cf,ties", [
    ("deepseek_moe_16b", None, False), ("qwen3_moe_30b_a3b", None, False),
    ("deepseek_moe_16b", 0.5, False), ("qwen3_moe_30b_a3b", 8.0, True)],
    ids=["deepseek", "qwen3", "deepseek-drops", "ties"])
def test_route_and_dispatch_match_reference(arch, cf, ties):
    """Expert ids, dispatch positions and the keep mask exactly equal to
    the reference's (slot-major cumsum); gates and the layer's output
    within TOL.  `cf` lowers the capacity so slots drop; `ties` zeroes
    the router, so every probability ties and the lower ids win, as
    `jax.lax.top_k` orders them."""
    rcfg, tcfg, rp, tp = _layer0(arch)
    rp, tp = rp["moe"], tp["moe"]
    if cf is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    if ties:
        rp = {**rp, "router": jnp.zeros_like(rp["router"])}
        tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _rand(4, 12, tcfg.d_model, seed=11)
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    ridx, rgates = jax.jit(functools.partial(RMOE.route, rcfg))(
        rp["router"], jnp.asarray(xf))
    tidx, tgates = TMOE.route(tcfg, tp["router"], torch.as_tensor(xf))
    assert tidx.dtype == torch.int32
    assert np.array_equal(n_(tidx), np.asarray(ridx))
    _close(tgates, rgates, 1e-6)
    if ties:
        assert np.array_equal(n_(tidx), np.tile(
            np.arange(tcfg.experts_per_token), (T, 1)))

    C = TMOE._capacity(tcfg, T)
    assert C == RMOE._capacity(rcfg, T)
    pos, keep, slot = TMOE._dispatch(tidx, tcfg.num_experts, C)
    rpos, rkeep = _ref_keep(ridx, rcfg.num_experts, C)
    assert np.array_equal(n_(pos), rpos) and np.array_equal(n_(keep), rkeep)
    assert (cf == 0.5) == (not rkeep.all())            # drops where meant
    assert np.array_equal(n_(slot)[rkeep], (np.asarray(ridx) * C
                                            + rpos)[rkeep])
    _close(TMOE.moe_apply(tp, tcfg, torch.as_tensor(x)),
           jax.jit(lambda p, v: RMOE._moe_apply_global(p, rcfg, v))(
               rp, jnp.asarray(x)))
    _close(TMOE.load_balance_loss(tcfg, tp["router"], torch.as_tensor(x)),
           RMOE.load_balance_loss(rcfg, rp["router"], jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------------------------
# the layers, function by function
# ---------------------------------------------------------------------------

def test_mla_functions_match_reference():
    """mla_latent (the decode cache), mla_queries and mla_apply (dk = hd
    + rd, dv = hd) on the reduced minicpm3's first layer."""
    rcfg, tcfg, rp, tp = _layer0("minicpm3_4b")
    rp, tp = rp["attn"], tp["attn"]
    x = _rand(2, 20, tcfg.d_model, seed=3)
    pos = np.arange(5, 25)
    rx, tx = jnp.asarray(x), torch.as_tensor(x)
    for rv, tv in zip(_jit(RL.mla_latent, rcfg)(rp, rx, jnp.asarray(pos)),
                      TL.mla_latent(tp, tcfg, tx, torch.as_tensor(pos))):
        _close(tv, rv)
    for rv, tv in zip(_jit(RL.mla_queries, rcfg)(rp, rx, jnp.asarray(pos)),
                      TL.mla_queries(tp, tcfg, tx, torch.as_tensor(pos))):
        _close(tv, rv)
    _close(TL.mla_apply(tp, tcfg, tx), _jit(RL.mla_apply, rcfg)(rp, rx))


def test_rglru_functions_match_reference():
    """_gates, _conv_causal, rglru_scan (another combine order: float32
    rounding), rglru_step, block_apply and block_step, with the gate
    weights and biases drawn at random (their init is zero)."""
    rcfg, tcfg, rp, tp = _layer0("recurrentgemma_9b")
    w = tcfg.lru_width
    extra = {k: _rand(w, seed=20 + i) for i, k in enumerate(
        ("gate_a", "gate_x", "bias_a", "bias_x"))}
    rp = {**rp["rec"], **{k: jnp.asarray(v) for k, v in extra.items()}}
    tp = {**tp["rec"], **{k: torch.as_tensor(v) for k, v in extra.items()}}
    u = _rand(2, 37, w, seed=4)
    for rv, tv in zip(jax.jit(RRG._gates)(rp, jnp.asarray(u)),
                      TRG._gates(tp, torch.as_tensor(u))):
        _close(tv, rv)
    _close(TRG._conv_causal(tp, torch.as_tensor(u), tcfg),
           jax.jit(lambda p, v: RRG._conv_causal(p, v, rcfg))(
               rp, jnp.asarray(u)))
    _close(TRG.rglru_scan(tp, torch.as_tensor(u)),
           jax.jit(RRG.rglru_scan)(rp, jnp.asarray(u)))
    h = _rand(2, w, seed=5)
    for rv, tv in zip(jax.jit(RRG.rglru_step)(rp, jnp.asarray(u[:, 0]),
                                              jnp.asarray(h)),
                      TRG.rglru_step(tp, torch.as_tensor(u[:, 0]),
                                     torch.as_tensor(h))):
        _close(tv, rv)
    x = _rand(2, 9, tcfg.d_model, seed=6)
    _close(TRG.block_apply(tp, tcfg, torch.as_tensor(x)),
           _jit(RRG.block_apply, rcfg)(rp, jnp.asarray(x)))
    conv = _rand(2, tcfg.conv_width - 1, w, seed=8)
    ry, rst = _jit(RRG.block_step, rcfg)(
        rp, jnp.asarray(x[:, 0]),
        RRG.RecurrentState(jnp.asarray(conv), jnp.asarray(h)))
    ty, tst = TRG.block_step(tp, tcfg, torch.as_tensor(x[:, 0]),
                             TRG.RecurrentState(torch.as_tensor(conv),
                                                torch.as_tensor(h)))
    _close(ty, ry)
    _close(tst.conv, rst.conv, 0)
    _close(tst.h, rst.h)
    st = TRG.init_state(tcfg, 3, torch.bfloat16)
    rst0 = RRG.init_state(rcfg, 3, jnp.bfloat16)
    assert st.conv.shape == rst0.conv.shape and st.conv.dtype == \
        torch.bfloat16 and st.h.dtype == torch.float32


def _state_close(got, want):
    for name in want._fields:
        assert getattr(got, name).dtype == torch.float32, name
        _close(getattr(got, name), getattr(want, name))


def test_mlstm_functions_match_reference():
    """mlstm_chunkwise (chunk 8) over 13 tokens from the zero state, then
    over 8 more from the state it carried (a padded last chunk both
    times: i = -1e30, log f = 0), its outputs and states against the
    reference; one call over all 21 tokens equal to the two; mlstm_step
    token by token against the chunkwise form and the reference's step;
    the block step."""
    rcfg, tcfg, rp, tp = _layer0("xlstm_125m", "b0")
    rp, tp = rp["cell"], tp["cell"]
    assert tcfg.pattern[0] == "mlstm" and tcfg.attn_chunk == 8
    u = _rand(2, 21, 2 * tcfg.d_model, seed=30)
    r_chunk = jax.jit(lambda p, v, st: RX.mlstm_chunkwise(
        p, rcfg, v, st, chunk=rcfg.attn_chunk))
    chunk = lambda v, st=None: TX.mlstm_chunkwise(
        tp, tcfg, torch.as_tensor(v), st, chunk=tcfg.attn_chunk)
    rh1, rst1 = r_chunk(rp, jnp.asarray(u[:, :13]), None)
    th1, tst1 = chunk(u[:, :13])
    _close(th1, rh1)
    _state_close(tst1, rst1)
    rh2, rst2 = r_chunk(rp, jnp.asarray(u[:, 13:]), rst1)
    th2, tst2 = chunk(u[:, 13:], tst1)
    _close(th2, rh2)
    _state_close(tst2, rst2)
    th, tst = chunk(u)
    _close(th, torch.cat([th1, th2], 1).numpy())
    _state_close(tst, tst2)

    r_step = _jit(RX.mlstm_step, rcfg)
    st = TX.init_mlstm_state(tcfg, 2, u.shape[-1])
    rst = RX.init_mlstm_state(rcfg, 2, u.shape[-1])
    for t in range(u.shape[1]):
        h_t, st = TX.mlstm_step(tp, tcfg, torch.as_tensor(u[:, t]), st)
        _close(h_t, th[:, t].numpy())
        if t < 3:
            rh_t, rst = r_step(rp, jnp.asarray(u[:, t]), rst)
            _close(h_t, rh_t)
            _state_close(st, rst)
    _state_close(st, tst)
    x = _rand(2, tcfg.d_model, seed=31)
    ry, rnew = _jit(RX.mlstm_block_step, rcfg)(rp, jnp.asarray(x), rst2)
    ty, tnew = TX.mlstm_block_step(tp, tcfg, torch.as_tensor(x), tst2)
    _close(ty, ry)
    _state_close(tnew, rnew)


def test_slstm_functions_match_reference():
    """slstm_scan from the zero state and from a given one, the block's
    forward and its one-token step against the reference; every state
    leaf float32."""
    rcfg, tcfg, rp, tp = _layer0("xlstm_125m", "b1")
    rp, tp = rp["cell"], tp["cell"]
    assert tcfg.pattern[1] == "slstm"
    d = tcfg.d_model
    x = _rand(2, 9, d, seed=32)
    r_scan = jax.jit(lambda p, v, st: RX.slstm_scan(p, rcfg, v, st))
    rh, rst = r_scan(rp, jnp.asarray(x), None)
    th, tst = TX.slstm_scan(tp, tcfg, torch.as_tensor(x))
    _close(th, rh)
    _state_close(tst, rst)
    given = [_rand(2, d, seed=33 + i) for i in range(4)]
    given[2] = np.abs(given[2]) + 0.5                      # n > 0
    rh, rst = r_scan(rp, jnp.asarray(x), RX.SLstmState(
        *map(jnp.asarray, given)))
    th, tst = TX.slstm_scan(tp, tcfg, torch.as_tensor(x), TX.SLstmState(
        *map(torch.as_tensor, given)))
    _close(th, rh)
    _state_close(tst, rst)
    _close(TX.slstm_block_apply(tp, tcfg, torch.as_tensor(x)),
           _jit(RX.slstm_block_apply, rcfg)(rp, jnp.asarray(x)))
    ry, rnew = _jit(RX.slstm_block_step, rcfg)(rp, jnp.asarray(x[:, 0]),
                                                rst)
    ty, tnew = TX.slstm_block_step(tp, tcfg, torch.as_tensor(x[:, 0]), tst)
    _close(ty, ry)
    _state_close(tnew, rnew)


def test_encoder_and_cross_step_match_reference():
    """whisper: `_encode` over random frames (causal, as the reference),
    the cross attention's decode step against a random encoder cache,
    and the local step at a position past its window."""
    rcfg, tcfg, rparams, tparams = _model("whisper_base")
    frames = _rand(2, tcfg.encoder_seq, tcfg.d_model, seed=9)
    enc = TT._encode(tcfg, tparams, torch.as_tensor(frames))
    _close(enc, jax.jit(functools.partial(RT._encode, rcfg))(
        rparams, jnp.asarray(frames)))
    # a causal encoder: the first frame's output ignores the later ones
    frames2 = frames.copy()
    frames2[:, 1:] += 1.0
    _close(TT._encode(tcfg, tparams, torch.as_tensor(frames2))[:, 0],
           enc[:, 0].numpy(), 1e-6)

    _, _, rp, tp = _layer0("whisper_base")
    x = _rand(2, tcfg.d_model, seed=10)
    ck, cv = (_rand(2, 7, tcfg.num_kv_heads, tcfg.hd, seed=s)
              for s in (12, 13))
    _close(TSV._cross_step(tp["cross"], tcfg, torch.as_tensor(x),
                           {"ck": torch.as_tensor(ck),
                            "cv": torch.as_tensor(cv)}),
           RSV._cross_step(rp["cross"], rcfg, jnp.asarray(x),
                           {"ck": jnp.asarray(ck), "cv": jnp.asarray(cv)}))

    rcfg, tcfg, rp, tp = _layer0("recurrentgemma_9b", "b2")
    W = tcfg.window
    k, v = (_rand(2, W, tcfg.num_kv_heads, tcfg.hd, seed=s)
            for s in (14, 15))
    x = _rand(2, tcfg.d_model, seed=16)
    for p in (3, W + 5):
        ro, rc = RSV._local_step(rp["attn"], rcfg, jnp.asarray(x),
                                 {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                 jnp.asarray(p, jnp.int32))
        to, tc = TSV._local_step(tp["attn"], tcfg, torch.as_tensor(x),
                                 {"k": torch.as_tensor(k),
                                  "v": torch.as_tensor(v)},
                                 torch.tensor(p, dtype=torch.int32))
        _close(to, ro)
        _close(tc["k"], rc["k"])


# ---------------------------------------------------------------------------
# bfloat16, float32 leaves, serve_requests
# ---------------------------------------------------------------------------

def _bf16_readings(arch) -> dict:
    """The bfloat16 logits of the port against the reference's forward
    run eagerly op by op (scan_layers=False, every op rounded to
    bfloat16, as the port), max |port − reference| / max |reference|;
    the control raises the port's final norm scale by 100 bfloat16 ulps.
    The reference's scanned stack is no reference here: it fuses ops and
    drops roundings, and on the reduced deepseek-moe that moves one
    token's top-2 experts (a near tie), ~0.47 from its own op-by-op run."""
    rcfg, tcfg, rparams, tparams = _model(arch, True)
    rb, tb = _batch(tcfg, 2, 16)
    op_by_op = RT.forward(dataclasses.replace(rcfg, scan_layers=False),
                          rparams, rb)
    tb = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
          for k, v in tb.items()}
    run = lambda: TT.forward(tcfg, tparams, tb)
    got = run()
    assert got.dtype == torch.bfloat16
    return {"forward_vs_op_by_op": _rel_err(got, op_by_op),
            "forward_control": _rel_err(
                _with_bumped(tparams["final_norm"]["scale"], run),
                op_by_op)}


@pytest.mark.parametrize("arch", BF16_FAMILIES)
def test_bf16_forward_matches_reference(arch):
    """One bfloat16 forward per family within BF16_REL_TOL of the
    reference run op by op, with a control above it; the leaves the
    reference keeps in float32 (MoE router, RG-LRU gates, the `h` cache)
    stay float32."""
    r = _bf16_readings(arch)
    assert r["forward_vs_op_by_op"] <= BF16_REL_TOL < r["forward_control"], r
    _, tcfg, _, tparams = _model(arch, True)
    g = tparams["groups"]
    if tcfg.num_experts:
        assert g["b0"]["moe"]["router"].dtype == torch.float32
        assert g["b0"]["moe"]["experts_wi"].dtype == torch.bfloat16
    if "mlstm" in tcfg.pattern:
        for k in ("w_if", "b_if"):
            assert g["b0"]["cell"][k].dtype == torch.float32
        for k in ("r_h", "bias"):
            assert g["b1"]["cell"][k].dtype == torch.float32
        assert g["b0"]["cell"]["wq"].dtype == torch.bfloat16
        cache = TSV.init_cache(tcfg, 1, 4, device=CPU)["blocks"]
        assert all(v.dtype == torch.float32 for c in cache.values()
                   for v in c.values())
        assert bool((cache["b0"]["m"] == -1e30).all())
    if "rglru" in tcfg.pattern:
        assert g["b0"]["rec"]["lam"].dtype == torch.float32
        assert g["b0"]["rec"]["w_in"].dtype == torch.bfloat16
        cache = TSV.init_cache(tcfg, 1, 4, device=CPU)["blocks"]["b0"]
        assert cache["h"].dtype == torch.float32
        assert cache["conv"].dtype == torch.bfloat16
    own = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                         device=CPU)
    assert TT.map_params(lambda a: (a.dtype, a.shape), own) == \
        TT.map_params(lambda a: (a.dtype, a.shape), tparams)


def test_serve_requests_feeds_frames():
    """launch/serve on reduced whisper: zero frames by default (the
    reference CLI's), given frames per request otherwise (the tail batch
    padded); `--arch whisper-base` runs from the CLI."""
    _, cfg, _, params = _model("whisper_base")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 6))
    frames = torch.as_tensor(_rand(3, cfg.encoder_seq, cfg.d_model, seed=2))
    out = TLS.serve_requests(cfg, params, prompts, batch=2, gen=2,
                             frames=frames)
    one = TLS.serve_requests(cfg, params, prompts[2:], batch=1, gen=2,
                             frames=frames[2:])
    assert np.array_equal(out["tokens"][2:], one["tokens"])
    zero = TLS.serve_requests(cfg, params, prompts[:1], batch=1, gen=2)
    want = TLS.serve_requests(cfg, params, prompts[:1], batch=1, gen=2,
                              frames=torch.zeros_like(frames[:1]))
    assert np.array_equal(zero["tokens"], want["tokens"])
    res = TLS.main(["--arch", "whisper-base", "--device", "cpu",
                    "--requests", "2", "--batch", "2", "--prompt-len", "4",
                    "--gen", "2"])
    assert res["tokens_generated"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_matches_cpu(arch):
    """The reduced family on the card against the CPU (float32): prefill
    logits and one decode step within TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cfg, _, params = _model(arch)
    cuda = TT.map_params(lambda a: a.to("cuda"), params)
    _, tb = _batch(cfg, 2, 16)
    want, cw = TSV.prefill(cfg, params, tb, T_max=20)
    got, cg = TSV.prefill(cfg, cuda, {k: v.cuda() for k, v in tb.items()},
                          T_max=20)
    _close(got.cpu(), want.numpy())
    nxt = torch.argmax(want, -1).to(torch.int32)
    want2, _ = TSV.decode_step(cfg, params, cw, nxt)
    got2, _ = TSV.decode_step(cfg, cuda, cg, nxt.cuda())
    _close(got2.cpu(), want2.numpy())


if __name__ == "__main__":
    import json
    jax.config.update("jax_disable_most_optimizations", True)  # as pytest
    torch.set_num_threads(1)
    for arch in BF16_FAMILIES:
        print(json.dumps({"arch": arch, **_bf16_readings(arch)}))
