"""The port's LM serve path (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.launch.serve`) against the JAX reference, and the encrypted
top-k bridge of `examples/secure_topk_serving.py`.

Configs must equal the reference's field for field.  On
`smollm_360m.reduced()` (float32, 2 layers, d = 60) the reference's
random parameter tree is carried across (`params_from_numpy`) and
`forward`, `prefill` and `decode_step` run on the same tokens in both
engines.  Tolerance: max |port − reference| ≤ 1e-4 on logits of
magnitude ~1 (float32; the reference runs under x64, so its RoPE
positions are int64 before the float32 cast, and XLA and PyTorch sum
the matmuls in different orders — both are float32 rounding, nothing
more); greedy tokens must be equal.  Reduced internlm2 and minitron
(the same dense GQA code at other widths) take the float32 forward
check; all three take the bfloat16 checks (`BF16_BLOCK_TOL`,
`BF16_REL_TOL`).  Run as a script, the file prints those checks'
readings.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCFG
from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.core import ring as RR
from repro.core.ckks import equality_tolerance as ref_tolerance
from repro.core.keys import KeySet as RefKeySet
from repro.core.params import make_params as ref_make_params
from repro.models import layers as RL
from repro.models import serve as RSV
from repro.models import transformer as RT
from repro_torch import configs as TCFG
from repro_torch.core import compare as TC
from repro_torch.core import encrypt as TE
from repro_torch.core.ckks import equality_tolerance
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import make_params as torch_make_params
from repro_torch.launch import serve as TLS
from repro_torch.models import layers as TL
from repro_torch.models import serve as TSV
from repro_torch.models import transformer as TT
from repro_torch.models.config import check_supported

from test_torch_core import ct_to_torch, jitted_ref, n_
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)


CPU = "cpu"
TOL = 1e-4
ARCH = "smollm_360m"


def _cfg_dict(cfg):
    return dataclasses.asdict(cfg)


# reduced dense GQA configs besides smollm: the same code, other widths
DENSE_ARCHS = ("internlm2_20b", "minitron_8b")
# bfloat16, port against reference, both on the CPU, as max |port -
# reference| / max |reference| (`python tests/test_torch_lm.py` prints
# every reading).  One block: 0.0051, one bfloat16 ulp of the output,
# since torch's fused silu rounds once where jax.nn.silu rounds after
# each of its steps.  The forward's logits: 0.0107 (smollm) and 0.0117
# (internlm2, minitron); the reference's own scanned stack is 0.0107 and
# 0.0098 from its stack run op by op (scan_layers=False), as XLA fuses
# the scanned block and drops roundings.  Each limit is ~10x its
# reading, and each control (a norm's first scale raised by 100 bfloat16
# ulps) reads above it: 0.14-0.17 for the block, 0.12-0.18 the forward.
BF16_BLOCK_TOL = 0.05
BF16_REL_TOL = 0.1


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16", dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _model(arch, bf16):
    """(reference config, port config, reference params, port params) of
    a reduced config, in float32 or bfloat16, the same weights in both."""
    rcfg, tcfg = RCFG.get_reduced(arch), TCFG.get_reduced(arch)
    if bf16:
        rcfg, tcfg = _bf16(rcfg), _bf16(tcfg)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = TT.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, rparams), device=CPU)
    return rcfg, tcfg, rparams, tparams


@pytest.fixture(scope="module")
def model():
    """The reduced smollm config, the reference's params and the same
    params carried into the port."""
    return _model(ARCH, False)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    err = float(np.max(np.abs(n_(got).astype(np.float64)
                              - np.asarray(want, np.float64))))
    assert err <= tol, err
    return err


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_configs_equal_reference(arch):
    """CONFIG and reduced() equal the reference's field for field, and
    the analytic parameter counts agree."""
    assert TCFG.ARCH_IDS == RCFG.ARCH_IDS
    for get in ("get_config", "get_reduced"):
        rc, tc = getattr(RCFG, get)(arch), getattr(TCFG, get)(arch)
        assert _cfg_dict(tc) == _cfg_dict(rc)
        assert tc.param_count() == rc.param_count()
        assert tc.active_param_count() == rc.active_param_count()
        assert (tc.hd, tc.group_size, tc.sub_quadratic) == \
            (rc.hd, rc.group_size, rc.sub_quadratic)


@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_unported_families_raise(arch):
    """Every family of the reference is admitted by every entry point
    (its reduced config runs init_params, init_cache, forward, prefill,
    decode_step and loss_fn on the CPU); the same config under an unknown
    family raises NotImplementedError from each of them."""
    cfg = TCFG.get_reduced(arch)
    check_supported(cfg)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    batch = {"tokens": torch.as_tensor(_tokens(cfg, 1, 6))}
    if cfg.frontend == "frames":
        batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    assert TSV.init_cache(cfg, 1, 8, device=CPU)["pos"].device.type == CPU
    assert TT.forward(cfg, params, batch).shape == (1, 6, cfg.vocab_size)
    logits, cache = TSV.prefill(cfg, params, batch, T_max=8)
    logits, _ = TSV.decode_step(cfg, params, cache,
                                torch.argmax(logits, -1).to(torch.int32))
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(TT.loss_fn(cfg, params, batch)))

    unknown = dataclasses.replace(cfg, family="unknown")
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: check_supported(unknown),
                 lambda: TT.init_params(unknown, gen, device=CPU),
                 lambda: TSV.init_cache(unknown, 1, 4, device=CPU),
                 lambda: TT.forward(unknown, params, batch),
                 lambda: TT.loss_fn(unknown, params, batch),
                 lambda: TSV.prefill(unknown, params, batch),
                 lambda: TSV.decode_step(unknown, params, cache, None)):
        with pytest.raises(NotImplementedError, match="unknown family"):
            call()


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_forward_matches_reference(model):
    rcfg, tcfg, rparams, tparams = model
    toks = _tokens(tcfg, 2, 32)
    want = RT.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    got = TT.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 32, tcfg.vocab_size)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_gqa_forward_matches_reference(arch):
    """Reduced internlm2 and minitron through the float32 forward check."""
    rcfg, tcfg, rparams, tparams = _model(arch, False)
    toks = _tokens(tcfg, 2, 32)
    want = RT.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    got = TT.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 32, tcfg.vocab_size)
    _close(got, want)


def _rel_err(got, want) -> float:
    want = np.asarray(want.astype(jnp.float32), np.float64)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


def _with_bumped(scale, run):
    """run() with scale[0] raised by 100 bfloat16 ulps, then restored."""
    w = float(scale[0])
    try:
        scale[0] = w + 100 * 2.0 ** (np.floor(np.log2(abs(w))) - 7)
        return run()
    finally:
        scale[0] = w


def _bf16_block_readings(arch) -> dict:
    """One bfloat16 block (norms, attention, SwiGLU, residuals) of the
    port against the reference's, run op by op; the control raises the
    port's ln2 scale."""
    rcfg, tcfg, rparams, tparams = _model(arch, True)
    rp = jax.tree.map(lambda a: a[0], rparams["groups"]["b0"])
    tp = TT.group_params(tparams["groups"]["b0"], 0)
    x = _rand(2, 32, tcfg.d_model, seed=3)
    want = RT._block_apply(rcfg, "attn", rp,
                           jnp.asarray(x).astype(jnp.bfloat16), None)
    run = lambda: TT._block_apply(tcfg, "attn", tp,
                                  torch.as_tensor(x).to(torch.bfloat16),
                                  None)
    got = run()
    assert got.dtype == torch.bfloat16
    return {"block": _rel_err(got, want),
            "block_control": _rel_err(
                _with_bumped(tp["ln2"]["scale"], run), want)}


def _bf16_forward_readings(arch) -> dict:
    """The bfloat16 logits of the port against the reference's scanned
    forward and its forward run op by op; the control raises the port's
    final norm scale."""
    rcfg, tcfg, rparams, tparams = _model(arch, True)
    toks = _tokens(tcfg, 2, 32)
    rbatch = {"tokens": jnp.asarray(toks)}
    scanned = RT.forward(rcfg, rparams, rbatch)
    op_by_op = RT.forward(dataclasses.replace(rcfg, scan_layers=False),
                          rparams, rbatch)
    run = lambda: TT.forward(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    got = run()
    assert got.dtype == torch.bfloat16
    return {"forward": _rel_err(got, scanned),
            "forward_vs_op_by_op": _rel_err(got, op_by_op),
            "reference_scanned_vs_op_by_op": _rel_err(
                torch.as_tensor(np.array(op_by_op.astype(jnp.float32))),
                scanned),
            "forward_control": _rel_err(
                _with_bumped(tparams["final_norm"]["scale"], run), scanned)}


@pytest.mark.parametrize("arch", (ARCH, *DENSE_ARCHS))
def test_bf16_block_equals_reference(arch):
    """In bfloat16 one block of the port equals the reference's within
    BF16_BLOCK_TOL, and a control must exceed it."""
    r = _bf16_block_readings(arch)
    assert r["block"] <= BF16_BLOCK_TOL < r["block_control"], r


@pytest.mark.parametrize("arch", (ARCH, *DENSE_ARCHS))
def test_bf16_forward_matches_reference(arch):
    """The bfloat16 forward of the port against the reference's, scanned
    and op by op, on the CPU within BF16_REL_TOL, and a control that
    must exceed it."""
    r = _bf16_forward_readings(arch)
    assert max(r["forward"], r["forward_vs_op_by_op"]) <= BF16_REL_TOL, r
    assert r["forward_control"] > BF16_REL_TOL, r


def test_prefill_and_decode_match_reference(model):
    """prefill logits and caches, then one decode step, equal the
    reference's within TOL; keys are cached after RoPE, pos is a tensor."""
    rcfg, tcfg, rparams, tparams = model
    B, S, T_max = 2, 24, 32
    toks = _tokens(tcfg, B, S)
    rl, rc = RSV.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                         T_max=T_max)
    tl, tc = TSV.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         T_max=T_max)
    _close(tl, rl)
    assert isinstance(tc["pos"], torch.Tensor) and int(tc["pos"]) == S
    for name in ("k", "v"):
        got = tc["blocks"]["b0"][name]
        assert got.shape == (tcfg.num_groups, B, T_max, tcfg.num_kv_heads,
                             tcfg.hd)
        _close(got, rc["blocks"]["b0"][name])
    nxt = np.array([3, 7], np.int32)
    rl2, rc2 = RSV.decode_step(rcfg, rparams, rc, jnp.asarray(nxt))
    tl2, tc2 = TSV.decode_step(tcfg, tparams, tc, torch.as_tensor(nxt))
    _close(tl2, rl2)
    _close(tc2["blocks"]["b0"]["k"], rc2["blocks"]["b0"]["k"])
    assert int(tc2["pos"]) == S + 1 and int(tc["pos"]) == S  # not mutated


def test_multi_token_greedy_decode_matches_reference(model):
    """4 greedy steps: the same tokens as the reference, and (as
    tests/test_serve.py holds the reference) the last logits within 2e-2
    of `forward` over the grown sequence."""
    rcfg, tcfg, rparams, tparams = model
    B, S, gen = 2, 16, 4
    toks = _tokens(tcfg, B, S)
    rl, rc = RSV.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                         T_max=S + gen)
    tl, tc = TSV.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         T_max=S + gen)
    grown = torch.as_tensor(toks)
    for _ in range(gen):
        rn = jnp.argmax(rl, -1).astype(jnp.int32)
        tn = torch.argmax(tl, -1).to(torch.int32)
        assert np.array_equal(n_(tn), np.asarray(rn))
        grown = torch.cat([grown, tn[:, None]], 1)
        rl, rc = RSV.decode_step(rcfg, rparams, rc, rn)
        tl, tc = TSV.decode_step(tcfg, tparams, tc, tn)
        _close(tl, rl)
    full = TT.forward(tcfg, tparams, {"tokens": grown})[:, -1]
    _close(tl, full.numpy(), 2e-2)


def test_cache_shapes_constant_under_decode(model):
    _, cfg, _, params = model
    cache = TSV.init_cache(cfg, 2, 8, device=CPU)
    shapes0 = {k: tuple(v.shape) for k, v in cache["blocks"]["b0"].items()}
    _, cache2 = TSV.decode_step(cfg, params, cache,
                                torch.zeros(2, dtype=torch.int32))
    assert {k: tuple(v.shape)
            for k, v in cache2["blocks"]["b0"].items()} == shapes0
    assert shapes0["k"] == (cfg.num_groups, 2, 8, cfg.num_kv_heads, cfg.hd)
    assert int(cache2["pos"]) == 1


def test_serve_driver_pads_tail_and_matches_decode(model):
    """launch/serve: 5 requests in batches of 2 (the tail padded); each
    request's tokens equal a batch-of-one greedy run's."""
    _, cfg, _, params = model
    prompts = _tokens(cfg, 5, 8, seed=4)
    out = TLS.serve_requests(cfg, params, prompts, batch=2, gen=3)
    assert out["tokens"].shape == (5, 3)
    one = TLS.serve_requests(cfg, params, prompts[4:], batch=1, gen=3)
    assert np.array_equal(out["tokens"][4:], one["tokens"])
    res = TLS.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                    "--prompt-len", "8", "--gen", "2"])
    assert res["tokens_generated"] == 6


def test_entry_points_default_to_cuda():
    cfg = TCFG.get_reduced(ARCH)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.init_cache(cfg, 1, 4)
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as TLT
    from repro_torch.train import train_lib as TTL
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTL.init_state(cfg, TTL.TrainConfig(),
                       torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLT.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "2"])


# ---------------------------------------------------------------------------
# the bridge: encrypted top-k over LM scores (examples/secure_topk_serving)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckks_gadget_keys():
    """(reference ks, port ks): test-ckks gadget keys from the port's
    keygen, the same key material in a reference KeySet."""
    tks = torch_keygen(torch_make_params("test-ckks", mode="gadget"), 3,
                       device=CPU)
    rp = ref_make_params("test-ckks", mode="gadget")
    ref_ks = RefKeySet(params=rp, ring=RR.make_ring(rp),
                       **{k: jnp.asarray(n_(getattr(tks, k)))
                          for k in ("sk", "pk0", "pk1", "cek_gadget",
                                    "cek_gadget_ntt")}, cek=None)
    return ref_ks, tks


def test_secure_topk_bridge_matches_reference(model, ckks_gadget_keys):
    """As examples/secure_topk_serving.py: last-token logits over 16
    candidate tokens, encrypted (CKKS, gadget keys); the port's
    encrypted_topk permutation equals the reference's on the bridged
    ciphertexts, and every pick scores within the CKKS tolerance of the
    plaintext top-k."""
    rcfg, tcfg, rparams, tparams = model
    ref_ks, tks = ckks_gadget_keys
    toks = _tokens(tcfg, 1, 16, seed=5)
    tl, _ = TSV.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    rl, _ = RSV.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    cand = np.random.default_rng(2).choice(tcfg.vocab_size, 16,
                                           replace=False)
    scores = n_(tl[0])[cand].astype(np.float64)
    _close(scores, np.asarray(rl[0])[cand])
    assert equality_tolerance(tks.params) == ref_tolerance(ref_ks.params)
    tol = equality_tolerance(tks.params)

    k = 4
    ref_ct = jax.jit(lambda m, key: RE.encrypt(ref_ks, m, key))(
        jnp.asarray(scores), jax.random.PRNGKey(4))
    # the reference's default comparator, jitted once (eager JAX compiles
    # every op at every stage's shape; jitting changes no integer)
    cmp = jitted_ref(ref_ks, RC.compare_fae)
    _, ref_top = RC.encrypted_topk(ref_ks, ref_ct, k,
                                   lambda _ks, a, b: cmp(a, b))
    _, got_top = TC.encrypted_topk(tks, ct_to_torch(ref_ct), k)
    assert np.array_equal(n_(got_top), np.asarray(ref_top))

    # the port's own encryption end to end
    own = TE.encrypt(tks, torch.as_tensor(scores), 6)
    _, own_top = TC.encrypted_topk(tks, own, k)
    kth = np.sort(scores)[-k]
    assert len(set(n_(own_top).tolist())) == k
    assert np.all(scores[n_(own_top)] >= kth - tol)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_reduced_lm_matches_cpu(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cfg, _, params = model
    cuda = TT.map_params(lambda a: a.to("cuda"), params)
    toks = torch.as_tensor(_tokens(cfg, 2, 16))
    want, cw = TSV.prefill(cfg, params, {"tokens": toks}, T_max=20)
    got, cg = TSV.prefill(cfg, cuda, {"tokens": toks.cuda()}, T_max=20)
    _close(got.cpu(), want.numpy())
    nxt = torch.argmax(want, -1).to(torch.int32)
    want2, _ = TSV.decode_step(cfg, params, cw, nxt)
    got2, _ = TSV.decode_step(cfg, cuda, cg, nxt.cuda())
    _close(got2.cpu(), want2.numpy())


# ---------------------------------------------------------------------------
# the layers, option by option, against the reference's functions
# ---------------------------------------------------------------------------


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kw", [
    {}, {"causal": False}, {"window": 5}, {"q_offset": 3, "t_valid": 17},
    {"chunk": 7}, {"chunk": 64, "window": 3, "causal": True},
], ids=["causal", "full", "window", "offset-tvalid", "chunk7", "chunk64"])
def test_flash_attention_matches_reference(kw):
    """Query chunking (a partial last chunk included) and every mask:
    causal, sliding window, query offset, valid key length."""
    q, k, v = _rand(2, 20, 3, 8), _rand(2, 20, 3, 8, seed=1), \
        _rand(2, 20, 3, 8, seed=2)
    kw = dict({"chunk": 8}, **kw)
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)
    got = TL.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), **kw)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("case", ["scalar", "per-row", "window"])
def test_decode_attention_and_repeat_kv_match_reference(case):
    q, k, v = _rand(2, 1, 2, 3, 8), _rand(2, 12, 2, 8, seed=1), \
        _rand(2, 12, 2, 8, seed=2)
    tv = np.array([5, 12], np.int32) if case == "per-row" else \
        np.asarray(9, np.int32)
    window = 4 if case == "window" else 0
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), t_valid=jnp.asarray(tv),
                               window=window)
    got = TL.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v),
                              t_valid=torch.as_tensor(tv), window=window)
    _close(got, want, 1e-5)
    assert np.array_equal(n_(TL.repeat_kv(torch.as_tensor(k), 3)),
                          np.asarray(RL.repeat_kv(jnp.asarray(k), 3)))


@pytest.mark.parametrize("kw", [
    {}, {"causal": False}, {"window": 4},
    {"kv_x": "enc", "use_rope": False, "causal": False}],
    ids=["self", "bidirectional", "window", "cross"])
def test_gqa_swiglu_rope_rmsnorm_match_reference(model, kw):
    """The block's layers on the reduced model's first-layer weights:
    GQA self-, windowed and cross-attention, SwiGLU, RoPE, RMSNorm."""
    rcfg, tcfg, rparams, tparams = model
    rp = jax.tree.map(lambda a: a[0], rparams["groups"]["b0"])
    tp = TT.group_params(tparams["groups"]["b0"], 0)
    x = _rand(2, 10, tcfg.d_model, seed=3)
    kw = dict(kw)
    rkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_x") == "enc":
        enc = _rand(2, 6, tcfg.d_model, seed=4)
        rkw["kv_x"], tkw["kv_x"] = jnp.asarray(enc), torch.as_tensor(enc)
    _close(TL.gqa_apply(tp["attn"], tcfg, torch.as_tensor(x), **tkw),
           RL.gqa_apply(rp["attn"], rcfg, jnp.asarray(x), **rkw))
    _close(TL.swiglu_apply(tp["ffn"], torch.as_tensor(x)),
           RL.swiglu_apply(rp["ffn"], jnp.asarray(x)))
    _close(TL.rmsnorm(tp["ln1"], torch.as_tensor(x), tcfg.norm_eps),
           RL.rmsnorm(rp["ln1"], jnp.asarray(x), rcfg.norm_eps))
    h = _rand(2, 10, 3, 20, seed=5)
    pos = np.arange(4, 14)
    _close(TL.rope(torch.as_tensor(h), torch.as_tensor(pos), 10_000.0),
           RL.rope(jnp.asarray(h), jnp.asarray(pos), 10_000.0))


if __name__ == "__main__":
    import json
    for arch in (ARCH, *DENSE_ARCHS):
        print(json.dumps({"arch": arch, **_bf16_block_readings(arch),
                          **_bf16_forward_readings(arch)}))
