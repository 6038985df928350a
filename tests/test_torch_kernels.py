"""The port's kernel modules (`repro_torch.kernels`) against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
held here against the reference's Pallas kernels in interpret mode (as
`tests/test_kernels.py` runs them) and against `core.compare.eval_value`.
The CUDA kernels themselves run only on a card: their tests carry the
`gpu` marker and skip without one (`python3 chip_smoke.py` holds them
against the plain versions on the card at the served shapes).
"""
import functools
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.core import ring as RR
from repro.core.gadget import digit_decompose
from repro.core.keys import KeySet as RefKeySet
from repro.core.params import make_params as ref_make_params
from repro.kernels import cmp_eval as RCK
from repro.kernels import ops as RKO
from repro_torch.core import compare as TC
from repro_torch.core import encrypt as TE
from repro_torch.core import ring as TR
from repro_torch.core.encrypt import Ciphertext as TCiphertext
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import make_params as torch_make_params
from repro_torch.kernels import _build
from repro_torch.kernels import cmp_eval as TCK
from repro_torch.kernels import ntt as TNK
from repro_torch.kernels import ops as TKO

from conftest import get_scheme_ks
from test_torch_core import (ct_to_torch, ks_to_torch, n_,
                                   sweep_params, t_)

jax.config.update("jax_enable_x64", True)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: the kernels build and run on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _operands(profile):
    """Two bridged 16-row ciphertext columns of small operands (equal on
    every third row), encrypted once per profile by one jitted call."""
    ref_ks = get_scheme_ks(profile)
    rng = np.random.default_rng(7)
    if ref_ks.params.profile.scheme == "bfv":
        a, b = rng.integers(-60, 60, (2, 16))
    else:
        a, b = np.round(rng.uniform(-60, 60, (2, 16)) * 2) / 2
    b[::3] = a[::3]
    enc = jax.jit(lambda m, k: RE.encrypt(ref_ks, m, k))
    return (enc(jnp.asarray(a), jax.random.PRNGKey(1)),
            enc(jnp.asarray(b), jax.random.PRNGKey(2)))


def _ref_eval(ref_ks):
    return jax.jit(lambda x, y: RC.eval_value(ref_ks, x, y))


def _gadget_args(tks):
    p = tks.params
    return (tks.cek_rev, tks.ring.q_arr[:, 0], p.scale,
            p.profile.gadget_log_base)


# ---------------------------------------------------------------------------
# gadget Eval: the plain version vs the reference kernel and eval_value
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_gadget_coeff0(profile):
    """The reference's Pallas `eval_coeff0_gadget` (interpret mode, through
    its own kernel path `kernels/ops.py::eval_values`) on `_operands`."""
    ref_ks = get_scheme_ks(profile)
    rp = ref_ks.params
    E = rp.num_towers * rp.gadget_digits_per_tower

    @jax.jit
    def ref_kernel(x, y):
        d = RC.ct_sub(ref_ks.ring, x, y)
        dig = digit_decompose(rp, d.c1).reshape(16, E, 1, rp.n)
        dig = jnp.broadcast_to(dig, (16, E, rp.num_towers, rp.n))
        return RCK.eval_coeff0_gadget(d.c0, dig, RCK.cek_gadget_to_br(ref_ks),
                                      ref_ks.ring, rp.scale, interpret=True)
    return np.asarray(ref_kernel(*_operands(profile)))


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_plain_gadget_eval_matches_reference_kernel(profile):
    """Per-lane bounds ([A, rows, K, n]) against the reference's Pallas
    `eval_coeff0_gadget` (interpret mode) on the same differences."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    ct_a, ct_b = _operands(profile)
    want = _ref_gadget_coeff0(profile)
    a, b = ct_to_torch(ct_a), ct_to_torch(ct_b)
    got = TCK.eval_coeff0_gadget(a.c0[None], a.c1[None], 0, 16, [0],
                                 b.c0[None], b.c1[None], *_gadget_args(tks))
    assert got.shape == (1, 16, rp.num_towers)
    assert np.array_equal(n_(got[0]), want)
    assert np.array_equal(n_(TKO.eval_values(tks, a, b)),
                          _ref_eval(ref_ks)(ct_a, ct_b))


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_bytes_gadget_eval_matches_plain_and_reference(profile):
    """The tensor-core kernel's arithmetic (packed digit bytes against
    `KeySet.cek_rev_bytes`, s32 runs, byte recombination) equals the plain
    Eval and the reference's Pallas kernel, per-lane and per-atom bounds;
    test-bfv's 6-bit digits take two words a coefficient."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    ct_a, ct_b = _operands(profile)
    a, b = ct_to_torch(ct_a), ct_to_torch(ct_b)
    args = _gadget_args(tks)
    assert TCK.words_per_coeff(tks.params.gadget_digits_per_tower,
                               tks.params.profile.gadget_log_base) == (
        2 if profile == "test-bfv" else 1)
    got = TCK.eval_coeff0_gadget_bytes_plain(
        a.c0[None], a.c1[None], 0, 16, [0], b.c0[None], b.c1[None], *args,
        cek_bytes=tks.cek_rev_bytes)
    assert np.array_equal(n_(got[0]), _ref_gadget_coeff0(profile))
    sel, bnd = [0, 0, 0], (b.c0[:3], b.c1[:3])
    want = TCK.eval_coeff0_gadget_plain(a.c0[None], a.c1[None], 2, 11, sel,
                                        *bnd, *args)
    got = TCK.eval_coeff0_gadget_bytes_plain(a.c0[None], a.c1[None], 2, 11,
                                             sel, *bnd, *args)
    assert torch.equal(got, want)


def test_bytes_gadget_eval_flush_at_paper_ckks():
    """One paper-ckks lane (n = 16,384, two towers) with d = q - 1 (bound
    = c1 + 1) against a CEK of q - 1 everywhere: one s32 sum over its
    131,072 terms would overflow, the runs of 16,384 terms do not, and
    the result equals the plain Eval and Python integers."""
    tp = torch_make_params("paper-ckks")
    K, n, D = tp.num_towers, tp.n, tp.gadget_digits_per_tower
    qs = torch.tensor(tp.qs)
    rng = np.random.default_rng(5)
    c1 = t_(rng.integers(0, np.asarray(tp.qs)[:, None], size=(1, K, n)))
    c0 = t_(rng.integers(0, np.asarray(tp.qs)[:, None], size=(1, K, n)))
    b1, b0 = (c1 + 1) % qs[:, None], c0.clone()
    cek_rev = (qs[None, None, :, None] - 1).expand(K, D, K, n).contiguous()
    args = (cek_rev, qs, tp.scale, tp.profile.gadget_log_base)
    lb = tp.profile.gadget_log_base
    dig = [[((q - 1) >> (j * lb)) & ((1 << lb) - 1) for j in range(D)]
           for q in tp.qs]
    # column (k, b) of one unflushed s32: n * sum_ks,j dig * byte_b(q_k - 1)
    cols = [n * sum(map(sum, dig)) * ((q - 1) >> (8 * b) & 255)
            for q in tp.qs for b in range(4)]
    assert max(cols) > (1 << 31) - 1
    assert 4 * TCK.FLUSH_WORDS * 255 * 255 < (1 << 31) - 1
    got = TCK.eval_coeff0_gadget_bytes_plain(c0[None], c1[None], 0, 1, [0],
                                             b0, b1, *args)
    assert torch.equal(got, TCK.eval_coeff0_gadget_plain(
        c0[None], c1[None], 0, 1, [0], b0, b1, *args))
    for k, q in enumerate(tp.qs):
        keyed = n * sum(map(sum, dig)) * (q - 1)
        assert int(got[0, 0, k]) == keyed % q      # d0 = 0


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_plain_gadget_eval_tile_matches_eval_value(profile):
    """The scan-tile layout: a unique-column stack read through `sel` at
    a row offset, one bound per atom, chunked plain evaluation."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    cols = _operands(profile)
    uniq = RE.Ciphertext(jnp.stack([c.c0 for c in cols]),
                         jnp.stack([c.c1 for c in cols]))
    sel = np.array([1, 0, 1])
    pick = np.array([2, 5, 9])
    bounds = RE.Ciphertext(cols[0].c0[pick], cols[0].c1[pick])
    want = _ref_eval(ref_ks)(
        RE.Ciphertext(uniq.c0[sel], uniq.c1[sel]),
        RE.Ciphertext(bounds.c0[:, None], bounds.c1[:, None]))
    uniq, tb = ct_to_torch(uniq), ct_to_torch(bounds)
    old = TCK._PLAIN_CHUNK_ELEMS
    try:
        for chunk in (old, 1):                   # one chunk / a row each
            TCK._PLAIN_CHUNK_ELEMS = chunk
            for off, rows in ((0, 16), (5, 11), (15, 1)):
                got = TKO.gadget_tile_values(tks, uniq, sel, tb.c0, tb.c1,
                                             off, rows)
                assert np.array_equal(n_(got), want[:, off:off + rows])
    finally:
        TCK._PLAIN_CHUNK_ELEMS = old


def test_gadget_eval_rejects_bad_operands(bfv_keys):
    tks = ks_to_torch(bfv_keys)
    K, n = tks.params.num_towers, tks.params.n
    col = torch.zeros((1, 8, K, n), dtype=torch.int64)
    b = torch.zeros((2, K, n), dtype=torch.int64)
    args = _gadget_args(tks)
    good = TCK.eval_coeff0_gadget(col, col, 2, 4, [0, 0], b, b, *args)
    assert good.shape == (2, 4, K)
    for kw, msg in ((dict(off=6), "outside"), (dict(sel=[0, 1]), "sel"),
                    (dict(b=b[:1]), "bounds"),
                    (dict(col=col.to(torch.int32)), "int64")):
        c = kw.get("col", col)
        bb = kw.get("b", b)
        with pytest.raises(ValueError, match=msg):
            TCK.eval_coeff0_gadget(c, c, kw.get("off", 2), 4,
                                   kw.get("sel", [0, 0]), bb, bb, *args)


# ---------------------------------------------------------------------------
# fused multiply: the plain version vs the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,towers,batch", [(64, 1, 3), (256, 2, 8),
                                            (1024, 1, 2)])
def test_plain_mul_matches_reference_kernel(n, towers, batch, rng):
    rp, tp = sweep_params(n, towers)
    rring, tring = RR.make_ring(rp), TR.make_ring(tp, "cpu")
    qs = np.asarray(rp.qs)[:, None]
    a = rng.integers(0, qs, size=(batch, towers, n))
    b = rng.integers(0, qs, size=(batch, towers, n))
    want = RKO.negacyclic_mul(jnp.asarray(a), jnp.asarray(b), rring,
                              interpret=True)
    assert np.array_equal(n_(TNK.negacyclic_mul_plain(t_(a), t_(b), tring)),
                          want)
    assert np.array_equal(n_(TNK.negacyclic_mul(t_(a), t_(b), tring)), want)
    # a second operand shared by every row (the kernel's batch stride 0)
    want = RKO.negacyclic_mul(jnp.asarray(a), jnp.broadcast_to(
        jnp.asarray(b[0]), a.shape), rring, interpret=True)
    assert np.array_equal(n_(TNK.negacyclic_mul(t_(a), t_(b[0]), tring)),
                          want)


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_key_ntt_mul_matches_reference(profile, rng):
    """The cached key transforms (`KeySet.key_br`) equal the reference's
    Pallas ntt_br of pk0, pk1 and sk, and `negacyclic_mul_ntt` against
    each (two transforms a row) equals the reference's fused multiply
    (three) and the port's `negacyclic_mul`; encrypt and decrypt take
    this route."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp, ring = ref_ks.params, tks.ring
    a = rng.integers(0, np.asarray(rp.qs)[:, None],
                     size=(3, rp.num_towers, rp.n))
    names = ("pk0", "pk1", "sk")
    keys = jnp.stack([getattr(ref_ks, k) for k in names])      # [3, K, n]
    ref_br = RKO.ntt(keys, ref_ks.ring, interpret=True)
    ref_mul = RKO.negacyclic_mul(            # row 3i + r: a[r] * key i
        jnp.tile(jnp.asarray(a), (3, 1, 1)), jnp.repeat(keys, 3, axis=0),
        ref_ks.ring, interpret=True).reshape((3,) + a.shape)
    for i, name in enumerate(names):
        br, pairs = tks.key_br(name)
        assert tks.key_br(name)[0] is br                # cached
        assert np.array_equal(n_(br), ref_br[i])
        assert np.array_equal(n_(pairs[..., 0]), n_(br))
        want = ref_mul[i]
        assert np.array_equal(n_(TNK.negacyclic_mul_ntt_plain(t_(a), br,
                                                              ring)), want)
        assert np.array_equal(n_(TNK.negacyclic_mul_ntt(t_(a), br, ring)),
                              want)
        assert np.array_equal(n_(TNK.negacyclic_mul(
            t_(a), t_(np.asarray(keys[i])), ring)), want)
    with pytest.raises(ValueError, match="one polynomial"):
        TNK.negacyclic_mul_ntt(t_(a), t_(a), ring)
    with pytest.raises(ValueError, match="no key polynomial"):
        tks.key_br("cek")


def test_mul_rejects_bad_operands():
    _, tp = sweep_params(64, 1)
    ring = TR.make_ring(tp, "cpu")
    x = torch.zeros((2, 1, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        TNK.negacyclic_mul(x.to(torch.int32), x, ring)
    with pytest.raises(ValueError, match=r"\[\.\.\., 1, 64\]"):
        TNK.negacyclic_mul(x[..., :32], x[..., :32], ring)


# ---------------------------------------------------------------------------
# ntt_br: the plain version vs the reference kernel; ring.ntt through it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,towers,batch", [(64, 1, 3), (256, 2, 8),
                                            (512, 2, 5)])
def test_plain_ntt_br_matches_reference_kernel(n, towers, batch, rng):
    """Both directions against the reference's Pallas `ntt_br` (interpret
    mode, through `kernels.ops.ntt`/`intt`), on natural- and
    bit-reversed-order inputs; the round trip is the identity."""
    rp, tp = sweep_params(n, towers)
    rring, tring = RR.make_ring(rp), TR.make_ring(tp, "cpu")
    x = rng.integers(0, np.asarray(rp.qs)[:, None], size=(batch, towers, n))
    fwd = RKO.ntt(jnp.asarray(x), rring, interpret=True)
    inv = RKO.intt(jnp.asarray(x), rring, interpret=True)
    assert np.array_equal(n_(TNK.ntt_br_plain(t_(x), tring)), fwd)
    assert np.array_equal(n_(TNK.ntt_br_plain(t_(x), tring, fwd=False)),
                          inv)
    assert np.array_equal(n_(TKO.ntt(t_(x), tring)), fwd)
    assert np.array_equal(n_(TKO.intt(t_(x), tring)), inv)
    assert np.array_equal(n_(TNK.ntt_br(t_(np.asarray(fwd)), tring,
                                        fwd=False)), x)
    # leading batch dims flatten and come back
    got = TNK.ntt_br(t_(x).reshape((1, batch, towers, n)), tring)
    assert got.shape == (1, batch, towers, n)
    assert np.array_equal(n_(got[0]), fwd)


@pytest.mark.parametrize("n,towers", [(64, 1), (256, 2)])
def test_ring_ntt_diagonalises_negacyclic_mul(n, towers, rng):
    """ring.ntt/intt (ntt_br and the bit-reversal gather, an involution)
    against the schoolbook oracle: intt(ntt(a) * ntt(b)) = a ⊛ b, and
    intt(ntt(a)) = a."""
    _, tp = sweep_params(n, towers)
    ring = TR.make_ring(tp, "cpu")
    a, b = (t_(rng.integers(0, np.asarray(tp.qs)[:, None], size=(towers, n)))
            for _ in range(2))
    assert torch.equal(ring.bitrev[ring.bitrev], torch.arange(n))
    prod = TR.pointwise_mul(ring, TR.ntt(ring, a), TR.ntt(ring, b))
    assert torch.equal(TR.intt(ring, prod),
                       TR.naive_negacyclic_mul(ring, a, b))
    assert torch.equal(TR.intt(ring, TR.ntt(ring, a)), a)


# ---------------------------------------------------------------------------
# paper Eval: the plain version vs the reference kernel and eval_value
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _paper_ks(profile):
    """(reference, port) paper-mode KeySets over the port's CPU keygen's
    keys, with a seeded uniform CEK [K, n] beside them (the Eval's
    arithmetic takes any CEK, and the reference's eager keygen would
    cost 5-10 s of compiles), and the reference kernel's br-order CEK
    (jitted: eagerly its NTT compiles for 5 s)."""
    tks = torch_keygen(torch_make_params(profile, mode="paper"), 11,
                       device="cpu", paper_ecek_weight=0)
    rp = ref_make_params(profile, mode="paper")
    rng = np.random.default_rng(11)
    cek = rng.integers(0, np.asarray(rp.qs)[:, None],
                       size=(rp.num_towers, rp.n))
    ref = RefKeySet(params=rp, ring=RR.make_ring(rp),
                    **{k: jnp.asarray(n_(getattr(tks, k)))
                       for k in ("sk", "pk0", "pk1")},
                    cek=jnp.asarray(cek), cek_gadget=None,
                    cek_gadget_ntt=None)
    return ref, ks_to_torch(ref), jax.jit(lambda: RCK.cek_to_br(ref))()


def _ct(c0, c1):
    """Two residue arrays as a port Ciphertext on the CPU."""
    return TCiphertext(t_(c0), t_(c1))


def _residues(rp, rng, *shape):
    return rng.integers(0, np.asarray(rp.qs)[:, None],
                        size=shape + (rp.num_towers, rp.n))


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_plain_paper_eval_matches_reference_kernel(profile, rng):
    """Lane form (a - b, b per lane or one for every lane) and column
    form (a alone) against the reference's Pallas `eval_coeff0_paper`
    (interpret mode) on the same differences, and `eval_values` against
    `eval_value`."""
    ref_ks, tks, cek_br = _paper_ks(profile)
    rp = ref_ks.params
    a0, a1, b0, b1 = (_residues(rp, rng, 24) for _ in range(4))

    @jax.jit
    def ref_kernel(x0, x1, y0, y1):
        d = RC.ct_sub(ref_ks.ring, RE.Ciphertext(x0, x1),
                      RE.Ciphertext(y0, y1))
        return RCK.eval_coeff0_paper(d.c0, d.c1, cek_br, ref_ks.ring,
                                     rp.scale, interpret=True)
    args = (tks.cek_rev, tks.ring.q_arr[:, 0], rp.scale)
    want = ref_kernel(a0, a1, b0, b1)
    got = TCK.eval_coeff0_paper(t_(a0), t_(a1), *args, t_(b0), t_(b1))
    assert got.shape == (24, rp.num_towers)
    assert np.array_equal(n_(got), want)
    # one bound for every lane (batch stride 0 on the card)
    want = ref_kernel(a0, a1, np.broadcast_to(b0[:1], a0.shape),
                      np.broadcast_to(b1[:1], a1.shape))
    got = TCK.eval_coeff0_paper(t_(a0), t_(a1), *args, t_(b0[:1]),
                                t_(b1[:1]))
    assert np.array_equal(n_(got), want)
    # column form: the rows alone, and a row tile addressed as a view
    want = RCK.eval_coeff0_paper(jnp.asarray(a0), jnp.asarray(a1), cek_br,
                                 ref_ks.ring, rp.scale, interpret=True)
    assert np.array_equal(n_(TCK.eval_coeff0_paper(t_(a0), t_(a1), *args)),
                          want)
    old = TCK._PLAIN_CHUNK_ELEMS
    try:
        TCK._PLAIN_CHUNK_ELEMS = 3 * rp.num_towers * rp.n   # 3 rows a chunk
        got = TCK.eval_coeff0_paper(t_(a0)[5:16], t_(a1)[5:16], *args)
    finally:
        TCK._PLAIN_CHUNK_ELEMS = old
    assert np.array_equal(n_(got), want[5:16])
    # kernels.ops: centered eval values equal core.compare.eval_value
    a, b = _ct(a0, a1), _ct(b0, b1)
    ref_vals = jax.jit(lambda x, y: RC.eval_value(ref_ks, x, y))(
        RE.Ciphertext(jnp.asarray(a0), jnp.asarray(a1)),
        RE.Ciphertext(jnp.asarray(b0), jnp.asarray(b1)))
    assert np.array_equal(n_(TKO.eval_values(tks, a, b)), ref_vals)
    assert np.array_equal(n_(TC.eval_value(tks, a, b)), ref_vals)


def test_paper_eval_rejects_bad_operands(rng):
    _, tks, _ = _paper_ks("test-bfv")
    rp = tks.params
    a = t_(_residues(rp, rng, 4))
    args = (tks.cek_rev, tks.ring.q_arr[:, 0], rp.scale)
    assert TCK.eval_coeff0_paper(a, a, *args, a, a).shape == (4, rp.num_towers)
    for bad, msg in (((a, a, *args, a, None), "both"),
                     ((a, a, *args, a[:3], a[:3]), r"\[4 or 1"),
                     ((a, a[:2], *args), "not one"),
                     ((a.to(torch.int32), a, *args), "int64"),
                     ((a, a, tks.cek_rev[None], *args[1:]), r"\[K, n\]")):
        with pytest.raises(ValueError, match=msg):
            TCK.eval_coeff0_paper(*bad)


# ---------------------------------------------------------------------------
# kernels.ops: lane-budget policy, eval_values / compare in both modes
# ---------------------------------------------------------------------------

def test_lane_budget_policy_matches_reference(monkeypatch):
    assert TKO.DEFAULT_LANE_BUDGET == RKO.DEFAULT_LANE_BUDGET == 1 << 17
    cases = [(65536, 8, None), (65536, 12, None), (100, 3, 64), (5, 2, 4),
             (1, 1, None), (34423, 7, 1000), (0, 4, None)]
    for budget_env in (None, "4096"):
        if budget_env is None:
            monkeypatch.delenv("REPRO_LANE_BUDGET", raising=False)
        else:
            monkeypatch.setenv("REPRO_LANE_BUDGET", budget_env)
        for args in cases:
            assert TKO.lane_tile(*args) == RKO.lane_tile(*args), args
        assert TKO.resolve_lane_budget() == RKO.resolve_lane_budget()
    prev_t, prev_r = TKO.set_lane_budget(256), RKO.set_lane_budget(256)
    try:
        assert TKO.resolve_lane_budget() == RKO.resolve_lane_budget() == 256
        assert TKO.resolve_lane_budget(8) == 8
        assert TKO.lane_tile(4096, 3) == RKO.lane_tile(4096, 3) == 64
    finally:
        TKO.set_lane_budget(prev_t)
        RKO.set_lane_budget(prev_r)


@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_ops_eval_values_and_compare_match_reference(mode):
    ct_a, ct_b = _operands("test-bfv")
    if mode == "gadget":
        ref_ks = get_scheme_ks("test-bfv")
    else:                 # the same public key, a paper-mode CEK beside it
        from repro.core.keys import keygen
        from repro.core.params import make_params
        ref_ks = keygen(make_params("test-bfv", mode="paper"),
                        jax.random.PRNGKey(42), paper_ecek_weight=0)
    tks = ks_to_torch(ref_ks)
    a, b = ct_to_torch(ct_a), ct_to_torch(ct_b)
    want = RKO.eval_values(ref_ks, ct_a, ct_b, interpret=True)
    assert np.array_equal(n_(TKO.eval_values(tks, a, b)), want)
    assert np.array_equal(n_(TKO.compare(tks, a, b)),
                          RKO.compare(ref_ks, ct_a, ct_b, interpret=True))
    # two-sided broadcast: [2, 1] bounds against [8] rows
    bnd = RE.Ciphertext(ct_b.c0[:2, None], ct_b.c1[:2, None])
    want = RKO.broadcast_eval_values(ref_ks, ct_a, bnd, interpret=True)
    got = TKO.broadcast_eval_values(tks, a, ct_to_torch(bnd))
    assert got.shape == (2, 16)
    assert np.array_equal(n_(got), want)
    assert np.array_equal(n_(TC.eval_value(tks, a, ct_to_torch(bnd))), want)


def test_cpu_wrappers_count_no_launch(bfv_keys):
    """The counts move only where a kernel launches: CPU tensors run the
    plain versions and leave them alone."""
    tks = ks_to_torch(bfv_keys)
    _build.reset_launch_counts()
    ct_a, ct_b = _operands("test-bfv")
    a, b = ct_to_torch(ct_a), ct_to_torch(ct_b)
    TKO.eval_values(tks, a, b)
    TKO.eval_values(_paper_ks("test-bfv")[1], a, b)
    TR.negacyclic_mul(tks.ring, tks.pk0, tks.sk)
    TR.intt(tks.ring, TR.ntt(tks.ring, tks.pk0))
    TE.decrypt(tks, TE.encrypt(tks, 3, 1))
    assert set(_build.LAUNCHES) == {"eval_coeff0_gadget", "eval_coeff0_paper",
                                    "negacyclic_mul", "negacyclic_mul_ntt",
                                    "ntt_br_fwd", "ntt_br_inv"}
    assert not any(_build.LAUNCHES.values())


def test_build_sources_and_missing_compiler(tmp_path, monkeypatch):
    """Every kernel source is in the package with its note and declares
    exactly the entry points of its library's table, library names
    follow a digest of the source AND every shared header, and a
    machine without nvcc fails at build time (never at import)."""
    import re
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        assert "Bound on this card" in src
        assert (set(re.findall(r'extern "C" int (hades_\w+)', src))
                == set(_build.ENTRIES[name]))
        assert _build._lib_path(name).parent == _build.BUILD_DIR
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {
        "modarith.cuh", "ntt_stages.cuh"}
    # a header change renames every library (no stale .so is loaded)
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = {n: _build._lib_path(n).name for n in _build.SOURCES}
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert {n: _build._lib_path(n).name for n in _build.SOURCES} == before
    with open(tmp_path / "ntt_stages.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._lib_path(n).name for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


_MODARITH_PROBE = r"""
#include "modarith.cuh"
extern "C" {
uint32_t probe_shoup(uint32_t w, uint32_t q) { return hades::shoup(w, q); }
uint32_t probe_mul_shoup(uint32_t x, uint32_t w, uint32_t q) {
  return hades::mul_shoup(x, w, hades::shoup(w, q), q);
}
uint32_t probe_addmod(uint32_t a, uint32_t b, uint32_t q) {
  return hades::addmod(a, b, q);
}
uint32_t probe_submod(uint32_t a, uint32_t b, uint32_t q) {
  return hades::submod(a, b, q);
}
uint32_t probe_recombine(const uint64_t* acc, uint32_t q) {
  return hades::recombine_bytes(acc, q, hades::barrett_m(q));
}
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_modarith_helpers_host_build(tmp_path):
    """`csrc/modarith.cuh` built for the host with g++ (its functions are
    __host__ __device__): Shoup's companion and multiply over edge
    residues, including inputs up to 2^32 - 1, the branch-free add and
    subtract, and the byte recombination of the tensor-core Eval,
    against Python integers."""
    import ctypes
    src = tmp_path / "probe.cpp"
    src.write_text(_MODARITH_PROBE)
    lib_path = tmp_path / "probe.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(lib_path), str(src)],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    u32, u64p = ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64)
    lib.probe_shoup.argtypes = [u32, u32]
    lib.probe_mul_shoup.argtypes = [u32, u32, u32]
    lib.probe_addmod.argtypes = lib.probe_submod.argtypes = [u32, u32, u32]
    lib.probe_recombine.argtypes = [u64p, u32]
    for fn in (lib.probe_shoup, lib.probe_mul_shoup, lib.probe_addmod,
               lib.probe_submod, lib.probe_recombine):
        fn.restype = u32
    rng = np.random.default_rng(3)
    primes = sorted({q for prof in ("test-bfv", "test-ckks", "paper-bfv",
                                    "paper-ckks")
                     for q in torch_make_params(prof).qs} | {12289, 3})
    for q in primes:
        ws = {0, 1, q - 1, q // 2, *rng.integers(0, q, 6).tolist()}
        xs = {0, 1, q - 1, q, 2 * q - 1, (1 << 32) - 1,
              *rng.integers(0, 1 << 32, 6).tolist()}
        for w in ws:
            assert lib.probe_shoup(w, q) == (w << 32) // q
            for x in xs:
                assert lib.probe_mul_shoup(x, w, q) == x * w % q, (q, w, x)
            for v in ws:                  # residues in [0, q)
                assert lib.probe_addmod(v, w, q) == (v + w) % q
                assert lib.probe_submod(v, w, q) == (v - w) % q
        top = 33025 * 255 * 255 * 4          # a flushed column's worst sum
        for acc in ([0, 0, 0, 0], [q - 1] * 4, [top] * 4,
                    rng.integers(0, top, 4).tolist()):
            arr = (ctypes.c_uint64 * 4)(*acc)
            want = sum(a << (8 * b) for b, a in enumerate(acc)) % q
            assert lib.probe_recombine(arr, q) == want


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, import with no JAX
    and nothing of `repro` (checked in a fresh interpreter)."""
    import repro_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.db.query_serve", "repro_torch.db.join",
            "repro_torch.db.shard.spec", "repro_torch.db.shard.table",
            "repro_torch.db.shard.executor", "repro_torch.db.shard.index",
            "repro_torch.db.shard.join",
            "repro_torch.db.shard.serve", "repro_torch.db.serve_loop",
            "repro_torch.obs.export", "repro_torch.baselines.paillier",
            "repro_torch.baselines.hope", "repro_torch.baselines.pope",
            "repro_torch.launch.elastic", "repro_torch.launch.serve",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.serve",
            "repro_torch.configs.smollm_360m",
            "repro_torch.configs.whisper_base"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or "
            "m == 'repro' or m.startswith('repro.'))\n"
            "print(len(bad), bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    for m in mods:
        importlib.import_module(m)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_gadget_eval_kernel_equals_plain(cuda, bfv_keys):
    tks = ks_to_torch(bfv_keys)
    from repro_torch.core.keys import KeySet
    gks = KeySet.from_numpy(tks.params, sk=tks.sk, pk0=tks.pk0, pk1=tks.pk1,
                            cek_gadget=tks.cek_gadget, device=cuda)
    n = gks.params.n
    qs = gks.ring.q_arr[:, 0]
    uniq = torch.stack([torch.randint(0, int(q), (2, 2, 300, n),
                                      device=cuda) for q in qs.tolist()],
                       dim=-2)                       # c0/c1 x 2 columns
    bnd = torch.stack([torch.randint(0, int(q), (2, 3, n), device=cuda)
                       for q in qs.tolist()], dim=-2)
    lanes = torch.stack([torch.randint(0, int(q), (2, 3, 40, n),
                                       device=cuda) for q in qs.tolist()],
                        dim=-2)
    args = _gadget_args(gks)
    before = _build.LAUNCHES["eval_coeff0_gadget"]
    for off, rows, sel, b in ((0, 300, [1, 0, 1], bnd), (260, 40, [0, 1, 0],
                                                          lanes)):
        b0, b1 = b[0], b[1]
        got = TCK.eval_coeff0_gadget(uniq[0], uniq[1], off, rows, sel, b0,
                                     b1, *args)
        want = TCK.eval_coeff0_gadget_plain(uniq[0], uniq[1], off, rows, sel,
                                            b0, b1, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert _build.LAUNCHES["eval_coeff0_gadget"] > before


@pytest.mark.gpu
def test_cuda_mul_kernel_equals_plain(cuda):
    _, tp = sweep_params(1024, 2)
    ring = TR.make_ring(tp, cuda)
    qs = ring.q_arr
    a = torch.stack([torch.randint(0, int(q), (33, 1024), device=cuda)
                     for q in qs[:, 0].tolist()], dim=-2)
    b = torch.flip(a, dims=[0])
    before = _build.LAUNCHES["negacyclic_mul"]
    for x, y in ((a, b), (a, b[0]), (a[0], b)):
        got = TNK.negacyclic_mul(x, y, ring)
        want = TNK.negacyclic_mul_plain(x, y, ring)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert _build.LAUNCHES["negacyclic_mul"] == before + 3
    b_br = TNK.ntt_br(b[:1], ring)
    got = TNK.negacyclic_mul_ntt(a, b_br, ring)
    torch.cuda.synchronize()
    assert torch.equal(got, TNK.negacyclic_mul_plain(a, b[0], ring))
    assert _build.LAUNCHES["negacyclic_mul_ntt"] >= 1


@pytest.mark.gpu
def test_cuda_paper_eval_and_ntt_br_kernels_equal_plain(cuda):
    """The paper Eval in both forms (b per lane, b for every lane, none,
    a row-tile view) and ntt_br in both directions, on the card."""
    _, cks, _ = _paper_ks("test-bfv")
    from repro_torch.core.keys import KeySet
    tp = cks.params
    ks = KeySet.from_numpy(tp, sk=cks.sk, pk0=cks.pk0, pk1=cks.pk1,
                           cek=cks.cek, device=cuda)
    qs = ks.ring.q_arr[:, 0]

    def rand(*shape):
        return torch.stack([torch.randint(0, int(q), shape + (tp.n,),
                                          device=cuda) for q in qs.tolist()],
                           dim=-2)
    a0, a1, b0, b1 = rand(300), rand(300), rand(300), rand(300)
    args = (ks.cek_rev, qs, tp.scale)
    before = dict(_build.LAUNCHES)
    for b in ((b0, b1), (b0[:1], b1[:1]), (None, None)):
        got = TCK.eval_coeff0_paper(a0, a1, *args, *b)
        want = TCK.eval_coeff0_paper_plain(a0, a1, *args, *b)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    got = TCK.eval_coeff0_paper(a0[40:90], a1[40:90], *args)
    torch.cuda.synchronize()
    assert torch.equal(got, TCK.eval_coeff0_paper_plain(
        a0[40:90].clone(), a1[40:90].clone(), *args))
    for fwd in (True, False):
        got = TNK.ntt_br(a0[:33], ks.ring, fwd=fwd)
        want = TNK.ntt_br_plain(a0[:33], ks.ring, fwd=fwd)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(TR.intt(ks.ring, TR.ntt(ks.ring, a0[:5])), a0[:5])
    assert _build.LAUNCHES["eval_coeff0_paper"] == \
        before["eval_coeff0_paper"] + 4
    assert _build.LAUNCHES["ntt_br_fwd"] == before["ntt_br_fwd"] + 2
    assert _build.LAUNCHES["ntt_br_inv"] == before["ntt_br_inv"] + 2
