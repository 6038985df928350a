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
from repro.kernels import cmp_eval as RCK
from repro.kernels import ops as RKO
from repro_torch.core import compare as TC
from repro_torch.core import ring as TR
from repro_torch.kernels import _build
from repro_torch.kernels import cmp_eval as TCK
from repro_torch.kernels import ntt as TNK
from repro_torch.kernels import ops as TKO

from conftest import get_scheme_ks
from tests.test_torch_core import (ct_to_torch, ks_to_torch, n_,
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

@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_plain_gadget_eval_matches_reference_kernel(profile):
    """Per-lane bounds ([A, rows, K, n]) against the reference's Pallas
    `eval_coeff0_gadget` (interpret mode) on the same differences."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    ct_a, ct_b = _operands(profile)
    E = rp.num_towers * rp.gadget_digits_per_tower

    @jax.jit
    def ref_kernel(x, y):
        # the reference's own kernel path (`kernels/ops.py::eval_values`)
        d = RC.ct_sub(ref_ks.ring, x, y)
        dig = digit_decompose(rp, d.c1).reshape(16, E, 1, rp.n)
        dig = jnp.broadcast_to(dig, (16, E, rp.num_towers, rp.n))
        return RCK.eval_coeff0_gadget(d.c0, dig, RCK.cek_gadget_to_br(ref_ks),
                                      ref_ks.ring, rp.scale, interpret=True)
    want = ref_kernel(ct_a, ct_b)
    a, b = ct_to_torch(ct_a), ct_to_torch(ct_b)
    got = TCK.eval_coeff0_gadget(a.c0[None], a.c1[None], 0, 16, [0],
                                 b.c0[None], b.c1[None], *_gadget_args(tks))
    assert got.shape == (1, 16, rp.num_towers)
    assert np.array_equal(n_(got[0]), want)
    assert np.array_equal(n_(TKO.eval_values(tks, a, b)),
                          _ref_eval(ref_ks)(ct_a, ct_b))


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


def test_mul_rejects_bad_operands():
    _, tp = sweep_params(64, 1)
    ring = TR.make_ring(tp, "cpu")
    x = torch.zeros((2, 1, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        TNK.negacyclic_mul(x.to(torch.int32), x, ring)
    with pytest.raises(ValueError, match=r"\[\.\.\., 1, 64\]"):
        TNK.negacyclic_mul(x[..., :32], x[..., :32], ring)


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
    TKO.eval_values(tks, ct_to_torch(ct_a), ct_to_torch(ct_b))
    TR.negacyclic_mul(tks.ring, tks.pk0, tks.sk)
    assert _build.LAUNCHES == {"eval_coeff0_gadget": 0, "negacyclic_mul": 0}


def test_build_sources_and_missing_compiler():
    """Every kernel source is in the package with its note, library
    names follow the sources' digest, and a machine without nvcc fails
    at build time (never at import)."""
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        assert "Bound on this card" in src
        assert 'extern "C" int hades_' in src
        assert _build._lib_path(name).parent == _build.BUILD_DIR
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, import with no JAX
    and nothing of `repro` (checked in a fresh interpreter)."""
    import repro_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.db.query_serve" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
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
    uniq = torch.stack([torch.randint(0, int(q), (2, 300, n),
                                      device=cuda) for q in qs.tolist()],
                       dim=-2)
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
