"""The PyTorch port's core (`repro_torch.core`) against the JAX reference.

Same inputs through both packages, on the CPU: the reference's own
samples (drawn from its `jax.random` keys) are handed to the port's
keygen / encrypt, and everything downstream of a ciphertext runs on
bridged reference ciphertexts.  Residues are integers mod q, so every
comparison is exact (`np.array_equal`); no tolerance applies.

The bridge helpers at the top (`ks_to_torch`, `ct_to_torch`, ...) are
shared by the other `test_torch_*` files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ckks as RCK
from repro.core import compare as RC
from repro.core import encrypt as RE
from repro.core import gadget as RG
from repro.core import noise as RN
from repro.core import ring as RR
from repro.core import sampling as RS
from repro.core.keys import keygen as ref_keygen
from repro.core.params import PROFILES as REF_PROFILES
from repro.core.params import make_params as ref_make_params
from repro_torch.core import ckks as TCK
from repro_torch.core import compare as TC
from repro_torch.core import encrypt as TE
from repro_torch.core import gadget as TG
from repro_torch.core import noise as TN
from repro_torch.core import ring as TR
from repro_torch.core import sampling as TS
from repro_torch.core.keys import KeySet
from repro_torch.core.keys import keygen as torch_keygen
from repro_torch.core.params import PROFILES as TORCH_PROFILES
from repro_torch.core.params import make_params as torch_make_params

from conftest import _SCHEME_SEEDS, get_scheme_ks
from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _jitted_reference, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

jax.config.update("jax_enable_x64", True)

pytestmark = pytest.mark.usefixtures("_jitted_reference")


CPU = "cpu"
# one operand batch size across the file: eager JAX compiles per shape
N_OPERANDS = 12


# ---------------------------------------------------------------------------
# bridge: reference objects -> the port's, through numpy
# ---------------------------------------------------------------------------

def t_(x) -> torch.Tensor:
    """A reference array as an int64/float64 CPU tensor."""
    return torch.as_tensor(np.asarray(x))


def n_(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def params_to_torch(ref_params):
    """The port's params for a reference HadesParams (same profile)."""
    prof = dataclasses.replace(TORCH_PROFILES["test-bfv"],
                               **dataclasses.asdict(ref_params.profile))
    return torch_make_params(prof, mode=ref_params.mode)


def ks_to_torch(ref_ks) -> KeySet:
    """A reference KeySet's key material as a port KeySet on the CPU."""
    return KeySet.from_numpy(
        params_to_torch(ref_ks.params), sk=ref_ks.sk, pk0=ref_ks.pk0,
        pk1=ref_ks.pk1, cek=ref_ks.cek, cek_gadget=ref_ks.cek_gadget,
        device=CPU)


def ct_to_torch(ref_ct) -> TE.Ciphertext:
    return TE.Ciphertext.from_numpy(ref_ct.c0, ref_ct.c1, device=CPU)


def ref_pad_rows(ref_ks):
    """The reference's sentinel pad rows (`_pad_to_pow2` under
    `_PAD_KEY_SEED`), bridged, as the port's `pad_rows` callback."""
    def pad(value, count):
        ct = RE.encrypt(ref_ks, jnp.full((count,), value, jnp.int64),
                        jax.random.PRNGKey(RC._PAD_KEY_SEED))
        return ct_to_torch(ct)
    return pad


def ref_encrypt_samples(params, key, batch):
    """The (u, e0, e1) the reference's `_encrypt_payload` draws from key."""
    k_u, k_e0, k_e1 = jax.random.split(key, 3)
    return (RS.ternary_poly(params, k_u, batch),
            RS.noise_poly(params, k_e0, batch),
            RS.noise_poly(params, k_e1, batch))


def jitted_ref(ks, fn):
    """A jitted reference function over two ciphertexts (eager JAX
    recompiles every op at every shape)."""
    return jax.jit(lambda a, b: fn(ks, a, b))


def sweep_params(n, towers, mode="gadget"):
    """Reference and port params for a swept (n, K) test-bfv ring."""
    kw = dict(n=n, num_towers=towers, name=f"sweep-{n}-{towers}")
    return (ref_make_params(dataclasses.replace(REF_PROFILES["test-bfv"],
                                                **kw), mode=mode),
            torch_make_params(dataclasses.replace(
                TORCH_PROFILES["test-bfv"], **kw), mode=mode))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["paper", "gadget"])
@pytest.mark.parametrize("profile", sorted(REF_PROFILES))
def test_params_match_reference(profile, mode):
    rp = ref_make_params(profile, mode=mode)
    tp = torch_make_params(profile, mode=mode)
    assert dataclasses.asdict(tp.profile) == dataclasses.asdict(rp.profile)
    for attr in ("qs", "Q", "n", "num_towers", "tau", "max_operand",
                 "scale", "delta_enc", "gadget_base",
                 "gadget_digits_per_tower", "noise_bound", "epsilon"):
        assert getattr(tp, attr) == getattr(rp, attr), attr
    assert list(tp.crt_alphas()) == list(rp.crt_alphas())
    rt, tt = rp.ntt_tables(), tp.ntt_tables()
    for f in ("psi_pow", "psi_inv_pow", "stage_w", "stage_w_inv", "bitrev"):
        assert np.array_equal(getattr(tt, f), getattr(rt, f)), f


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("towers", [1, 2])
@pytest.mark.parametrize("n", [64, 256, 1024])
def test_ring_matches_reference(n, towers, rng):
    rp, tp = sweep_params(n, towers)
    rring, tring = RR.make_ring(rp), TR.make_ring(tp, CPU)
    qs = np.asarray(rp.qs)[:, None]
    a = rng.integers(0, qs, size=(3, towers, n))
    b = rng.integers(0, qs, size=(3, towers, n))
    ta, tb = t_(a), t_(b)
    s = int(rng.integers(1, 1 << 20))

    def ops(R, ring, x, y):
        # the last product broadcasts one [K, n] operand over the batch
        return (R.add(ring, x, y), R.sub(ring, x, y), R.neg(ring, x),
                R.pointwise_mul(ring, x, y), R.scalar_mul(ring, x, s),
                R.ntt(ring, x), R.negacyclic_mul(ring, x, y),
                R.negacyclic_mul(ring, x[0], y))

    want = jax.jit(lambda x, y: ops(RR, rring, x, y))(jnp.asarray(a),
                                                       jnp.asarray(b))
    got = ops(TR, tring, ta, tb)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(n_(g), w), i
    fwd, prod = got[5], got[6]
    assert np.array_equal(n_(TR.intt(tring, fwd)), a)
    if n <= 256:
        assert np.array_equal(n_(TR.naive_negacyclic_mul(tring, ta[0],
                                                          tb[0])),
                              n_(prod[0]))
    vals = rng.integers(-(1 << 40), 1 << 40, size=(5,))
    assert np.array_equal(n_(TR.const_poly(tp, t_(vals))),
                          RR.const_poly(rp, jnp.asarray(vals)))
    coeffs = rng.integers(-(1 << 50), 1 << 50, size=(2, n))
    assert np.array_equal(TR.to_rns(tp, coeffs), RR.to_rns(rp, coeffs))


@pytest.mark.parametrize("profile", sorted(REF_PROFILES))
def test_crt_centered_matches_reference(profile, rng):
    """Garner's form is exact for Q up to 2^62: every profile, random
    residues and the edges 0, 1, q-1, Q/2, Q/2 + 1 and Q - 1."""
    rp, tp = ref_make_params(profile), torch_make_params(profile)
    qs = np.asarray(rp.qs)
    res = rng.integers(0, qs, size=(257, len(qs)))
    res[0], res[1] = 0, qs - 1
    half = rp.Q // 2
    for j, x in enumerate((half, half + 1, rp.Q - 1, 1)):
        res[2 + j] = [x % q for q in rp.qs]
    want = RR.crt_centered(rp, jnp.asarray(res))
    assert np.array_equal(n_(TR.crt_centered(tp, t_(res))), want)


def test_ring_to_device_and_resolve_device():
    """`Ring.to` moves every table; entry points default to CUDA and
    raise without a card unless the caller asks for the CPU."""
    tp = torch_make_params("test-bfv")
    ring = TR.make_ring(tp, CPU)
    moved = ring.to(CPU)
    assert moved.qs == ring.qs and torch.equal(moved.stage_w, ring.stage_w)
    assert TR.resolve_device(CPU).type == "cpu"
    if torch.cuda.is_available():
        assert TR.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.resolve_device(None)
        with pytest.raises(RuntimeError):
            torch_keygen(tp, 0)


# ---------------------------------------------------------------------------
# samplers, keys, encryption
# ---------------------------------------------------------------------------

def test_samplers_ranges_and_determinism():
    tp = torch_make_params("test-ckks")
    qs = torch.tensor(tp.qs)[:, None]

    def gen(seed):
        return TS.make_generator(seed, CPU)

    u = TS.uniform_poly(tp, gen(1), (64,))
    assert u.shape == (64, tp.num_towers, tp.n) and u.dtype == torch.int64
    assert bool(((u >= 0) & (u < qs)).all())
    for sample, bound in ((TS.ternary_poly(tp, gen(2), (32,)), 1),
                          (TS.noise_poly(tp, gen(3), (32,)), tp.noise_bound)):
        centered = torch.where(sample > qs // 2, sample - qs, sample)
        assert int(centered.abs().max()) == bound
        # every tower lifts the same small integer
        assert bool((centered == centered[..., :1, :]).all())
    small = TS.small_signed(gen(4), (1000,), 5)
    assert int(small.min()) == -5 and int(small.max()) == 5
    assert torch.equal(TS.uniform_poly(tp, gen(9), (4,)),
                       TS.uniform_poly(tp, gen(9), (4,)))


def _ref_keygen_samples(rp, key):
    """The reference keygen's samples, drawn exactly as it draws them."""
    k_sk, k_a, k_epk, k_cek, k_g = jax.random.split(key, 5)
    out = dict(sk=RS.ternary_poly(rp, k_sk), a=RS.uniform_poly(rp, k_a),
               e_pk=RS.noise_poly(rp, k_epk))
    if rp.mode == "paper":
        out["e_cek"] = RS.noise_poly(rp, k_cek)
    else:
        K, D = rp.num_towers, rp.gadget_digits_per_tower
        keys = jax.random.split(k_g, K * D)
        out["e_gadget"] = jnp.stack([RS.noise_poly(rp, keys[i])
                                     for i in range(K * D)])
    return out


@pytest.mark.parametrize("mode,profile,weight", [
    ("gadget", "test-bfv", None), ("gadget", "test-ckks", None),
    ("paper", "test-bfv", 0), ("paper", "test-bfv", 5)])
def test_keygen_injected_samples_match_reference(mode, profile, weight):
    """The port's keygen on the reference keygen's own samples; gadget
    mode reuses the session KeySets (same seeds as `conftest`)."""
    rp = ref_make_params(profile, mode=mode)
    key = jax.random.PRNGKey(_SCHEME_SEEDS[profile])
    if mode == "gadget":
        ref = get_scheme_ks(profile)
    else:
        ref = ref_keygen(rp, key, paper_ecek_weight=weight)
    samples = {k: np.asarray(v) for k, v in
               _ref_keygen_samples(rp, key).items()}
    tks = torch_keygen(params_to_torch(rp), 0, device=CPU,
                       paper_ecek_weight=weight, **samples)
    assert np.array_equal(n_(tks.sk), ref.sk)
    assert np.array_equal(n_(tks.pk0), ref.pk0)
    assert np.array_equal(n_(tks.pk1), ref.pk1)
    if mode == "paper":
        assert np.array_equal(n_(tks.cek), ref.cek)
        assert tks.cek_gadget is None
    else:
        assert np.array_equal(n_(tks.cek_gadget), ref.cek_gadget)
        assert np.array_equal(n_(tks.cek_gadget_ntt), ref.cek_gadget_ntt)
        # the reversed CEK: rev[0] = c[0], rev[i] = -c[n-i] mod q
        c, rev = np.asarray(ref.cek_gadget), n_(tks.cek_rev)
        q = np.asarray(rp.qs)[:, None]
        assert np.array_equal(rev[..., 0], c[..., 0])
        assert np.array_equal(rev[..., 1:], (-c[..., :0:-1]) % q)


@pytest.mark.parametrize("mode", ["gadget", "paper"])
def test_keygen_eager_eval_domain_cek(mode):
    """A gadget KeySet holds its CEK's eval domain as the reference does
    (a field set when the KeySet is made, not computed on request); a
    paper KeySet has none, and its reversed CEK is the [K, n] paper one.
    (keygen's own `cek_gadget_ntt` is held against the reference in
    test_keygen_injected_samples_match_reference.)"""
    if mode == "gadget":
        ref = get_scheme_ks("test-bfv")
        tks = ks_to_torch(ref)
        assert "cek_gadget_ntt" not in tks._cache
        assert isinstance(tks.cek_gadget_ntt, torch.Tensor)
        assert np.array_equal(n_(tks.cek_gadget_ntt), ref.cek_gadget_ntt)
        return
    tks = torch_keygen(torch_make_params("test-bfv", mode="paper"), 3,
                       device=CPU, paper_ecek_weight=0)
    assert tks.cek_gadget_ntt is None
    c, rev = n_(tks.cek), n_(tks.cek_rev)
    q = np.asarray(tks.params.qs)[:, None]
    assert rev.shape == (tks.params.num_towers, tks.params.n)
    assert np.array_equal(rev[:, 0], c[:, 0])
    assert np.array_equal(rev[:, 1:], (-c[:, :0:-1]) % q)


@pytest.mark.parametrize("mode", ["paper", "gadget"])
@pytest.mark.parametrize("profile", sorted(REF_PROFILES))
def test_noise_predict_matches_reference(profile, mode):
    rp = ref_make_params(profile, mode=mode)
    tp = params_to_torch(rp)
    assert (dataclasses.asdict(TN.predict(tp))
            == dataclasses.asdict(RN.predict(rp)))
    for sigmas in (1.0, 6.0):
        assert (TN.compare_is_sound(tp, sigmas)
                == RN.compare_is_sound(rp, sigmas))


def test_keygen_own_samples_roundtrip():
    """The port's own keygen -> encrypt -> decrypt, both schemes."""
    for profile, m in (("test-bfv", np.array([0, 7, -120, 128])),
                       ("test-ckks", np.array([0.5, -3.25, 100.0]))):
        tp = torch_make_params(profile)
        ks = torch_keygen(tp, 3, device=CPU)
        assert ks.device.type == "cpu" and ks.mode == "gadget"
        ct = TE.encrypt(ks, m, 5)
        got = n_(TE.decrypt(ks, ct))
        if tp.profile.scheme == "bfv":
            assert np.array_equal(got, m)
        else:
            assert np.allclose(got, m, atol=1e-3)
        assert int(TE.noise_magnitude(ks, ct, m).max()) < tp.delta_enc // 2


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_encrypt_injected_samples_match_reference(profile, rng):
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    if rp.profile.scheme == "bfv":
        m = rng.integers(-rp.max_operand // 2, rp.max_operand // 2, N_OPERANDS)
    else:
        m = rng.uniform(-50, 50, N_OPERANDS)
    key = jax.random.PRNGKey(21)
    ref = RE.encrypt(ref_ks, jnp.asarray(m), key)
    u, e0, e1 = ref_encrypt_samples(rp, key, (N_OPERANDS,))
    got = TE.encrypt(tks, m, u=np.asarray(u), e0=np.asarray(e0),
                     e1=np.asarray(e1))
    assert np.array_equal(n_(got.c0), ref.c0)
    assert np.array_equal(n_(got.c1), ref.c1)

    # Alg. 3 (FAE): perturbation and e_m injected as well
    k_pert, k_em, k_enc = jax.random.split(key, 3)
    ref = RE.encrypt_fae(ref_ks, jnp.asarray(m), key)
    pert = jax.random.uniform(k_pert, m.shape, dtype=jnp.float64,
                              minval=-rp.epsilon, maxval=rp.epsilon)
    e_m = jax.random.randint(k_em, m.shape, -rp.noise_bound,
                             rp.noise_bound + 1, dtype=jnp.int64)
    u, e0, e1 = ref_encrypt_samples(rp, k_enc, (N_OPERANDS,))
    got = TE.encrypt_fae(tks, m, pert=np.asarray(pert), e_m=np.asarray(e_m),
                         u=np.asarray(u), e0=np.asarray(e0),
                         e1=np.asarray(e1))
    assert np.array_equal(n_(got.c0), ref.c0)
    assert np.array_equal(n_(got.c1), ref.c1)


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_decrypt_bridged_matches_reference(profile, rng):
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    if rp.profile.scheme == "bfv":
        m = rng.integers(-rp.max_operand // 2, rp.max_operand // 2,
                         N_OPERANDS)
    else:
        m = rng.uniform(-50, 50, N_OPERANDS)
    ref_ct = RE.encrypt(ref_ks, jnp.asarray(m), jax.random.PRNGKey(5))
    ct = ct_to_torch(ref_ct)
    want = jax.jit(lambda c, x: (RE.decrypt_raw(ref_ks, c),
                                 RE.decrypt(ref_ks, c),
                                 RE.noise_magnitude(ref_ks, c, x)))(
        ref_ct, jnp.asarray(m))
    got = (TE.decrypt_raw(tks, ct), TE.decrypt(tks, ct),
           TE.noise_magnitude(tks, ct, m))
    for g, w in zip(got, want):
        assert np.array_equal(n_(g), w)


# ---------------------------------------------------------------------------
# gadget + compare
# ---------------------------------------------------------------------------

def test_gadget_matches_reference(bfv_keys, rng):
    tks = ks_to_torch(bfv_keys)
    rp = bfv_keys.params
    c1 = rng.integers(0, np.asarray(rp.qs)[:, None],
                      size=(3, rp.num_towers, rp.n))
    assert np.array_equal(n_(TG.digit_decompose(tks.params, t_(c1))),
                          RG.digit_decompose(rp, jnp.asarray(c1)))
    want = jax.jit(lambda x: RG.gadget_keymul(bfv_keys, x))(jnp.asarray(c1))
    assert np.array_equal(n_(TG.gadget_keymul(tks, t_(c1))), want)


@pytest.mark.parametrize("mode,profile", [
    ("gadget", "test-bfv"), ("gadget", "test-ckks"), ("paper", "test-bfv"),
    ("paper", "test-ckks")])
def test_eval_value_matches_reference(mode, profile, rng):
    if mode == "gadget":
        ref_ks = get_scheme_ks(profile)
    else:
        ref_ks = ref_keygen(ref_make_params(profile, mode="paper"),
                            jax.random.PRNGKey(42), paper_ecek_weight=0)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    if rp.profile.scheme == "bfv":
        a = rng.integers(-60, 60, N_OPERANDS)
    else:                            # half-units: far outside the ckks τ band
        a = np.round(rng.uniform(-60, 60, N_OPERANDS) * 2) / 2
    b = a.copy()
    b[::3] += 1                      # some equal, some one apart
    ct_a = RE.encrypt(ref_ks, jnp.asarray(a), jax.random.PRNGKey(1))
    ct_b = RE.encrypt(ref_ks, jnp.asarray(b), jax.random.PRNGKey(2))
    want = jitted_ref(ref_ks, RC.eval_value)(ct_a, ct_b)
    ta, tb = ct_to_torch(ct_a), ct_to_torch(ct_b)
    got = TC.eval_value(tks, ta, tb)
    assert np.array_equal(n_(got), want)
    # the decodes over the same values
    for eps in (None, 0.5, 2.0):
        assert np.array_equal(n_(TC.three_way(tks, got, eps=eps)),
                              RC.three_way(ref_ks, want, eps=eps))
        assert TC.resolve_tau(tks, eps) == RC.resolve_tau(ref_ks, eps)
    assert np.array_equal(n_(TC.compare_fae(tks, ta, tb)), want > 0)
    if rp.profile.scheme == "bfv":
        assert np.array_equal(n_(TC.compare(tks, ta, tb)), np.sign(a - b))
    # broadcasting: the [2, 1] bound stack of range_query against [N]
    lo, hi = ct_to_torch(RE.encrypt(ref_ks, -10, jax.random.PRNGKey(3))), \
        ct_to_torch(RE.encrypt(ref_ks, 20, jax.random.PRNGKey(4)))
    mask = n_(TC.range_query(tks, ta, lo, hi))
    assert np.array_equal(mask, (a >= -10) & (a <= 20))


def test_pow2_and_network_helpers_match_reference():
    for n in (0, 1, 2, 3, 5, 8, 13, 1000, 34423):
        assert TC.next_pow2(n) == RC.next_pow2(n)
        assert TC.bitonic_compare_count(n) == RC.bitonic_compare_count(n)
    with pytest.raises(ValueError):
        TC.next_pow2(-1)
    for n in (2, 8, 32):
        for (tl, th, ta), (rl, rh, ra) in zip(TC._bitonic_pairs(n),
                                              RC._bitonic_pairs(n)):
            assert np.array_equal(tl, rl) and np.array_equal(th, rh)
            assert np.array_equal(ta, ra)


def test_ckks_helpers_match_reference(ckks_keys):
    rp = ckks_keys.params
    tp = params_to_torch(rp)
    x = np.array([0.0, 1.5, -2.25, 1e-3, 123.456])
    assert np.array_equal(n_(TCK.encode(tp, x)), RCK.encode(rp, x))
    v = np.array([0, 1 << 20, -(1 << 17), 12345])
    assert np.array_equal(n_(TCK.decode(tp, t_(v))), RCK.decode(rp, v))
    assert TCK.equality_tolerance(tp) == RCK.equality_tolerance(rp)
    for eps in (0.0, 1e-6, 0.01, 0.5, 3.0):
        assert TCK.eps_to_tau(tp, eps) == RCK.eps_to_tau(rp, eps)
    with pytest.raises(ValueError):
        TCK.eps_to_tau(tp, -1.0)


@pytest.mark.parametrize("profile", ["test-bfv", "test-ckks"])
def test_sort_topk_match_reference_with_reference_pads(profile, rng):
    """encrypted_sort / encrypted_topk permutations equal the reference's
    on FAE ciphertexts with ties and a sentinel-equal real row, the
    reference's own sentinel pad rows injected."""
    ref_ks = get_scheme_ks(profile)
    tks = ks_to_torch(ref_ks)
    rp = ref_ks.params
    sentinel = rp.max_operand // 2
    vals = rng.integers(-40, 40, 13)
    vals[[2, 9]] = vals[5]                       # FAE ties
    vals[11] = sentinel                          # equals the sort sentinel
    ref_col = RE.encrypt_fae(ref_ks, jnp.asarray(vals), jax.random.PRNGKey(8))
    col = ct_to_torch(ref_col)
    cmp = jitted_ref(ref_ks, RC.compare_fae)
    ref_cmp = lambda _ks, a, b: cmp(a, b)        # noqa: E731
    pads = ref_pad_rows(ref_ks)

    ref_sorted, ref_perm = RC.encrypted_sort(ref_ks, ref_col, ref_cmp)
    got_sorted, got_perm = TC.encrypted_sort(tks, col, pad_rows=pads)
    assert np.array_equal(n_(got_perm), ref_perm)
    assert np.array_equal(n_(got_sorted.c0), ref_sorted.c0)
    assert np.array_equal(n_(got_sorted.c1), ref_sorted.c1)

    for k in (3, 5, 13):
        _, ref_top = RC.encrypted_topk(ref_ks, ref_col, k, ref_cmp)
        _, got_top = TC.encrypted_topk(tks, col, k, pad_rows=pads)
        assert np.array_equal(n_(got_top), ref_top), k
    # a real row equal to the top-k sentinel: ties may fall back to the
    # sort path, which must agree too
    vals2 = vals.copy()
    vals2[4] = -sentinel
    ref_col2 = RE.encrypt_fae(ref_ks, jnp.asarray(vals2),
                              jax.random.PRNGKey(9))
    _, ref_top = RC.encrypted_topk(ref_ks, ref_col2, 13, ref_cmp)
    _, got_top = TC.encrypted_topk(tks, ct_to_torch(ref_col2), 13,
                                   pad_rows=pads)
    assert np.array_equal(n_(got_top), ref_top)
