"""HADES parameter selection (paper §4.2, §6.1).

A verbatim copy of `repro.core.params` (pure Python and numpy): importing
the reference module would import JAX through `repro/core/__init__.py`,
and this package never does.

The paper's OpenFHE deployment uses BFV (n=4096, t=65537) and CKKS (n=16384)
with multi-limb ~60-bit moduli.  We keep every residue below 2^31 so a
product of two residues fits in a signed int64 multiply-accumulate, and reach
the paper's dynamic range with a 2-tower RNS modulus Q = q0*q1 ~ 2^62
(DESIGN.md §3).  All moduli are NTT-friendly primes (q ≡ 1 mod 2n).

Headroom algebra for the compare path (DESIGN.md §1.1/§1.2):

    Eval = scale * (Δ_enc*(m0-m1) + e_enc) + e_key-switch      (mod Q)

so correctness needs
    scale * Δ_enc * max|m0-m1|  <  Q/2            (no wrap)
    |scale*e_enc + e_ks|        <  scale*Δ_enc/2  (τ threshold separates 0/±1)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# prime / root-of-unity machinery (host-side, pure python ints)
# ---------------------------------------------------------------------------

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(n: int, count: int, max_bits: int = 31) -> Tuple[int, ...]:
    """Largest `count` primes q < 2^max_bits with q ≡ 1 (mod 2n)."""
    two_n = 2 * n
    q = ((1 << max_bits) // two_n) * two_n + 1
    out = []
    while len(out) < count and q > two_n:
        if q < (1 << max_bits) and is_prime(q):
            out.append(q)
        q -= two_n
    if len(out) < count:
        raise ValueError(f"not enough NTT primes for n={n}")
    return tuple(out)


def _primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    phi = q - 1
    factors = []
    m = phi
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no generator found")


@functools.lru_cache(maxsize=None)
def negacyclic_root(q: int, n: int) -> int:
    """psi: a primitive 2n-th root of unity mod q (psi^n = -1)."""
    g = _primitive_root(q)
    psi = pow(g, (q - 1) // (2 * n), q)
    assert pow(psi, n, q) == q - 1, "psi^n != -1"
    return psi


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------

CompareKeyMode = Literal["paper", "gadget"]
Scheme = Literal["bfv", "ckks"]


@dataclasses.dataclass(frozen=True)
class Profile:
    """A named parameter profile. `paper-bfv`/`paper-ckks` match §6.1."""

    name: str
    scheme: Scheme
    n: int                    # ring dimension
    num_towers: int           # RNS towers (31-bit primes)
    t: int                    # BFV plaintext modulus (ignored for ckks)
    log_delta_enc: int        # encoding scale Δ_enc = 2^log_delta_enc
    log_scale: int            # HADES `scale` parameter (paper: [1e2, 1e4])
    noise_bound: int          # B_e: coefficients of e ~ U(-B_e, B_e)
    epsilon: float            # FAE perturbation range (paper: [1e-3, 1e-2])
    gadget_log_base: int      # digit base B = 2^gadget_log_base (gadget mode)
    # equality threshold: BFV uses the integer semantics tau = s*Δ/2
    # (min nonzero diff is 1); CKKS uses precision semantics — values
    # within 2^-equality_bits count as equal (must stay above the noise
    # floor; noise.py checks).  0 = integer semantics.
    equality_bits: int = 0


PROFILES = {
    # Paper §6.1: BFV with n=4096, t=65537, 128-bit-class ring. 2 RNS towers
    # stand in for OpenFHE's 60-bit limbs (DESIGN.md §3, §7).
    "paper-bfv": Profile(
        name="paper-bfv", scheme="bfv", n=4096, num_towers=2, t=65537,
        log_delta_enc=13, log_scale=12, noise_bound=2, epsilon=0.01,
        gadget_log_base=8,
    ),
    # Paper §6.1: CKKS with n=16384, scaling modulus ~2^59 -> Δ_enc=2^20 here.
    "paper-ckks": Profile(
        name="paper-ckks", scheme="ckks", n=16384, num_towers=2, t=0,
        log_delta_enc=20, log_scale=12, noise_bound=2, epsilon=0.01,
        gadget_log_base=8, equality_bits=7,
    ),
    # Small profiles for unit tests / CI (single tower).
    "test-bfv": Profile(
        name="test-bfv", scheme="bfv", n=256, num_towers=1, t=257,
        log_delta_enc=9, log_scale=6, noise_bound=1, epsilon=0.01,
        gadget_log_base=6,
    ),
    "test-ckks": Profile(
        name="test-ckks", scheme="ckks", n=512, num_towers=2, t=0,
        log_delta_enc=16, log_scale=10, noise_bound=1, epsilon=0.01,
        gadget_log_base=8, equality_bits=6,
    ),
    # Mid-size profile for benchmarks where n=4096 x 2 towers is overkill.
    "bench-bfv": Profile(
        name="bench-bfv", scheme="bfv", n=1024, num_towers=2, t=65537,
        log_delta_enc=13, log_scale=12, noise_bound=2, epsilon=0.01,
        gadget_log_base=8,
    ),
}


@dataclasses.dataclass(frozen=True)
class HadesParams:
    """Fully-resolved parameters + precomputed NTT tables (host numpy).

    Device code receives the numpy tables as jnp arrays; this object itself
    is static (hashable) and can be closed over by jit.
    """

    profile: Profile
    mode: CompareKeyMode
    qs: Tuple[int, ...]                  # RNS towers

    # -- derived ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.profile.n

    @property
    def num_towers(self) -> int:
        return self.profile.num_towers

    @property
    def Q(self) -> int:
        out = 1
        for q in self.qs:
            out *= q
        return out

    @property
    def t(self) -> int:
        return self.profile.t

    @property
    def delta_enc(self) -> int:
        return 1 << self.profile.log_delta_enc

    @property
    def scale(self) -> int:
        return 1 << self.profile.log_scale

    @property
    def noise_bound(self) -> int:
        return self.profile.noise_bound

    @property
    def epsilon(self) -> float:
        return self.profile.epsilon

    @property
    def gadget_base(self) -> int:
        return 1 << self.profile.gadget_log_base

    @property
    def gadget_digits_per_tower(self) -> int:
        bits = max(q.bit_length() for q in self.qs)
        b = self.profile.gadget_log_base
        return -(-bits // b)  # ceil

    @property
    def tau(self) -> int:
        """Decode threshold τ (paper Alg. 2 line 5).  BFV: scale*Δ_enc/2
        (integer tie semantics); CKKS: scale*Δ_enc*2^-equality_bits."""
        if self.profile.equality_bits:
            return (self.scale * self.delta_enc
                    ) >> self.profile.equality_bits
        return (self.scale * self.delta_enc) // 2

    @property
    def max_operand(self) -> int:
        """Largest |m0 - m1| the compare path supports without wrap."""
        return self.Q // (2 * self.scale * self.delta_enc) - 1

    # -- NTT tables ------------------------------------------------------
    def ntt_tables(self) -> "NttTables":
        return make_ntt_tables(self.qs, self.n)

    # -- CRT constants for decode ---------------------------------------
    def crt_alphas(self) -> Tuple[int, ...]:
        """alpha_k = (Q/q_k) * [(Q/q_k)^-1 mod q_k]  (mod Q)."""
        Q = self.Q
        out = []
        for q in self.qs:
            m = Q // q
            out.append((m * pow(m % q, q - 2, q)) % Q)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class NttTables:
    """Per-tower twiddle tables, host numpy (converted to device by callers).

    Layout (K towers, ring dim n, S = log2 n stages):
      psi_pow      [K, n]  psi^i            (negacyclic pre-twist)
      psi_inv_pow  [K, n]  psi^-i * n^-1    (post-twist, n^-1 folded in)
      stage_w      [K, S, n//2] per-stage butterfly twiddles (DIT layout)
      stage_w_inv  [K, S, n//2] inverse-NTT stage twiddles (DIF layout)
      bitrev       [n]
    """

    qs: Tuple[int, ...]
    n: int
    psi_pow: np.ndarray
    psi_inv_pow: np.ndarray
    stage_w: np.ndarray
    stage_w_inv: np.ndarray
    bitrev: np.ndarray


@functools.lru_cache(maxsize=None)
def make_ntt_tables(qs: Sequence[int], n: int) -> NttTables:
    qs = tuple(qs)
    stages = n.bit_length() - 1
    K = len(qs)
    psi_pow = np.zeros((K, n), dtype=np.int64)
    psi_inv_pow = np.zeros((K, n), dtype=np.int64)
    stage_w = np.zeros((K, stages, n // 2), dtype=np.int64)
    stage_w_inv = np.zeros((K, stages, n // 2), dtype=np.int64)
    for k, q in enumerate(qs):
        psi = negacyclic_root(q, n)
        psi_inv = pow(psi, q - 2, q)
        omega = psi * psi % q          # primitive n-th root
        omega_inv = pow(omega, q - 2, q)
        n_inv = pow(n, q - 2, q)
        acc = 1
        for i in range(n):
            psi_pow[k, i] = acc
            acc = acc * psi % q
        acc = n_inv
        for i in range(n):
            psi_inv_pow[k, i] = acc
            acc = acc * psi_inv % q
        # Stage s of a DIT NTT on bit-reversed input: half-block size
        # h = 2^s; twiddle for in-block position j is omega^(j * n / (2h)).
        for s in range(stages):
            h = 1 << s
            wbase = pow(omega, n // (2 * h), q)
            wbase_inv = pow(omega_inv, n // (2 * h), q)
            w = np.zeros(n // 2, dtype=np.int64)
            wi = np.zeros(n // 2, dtype=np.int64)
            for j in range(n // 2):
                e = j % h
                w[j] = pow(wbase, e, q)
                wi[j] = pow(wbase_inv, e, q)
            stage_w[k, s] = w
            stage_w_inv[k, s] = wi
    return NttTables(
        qs=qs, n=n,
        psi_pow=psi_pow, psi_inv_pow=psi_inv_pow,
        stage_w=stage_w, stage_w_inv=stage_w_inv,
        bitrev=bit_reverse_perm(n),
    )


def make_params(profile: str | Profile = "paper-bfv",
                mode: CompareKeyMode = "gadget") -> HadesParams:
    prof = PROFILES[profile] if isinstance(profile, str) else profile
    qs = ntt_primes(prof.n, prof.num_towers)
    return HadesParams(profile=prof, mode=mode, qs=qs)
