"""Encryption / decryption (LPR public-key RLWE) + Algorithm 3 (FAE).

Encoding as in `repro.core.encrypt`: operands live in the constant
coefficient, payload = Δ_enc * m (BFV: m integer; CKKS: m real, payload =
round(m * Δ_enc), round half to even in both frameworks).

pk0⊛u, pk1⊛u and c1⊛sk run through `kernels.ntt.negacyclic_mul_ntt`
against the key's transform, made once per key set (`KeySet.key_br`):
the fused multiply kernel on CUDA tensors, two transforms per row.  A
large batch is encrypted in row chunks, so the sampled u/e0/e1 of one
chunk — not of the whole column — are alive at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ring as R
from repro_torch.core import sampling
from repro_torch.core.keys import KeySet
from repro_torch.core.params import HadesParams

# rows per encryption chunk when the samples are drawn here: u, e0, e1
# and the two products of one chunk are ~5 x 537 MB at paper-bfv; a
# larger ring keeps a chunk's bytes (`enc_chunk_rows`: 2,048 rows at
# paper-ckks, n = 16,384, where 8,192 rows held ~16 GiB of temporaries)
ENC_CHUNK_ROWS = 8192
ENC_CHUNK_ELEMS = ENC_CHUNK_ROWS * 2 * 4096


def enc_chunk_rows(params: HadesParams) -> int:
    """Rows per encryption (and decryption) chunk under `params`:
    ENC_CHUNK_ROWS, or fewer where [rows, K, n] would pass
    ENC_CHUNK_ELEMS."""
    return max(1, min(ENC_CHUNK_ROWS,
                      ENC_CHUNK_ELEMS // (params.num_towers * params.n)))


class Ciphertext(NamedTuple):
    """RLWE ciphertext (c0, c1), each [..., K, n]."""
    c0: torch.Tensor
    c1: torch.Tensor

    def __sub__(self, other: "Ciphertext") -> "Ciphertext":
        raise TypeError("use compare.ct_sub(ring, a, b) — needs the modulus")

    @classmethod
    def from_numpy(cls, c0, c1, device=None) -> "Ciphertext":
        """A ciphertext over given residue arrays (e.g. a reference
        ciphertext's components through `np.asarray`)."""
        dev = R.resolve_device(device)
        return cls(R.int64_tensor(c0, dev), R.int64_tensor(c1, dev))


def _payload(params: HadesParams, m: torch.Tensor) -> torch.Tensor:
    """Scaled plaintext payload (integer, possibly negative). m: [...]."""
    if params.profile.scheme == "bfv":
        return m.to(torch.int64) * params.delta_enc
    return torch.round(m.to(torch.float64) * params.delta_enc).to(torch.int64)


def _as_operand(ks: KeySet, m, dtype=None) -> torch.Tensor:
    """m (tensor, array or scalar) as a tensor on the KeySet's device."""
    if not isinstance(m, torch.Tensor):
        m = torch.from_numpy(np.array(m))
    return m.to(device=ks.device, dtype=dtype or m.dtype)


def _key_mul(ks: KeySet, x: torch.Tensor, name: str) -> torch.Tensor:
    """x ⊛ key `name`, against the key's cached transform."""
    from repro_torch.kernels import ntt as NK      # NK imports core.ring
    br, pairs = ks.key_br(name)
    return NK.negacyclic_mul_ntt(x, br, ks.ring, pairs)


def _encrypt_rows(ks: KeySet, payload, u, e0, e1) -> Ciphertext:
    rng = ks.ring
    m_poly = R.const_poly(ks.params, payload)
    c0 = R.add(rng, R.add(rng, _key_mul(ks, u, "pk0"), e0), m_poly)
    c1 = R.add(rng, _key_mul(ks, u, "pk1"), e1)
    return Ciphertext(c0, c1)


def _encrypt_payload(ks: KeySet, payload: torch.Tensor, seed, *,
                     u=None, e0=None, e1=None) -> Ciphertext:
    """payload: [...] integer -> ct with batch shape [...]."""
    params = ks.params
    if u is not None:
        return _encrypt_rows(ks, payload, *(_as_operand(ks, x, torch.int64)
                                            for x in (u, e0, e1)))
    gen = sampling.make_generator(seed, ks.device)
    batch = tuple(payload.shape)
    flat = payload.reshape(-1)
    K, n = params.num_towers, params.n
    c0 = torch.empty((flat.shape[0], K, n), dtype=torch.int64,
                     device=ks.device)
    c1 = torch.empty_like(c0)
    step = enc_chunk_rows(params)
    for lo in range(0, flat.shape[0], step):
        p = flat[lo:lo + step]
        shape = (p.shape[0],)
        u = sampling.ternary_poly(params, gen, shape)
        e0 = sampling.noise_poly(params, gen, shape)
        e1 = sampling.noise_poly(params, gen, shape)
        ct = _encrypt_rows(ks, p, u, e0, e1)
        c0[lo:lo + p.shape[0]] = ct.c0
        c1[lo:lo + p.shape[0]] = ct.c1
    return Ciphertext(c0.reshape(batch + (K, n)), c1.reshape(batch + (K, n)))


def encrypt(ks: KeySet, m, seed=0, *, u=None, e0=None,
            e1=None) -> Ciphertext:
    """Basic encryption (EncBasic). m: scalar or batch of operands.

    `seed` is an int or a `torch.Generator` on the KeySet's device; or
    pass all of u, e0, e1 ([..., K, n] residues) pre-drawn."""
    m = _as_operand(ks, m)
    return _encrypt_payload(ks, _payload(ks.params, m), seed,
                            u=u, e0=e0, e1=e1)


def encrypt_fae(ks: KeySet, m, seed=0, *, pert=None, e_m=None, u=None,
                e0=None, e1=None) -> Ciphertext:
    """Algorithm 3: perturbation-aware encryption (EncFAE).

    line 2: m_scaled = m * Δ_enc
    line 3: Δ_m ~ U(-ε, ε)                (`pert`, plaintext units, float64)
    line 4: m_perturbed = m_scaled + Δ_m * Δ_enc
    line 5/6: + e_m                        (`e_m`, extra bounded noise)
    line 7: Encrypt(pk, ·)
    """
    params = ks.params
    m = _as_operand(ks, m)
    gen = None
    if pert is None or e_m is None or u is None:
        gen = sampling.make_generator(seed, ks.device)
    if pert is None:
        pert = (torch.rand(m.shape, dtype=torch.float64, generator=gen,
                           device=ks.device) * (2 * params.epsilon)
                - params.epsilon)
    if e_m is None:
        e_m = sampling.small_signed(gen, tuple(m.shape), params.noise_bound)
    pert = _as_operand(ks, pert, torch.float64)
    e_m = _as_operand(ks, e_m, torch.int64)
    pert_int = torch.round(pert * params.delta_enc).to(torch.int64)
    return _encrypt_payload(ks, _payload(params, m) + pert_int + e_m,
                            gen, u=u, e0=e0, e1=e1)


def decrypt_raw(ks: KeySet, ct: Ciphertext) -> torch.Tensor:
    """Centered phase of coefficient 0: Δ_enc*m + noise.  [...] int64."""
    rng = ks.ring
    phase = R.add(rng, ct.c0, _key_mul(ks, ct.c1, "sk"))
    return R.crt_centered(ks.params, phase[..., :, 0])


def decrypt(ks: KeySet, ct: Ciphertext) -> torch.Tensor:
    """Recover m (exact for BFV given |noise| < Δ_enc/2; approx for CKKS)."""
    v = decrypt_raw(ks, ct)
    params = ks.params
    if params.profile.scheme == "bfv":
        half = params.delta_enc // 2
        return torch.div(v + half, params.delta_enc, rounding_mode="floor")
    return v.to(torch.float64) / params.delta_enc


def noise_magnitude(ks: KeySet, ct: Ciphertext, m) -> torch.Tensor:
    """|phase - Δ_enc*m|: the live noise budget of a ciphertext."""
    v = decrypt_raw(ks, ct)
    return torch.abs(v - _payload(ks.params, _as_operand(ks, m)))
