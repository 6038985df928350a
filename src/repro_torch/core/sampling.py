"""Polynomial samplers (paper §4.2 "Noise in Cryptography").

Every sampler draws from a caller-owned `torch.Generator`, on the
generator's device, with the same ranges as `repro.core.sampling`.  The
streams differ from `jax.random`'s, so callers that must reproduce the
reference's ciphertexts pass the reference's samples in instead (see
`keys.keygen` and `encrypt.encrypt`).

The secret key is ternary, as in the reference (DESIGN deviation §7:
Alg. 1's uniform sk would violate its own line-5 scale condition).
"""
from __future__ import annotations

import torch

from repro_torch.core.params import HadesParams
from repro_torch.core.ring import qs_tensor


def _randint(gen: torch.Generator, low: int, high: int,
             shape: tuple) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen,
                         device=gen.device, dtype=torch.int64)


def uniform_poly(params: HadesParams, gen: torch.Generator,
                 shape: tuple = ()) -> torch.Tensor:
    """Uniform element of R_q (per-tower uniform residues). [..., K, n]."""
    cols = [_randint(gen, 0, q, tuple(shape) + (params.n,))
            for q in params.qs]
    return torch.stack(cols, dim=-2)


def small_to_rns(params: HadesParams, small: torch.Tensor) -> torch.Tensor:
    """Lift a small signed integer poly [..., n] into RNS [..., K, n]."""
    return small[..., None, :] % qs_tensor(params, small.device)[:, None]


def ternary_poly(params: HadesParams, gen: torch.Generator,
                 shape: tuple = ()) -> torch.Tensor:
    """sk / encryption randomness u: coefficients in {-1, 0, 1}."""
    return small_to_rns(params, _randint(gen, -1, 2,
                                         tuple(shape) + (params.n,)))


def noise_poly(params: HadesParams, gen: torch.Generator,
               shape: tuple = (), bound: int | None = None) -> torch.Tensor:
    """e ~ U(-B_e, B_e)^n per the paper."""
    b = params.noise_bound if bound is None else bound
    return small_to_rns(params, _randint(gen, -b, b + 1,
                                         tuple(shape) + (params.n,)))


def small_signed(gen: torch.Generator, shape: tuple,
                 bound: int) -> torch.Tensor:
    """Small signed integers (NOT lifted to RNS) — used for perturbations."""
    return _randint(gen, -bound, bound + 1, tuple(shape))


def make_generator(seed, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with `seed` (an int); a
    Generator passed as `seed` is returned as it is."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
