"""Noise-budget accounting: the §4.4 correctness predicates, checkable.

These are *predictions* (worst-case and 6-sigma estimates) used by tests and
by EXPERIMENTS.md's noise ablation; `encrypt.noise_magnitude` measures the
real thing.  A copy of `repro.core.noise` (pure Python over the params).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.params import HadesParams


@dataclasses.dataclass(frozen=True)
class NoiseBudget:
    fresh_worst: float          # worst-case |phase - Δ_enc m| after encrypt
    fresh_sigma: float          # ~std of the same
    eval_worst: float           # worst-case |eval noise| (compare path)
    eval_sigma: float
    tau: int                    # decode threshold
    headroom_bits: float        # log2( (scale*Δ_enc/2) / 6*eval_sigma )


def predict(params: HadesParams) -> NoiseBudget:
    n, B = params.n, params.noise_bound
    # fresh encryption noise coeff0: e0 + e1*sk + u*e_pk (+ e_m for FAE)
    # each cross term is a sum of n products (bounded B) * ternary(2/3 mass)
    var_term = n * (2.0 / 3.0) * (B * (B + 1) / 3.0)   # var of e*ternary sum
    fresh_var = (B * (B + 1) / 3.0) + 2 * var_term
    fresh_sigma = math.sqrt(fresh_var)
    fresh_worst = B + 2 * n * B

    scale = params.scale
    if params.mode == "paper":
        # <e_cek, ctΔ,1>: ctΔ,1 uniform mod q — worst/typ are both ~q/2·n·B;
        # report the honest (catastrophic) figure (DESIGN.md §1.1).
        q_half = max(params.qs) / 2
        ks_sigma = math.sqrt(n * (2.0 / 3.0)) * q_half * math.sqrt(B * (B + 1) / 3.0)
        ks_worst = n * q_half * B
    else:
        K = params.num_towers
        D = params.gadget_digits_per_tower
        Bg = params.gadget_base
        # K*D inner products of digit(<Bg) x noise(B) over n coeffs
        ks_var = K * D * n * ((Bg ** 2) / 12.0) * (B * (B + 1) / 3.0)
        ks_sigma = math.sqrt(ks_var)
        ks_worst = K * D * n * Bg * B

    eval_sigma = math.sqrt((scale * fresh_sigma * math.sqrt(2)) ** 2
                           + ks_sigma ** 2)
    eval_worst = scale * 2 * fresh_worst + ks_worst
    tau = params.tau
    headroom = math.log2(max(tau / (6 * eval_sigma), 1e-30))
    return NoiseBudget(fresh_worst=fresh_worst, fresh_sigma=fresh_sigma,
                       eval_worst=eval_worst, eval_sigma=eval_sigma,
                       tau=tau, headroom_bits=headroom)


def compare_is_sound(params: HadesParams, sigmas: float = 6.0) -> bool:
    """True if the compare path separates 0 from ±1 at `sigmas` confidence."""
    b = predict(params)
    return b.tau > sigmas * b.eval_sigma
