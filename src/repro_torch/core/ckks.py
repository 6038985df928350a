"""CKKS-profile helpers (paper §6.1: floating-point operands).

The compare pipeline is scheme-agnostic once operands are fixed-point
encoded; this module holds the float encode/decode contract and the
approximate-equality threshold used by Alg. 2's τ in the CKKS profile.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import HadesParams


def encode(params: HadesParams, x) -> torch.Tensor:
    """Real -> fixed-point payload units (what encrypt._payload does)."""
    return torch.round(torch.as_tensor(x, dtype=torch.float64)
                       * params.delta_enc).to(torch.int64)


def decode(params: HadesParams, v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64) / params.delta_enc


def equality_tolerance(params: HadesParams) -> float:
    """Smallest |x0 - x1| the CKKS profile can distinguish from equality:
    below this, Alg. 2 returns 0 (approximate equality) by design."""
    return params.tau / (params.scale * params.delta_enc)


def eps_to_tau(params: HadesParams, eps: float) -> int:
    """Plaintext-units tolerance ε -> integer eval-domain threshold
    τ_ε = ε·scale·Δ_enc, clamped from below to the profile's own τ (an ε
    inside the noise floor degrades to the native equality semantics)."""
    if eps < 0:
        raise ValueError(f"epsilon must be non-negative, got {eps}")
    return max(int(round(eps * params.scale * params.delta_enc)), params.tau)
