"""RNS-gadget CEK evaluation (mode="gadget"), plain PyTorch.

Digit-decomposes ctΔ,1 before it meets the CEK, so the key-noise term
stays bounded by K*D * sqrt(n) * B * B_e instead of wrapping mod Q:

    ctΔ,1  =  Σ_{k,j}  d_{k,j} · B^j · alpha_k,   ||d_{k,j}||_inf < B
    Σ_{k,j}  d_{k,j} ⊛ cek[k,j]  =  ctΔ,1 · sk · scale  +  Σ d⊛e   (mod Q)

This is the reference's NTT schedule (forward-NTT the K*D digit polys,
MAC against the eval-domain CEK, one inverse NTT), used on CPU tensors.
The Eval kernel (`kernels/cmp_eval.py`) computes only coefficient 0 of
the same sum, as a dot product against the reversed CEK.
"""
from __future__ import annotations

import torch

from repro_torch.core import ring as R
from repro_torch.core.keys import KeySet
from repro_torch.core.params import HadesParams


def digit_decompose(params: HadesParams, c1: torch.Tensor) -> torch.Tensor:
    """c1: [..., K, n] residues -> digits [..., K, D, n] in [0, B)."""
    D = params.gadget_digits_per_tower
    shifts = torch.arange(D, dtype=torch.int64, device=c1.device) \
        * params.profile.gadget_log_base
    return (c1[..., :, None, :] >> shifts[:, None]) & (params.gadget_base - 1)


def gadget_keymul(ks: KeySet, c1: torch.Tensor) -> torch.Tensor:
    """c1 · sk · scale + (bounded noise) via the gadget CEK.
    c1: [..., K, n] -> [..., K, n]."""
    params, rng = ks.params, ks.ring
    K, n = params.num_towers, params.n
    D = params.gadget_digits_per_tower
    digits = digit_decompose(params, c1)                 # [..., K, D, n]
    # a digit is < B, so its residue is the digit in every tower:
    # [..., K_src, D, K_tower, n]
    dig_rns = digits[..., :, :, None, :].expand(
        digits.shape[:-1] + (K, n))
    flat = dig_rns.reshape(dig_rns.shape[:-4] + (K * D, K, n))
    dig_ntt = R.ntt(rng, flat)                           # [..., K*D, K, n]
    cek_ntt = ks.cek_gadget_ntt.reshape(K * D, K, n)
    prod = (dig_ntt * cek_ntt) % rng.q_arr
    return R.intt(rng, prod.sum(dim=-3) % rng.q_arr)
