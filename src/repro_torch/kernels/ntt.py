"""Fused negacyclic multiply: the CUDA kernel and its plain version.

`negacyclic_mul(a, b, ring)` computes a ⊛ b over [..., K, n] int64
residues (batch dims broadcast).  On CUDA tensors it launches
`csrc/ntt.cu` (the port of the reference's Pallas `_mul_kernel`); on CPU
tensors it runs `negacyclic_mul_plain`, the same schedule in PyTorch:
pre-twist, DIF stages (natural -> bit-reversed), pointwise product, DIT
stages (bit-reversed -> natural), post-twist.  Inputs must be residues
in [0, q).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import ring as R
from repro_torch.kernels import _build


def _fwd_stages(x: torch.Tensor, stage_w: torch.Tensor, q: torch.Tensor,
                n: int) -> torch.Tensor:
    """DIF butterflies: natural order in -> bit-reversed out. x: [..., K, n]."""
    qb = q[..., None]                                   # [K, 1, 1]
    for s in reversed(range(n.bit_length() - 1)):
        h = 1 << s
        w = stage_w[:, s, :h][:, None, :]               # [K, 1, h]
        xr = x.reshape(x.shape[:-1] + (n // (2 * h), 2 * h))
        u, v = xr[..., :h], xr[..., h:]
        x = torch.cat([(u + v) % qb, ((u - v) * w) % qb],
                      dim=-1).reshape(x.shape)
    return x


def _inv_stages(x: torch.Tensor, stage_w_inv: torch.Tensor, q: torch.Tensor,
                n: int) -> torch.Tensor:
    """DIT butterflies: bit-reversed order in -> natural out."""
    qb = q[..., None]
    for s in range(n.bit_length() - 1):
        h = 1 << s
        w = stage_w_inv[:, s, :h][:, None, :]
        xr = x.reshape(x.shape[:-1] + (n // (2 * h), 2 * h))
        u, v = xr[..., :h], xr[..., h:]
        t = (v * w) % qb
        x = torch.cat([(u + t) % qb, (u - t) % qb], dim=-1).reshape(x.shape)
    return x


def negacyclic_mul_plain(a: torch.Tensor, b: torch.Tensor,
                         ring: R.Ring) -> torch.Tensor:
    """The kernel's function in PyTorch (any device; CPU in production)."""
    q, n = ring.q_arr, ring.n
    a, b = torch.broadcast_tensors(a, b)
    a = _fwd_stages((a * ring.psi_pow) % q, ring.stage_w, q, n)
    b = _fwd_stages((b * ring.psi_pow) % q, ring.stage_w, q, n)
    out = _inv_stages((a * b) % q, ring.stage_w_inv, q, n)
    return (out * ring.psi_inv_pow) % q


def _operand(x: torch.Tensor, batch: tuple, K: int, n: int):
    """x as rows of K*n contiguous int64, and its batch stride (0 when
    one polynomial serves every row)."""
    if math.prod(x.shape[:-2]) == 1:
        return x.reshape(K, n).contiguous(), 0
    x = x.expand(batch + (K, n)).reshape(-1, K, n).contiguous()
    return x, K * n


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor,
                   ring: R.Ring) -> torch.Tensor:
    """a ⊛ b over [..., K, n]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    K, n = ring.num_towers, ring.n
    for x in (a, b):
        if x.dtype != torch.int64 or tuple(x.shape[-2:]) != (K, n):
            raise ValueError(f"expected int64 [..., {K}, {n}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if a.device != b.device or a.device != ring.device:
        raise ValueError(f"operands on {a.device}/{b.device}, ring on "
                         f"{ring.device}")
    if not a.is_cuda:
        return negacyclic_mul_plain(a, b, ring)
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    rows = math.prod(batch)
    pa, sa = _operand(a, batch, K, n)
    pb, sb = _operand(b, batch, K, n)
    out = torch.empty((rows, K, n), dtype=torch.int64, device=a.device)
    lib = _build.load("ntt")
    rc = lib.hades_negacyclic_mul(
        pa.data_ptr(), sa, pb.data_ptr(), sb, out.data_ptr(), rows,
        ring.psi_pow.data_ptr(), ring.psi_inv_pow.data_ptr(),
        ring.stage_w.data_ptr(), ring.stage_w_inv.data_ptr(),
        ring.q_arr.data_ptr(), K, n, _build.stream_handle(a.device))
    _build.check(rc, "negacyclic_mul")
    if rows:
        _build.count_launch("negacyclic_mul")
    return out.reshape(batch + (K, n))
