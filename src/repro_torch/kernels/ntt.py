"""Negacyclic NTT kernels: the fused multiply and the bit-reversed-order
transform, each beside its plain version.

`negacyclic_mul(a, b, ring)` computes a ⊛ b over [..., K, n] int64
residues (batch dims broadcast): pre-twist, DIF stages (natural ->
bit-reversed), pointwise product, DIT stages (bit-reversed -> natural),
post-twist.  `negacyclic_mul_ntt(a, b_br, ring)` is the same product with
b one polynomial already transformed (`b_br = ntt_br(b)`, a key cached
once per KeySet: `KeySet.key_br`), so each row costs two transforms, not
three.  `ntt_br(x, ring, fwd=...)` is the forward half (pre-twist + DIF,
natural -> bit-reversed) or the inverse half (DIT + post-twist,
bit-reversed -> natural) on its own.  On CUDA tensors they launch
`csrc/ntt.cu` (the port of the reference's Pallas `_mul_kernel`,
`_ntt_kernel` and `_intt_kernel`); on CPU tensors they run the `_plain`
versions, the same schedule in PyTorch.  Inputs must be residues in
[0, q).
"""
from __future__ import annotations

import math
from typing import Optional

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


def ntt_br_plain(x: torch.Tensor, ring: R.Ring, *,
                 fwd: bool = True) -> torch.Tensor:
    """The kernel's function in PyTorch (any device; CPU in production)."""
    q, n = ring.q_arr, ring.n
    if fwd:
        return _fwd_stages((x * ring.psi_pow) % q, ring.stage_w, q, n)
    return (_inv_stages(x, ring.stage_w_inv, q, n) * ring.psi_inv_pow) % q


def negacyclic_mul_ntt_plain(a: torch.Tensor, b_br: torch.Tensor,
                             ring: R.Ring) -> torch.Tensor:
    """The kernel's function in PyTorch (any device; CPU in production)."""
    prod = (ntt_br_plain(a, ring) * b_br) % ring.q_arr
    return ntt_br_plain(prod, ring, fwd=False)


def _check_poly(x: torch.Tensor, ring: R.Ring) -> None:
    K, n = ring.num_towers, ring.n
    if x.dtype != torch.int64 or tuple(x.shape[-2:]) != (K, n):
        raise ValueError(f"expected int64 [..., {K}, {n}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != ring.device:
        raise ValueError(f"operand on {x.device}, ring on {ring.device}")


def ntt_br(x: torch.Tensor, ring: R.Ring, *, fwd: bool = True
           ) -> torch.Tensor:
    """Forward (natural -> bit-reversed, with the psi pre-twist) or
    inverse (bit-reversed -> natural, with the psi^-1 n^-1 post-twist)
    negacyclic NTT over [..., K, n]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check_poly(x, ring)
    if not x.is_cuda:
        return ntt_br_plain(x, ring, fwd=fwd)
    K, n = ring.num_towers, ring.n
    rows = math.prod(x.shape[:-2])
    src = x.reshape(rows, K, n).contiguous()
    out = torch.empty_like(src)
    lib = _build.load("ntt")
    with _build.on_device(x.device.index):
        rc = lib.hades_ntt_br(src.data_ptr(), out.data_ptr(), rows,
                              ring.shoup.data_ptr(), ring.q_arr.data_ptr(),
                              K, n, int(fwd), _build.stream_handle(x.device))
    _build.check(rc, "ntt_br")
    if rows:
        _build.count_launch("ntt_br_fwd" if fwd else "ntt_br_inv")
    return out.reshape(x.shape)


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
        _check_poly(x, ring)
    if not a.is_cuda:
        return negacyclic_mul_plain(a, b, ring)
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    rows = math.prod(batch)
    pa, sa = _operand(a, batch, K, n)
    pb, sb = _operand(b, batch, K, n)
    out = torch.empty((rows, K, n), dtype=torch.int64, device=a.device)
    lib = _build.load("ntt")
    with _build.on_device(a.device.index):
        rc = lib.hades_negacyclic_mul(
            pa.data_ptr(), sa, pb.data_ptr(), sb, out.data_ptr(), rows,
            ring.shoup.data_ptr(), ring.q_arr.data_ptr(), K, n,
            _build.stream_handle(a.device))
    _build.check(rc, "negacyclic_mul")
    if rows:
        _build.count_launch("negacyclic_mul")
    return out.reshape(batch + (K, n))


def negacyclic_mul_ntt(a: torch.Tensor, b_br: torch.Tensor, ring: R.Ring,
                       b_shoup: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """a ⊛ b over [..., K, n] for one polynomial b given as its forward
    transform b_br = ntt_br(b) ([K, n] or with leading dims of size 1):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    b_shoup is b_br's Shoup pairs (`R.shoup_pairs`), made here when not
    given; `KeySet.key_br` caches both once per key."""
    K, n = ring.num_towers, ring.n
    for x in (a, b_br):
        _check_poly(x, ring)
    if math.prod(b_br.shape[:-2]) != 1:
        raise ValueError(f"b_br must be one polynomial, got "
                         f"{tuple(b_br.shape)}")
    if not a.is_cuda:
        return negacyclic_mul_ntt_plain(a, b_br, ring)
    if b_shoup is None:
        b_shoup = R.shoup_pairs(b_br.reshape(K, n), ring.q_arr)
    if b_shoup.dtype != torch.int32 or b_shoup.numel() != 2 * K * n \
            or b_shoup.device != a.device:
        raise ValueError("b_shoup is not b_br's [K, n, 2] int32 pairs")
    batch = tuple(a.shape[:-2])
    rows = math.prod(batch)
    pa, sa = _operand(a, batch, K, n)
    key = b_shoup.contiguous()
    out = torch.empty((rows, K, n), dtype=torch.int64, device=a.device)
    lib = _build.load("ntt")
    with _build.on_device(a.device.index):
        rc = lib.hades_negacyclic_mul_ntt(
            pa.data_ptr(), sa, key.data_ptr(), out.data_ptr(), rows,
            ring.shoup.data_ptr(), ring.q_arr.data_ptr(), K, n,
            _build.stream_handle(a.device))
    _build.check(rc, "negacyclic_mul_ntt")
    if rows:
        _build.count_launch("negacyclic_mul_ntt")
    return out.reshape(batch + (K, n))
