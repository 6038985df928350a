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

`ntt_br` launches one of two forms of the same schedule, chosen by
`plan` from the number of (polynomial, tower) items and the card's SM
count and shared memory (read once per card): at n >= 16,384 with fewer
items than SMs, the narrow form, each item split over the CLUSTER blocks
of a thread-block cluster; otherwise the wide form, a resident grid of
blocks walking the items (one block per item below a wave), with the
next row's coefficients copied into shared memory while the current one
runs (the inverse always, the forward at n <= 4,096 from two items a
block).  The output is the same in either form.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

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


class Plan(NamedTuple):
    """An `ntt_br` launch: `cluster` CLUSTER, the narrow form, with
    `depth` 0; or `cluster` 0, the wide form, with `depth` rows staged
    ahead a block (0 or 1)."""
    cluster: int
    depth: int


CLUSTER = 8                 # blocks of the narrow form (ntt.cu kCluster)
CLUSTER_MIN_N = 16384       # the least degree it splits few items at
WIDE_BLOCKS_PER_SM = 2      # the wide kernel's blocks a SM (launch bounds)


def wide_smem(n: int, depth: int) -> int:
    """Bytes of shared memory a wide-form block takes at degree n."""
    return depth * 8 * n + 4 * (n + n // 32)


def wide_depth(n: int, fwd: bool, items: int, sms: int,
               smem_limit: int) -> Optional[int]:
    """Rows the wide form stages ahead for `items` items of degree n on a
    card of `sms` SMs and `smem_limit` bytes of shared memory a block:
    the inverse one wherever it fits a block (its first pass then reads
    shared memory, not a strided loop over device memory); the forward
    one only at n <= 4,096 and where every block runs at least two items
    (a block's first item has nothing to overlap its copy with, and at
    n = 16,384 a staged row of 128 KB would leave one block a SM); None
    where even the working polynomial does not fit a block."""
    blocks = WIDE_BLOCKS_PER_SM * sms
    depth = 1 if not fwd or (n <= 4096 and items >= 2 * blocks) else 0
    while depth >= 0 and wide_smem(n, depth) > smem_limit:
        depth -= 1
    return depth if depth >= 0 else None


def plan(rows: int, K: int, n: int, sms: int, smem_limit: int,
         fwd: bool = True) -> Optional[Plan]:
    """The launch of one direction for `rows` x K items of degree n on a
    card of `sms` SMs and `smem_limit` bytes of shared memory a block;
    None when there is nothing to launch.  Fewer items than SMs at n >=
    CLUSTER_MIN_N, or a polynomial whose wide form does not fit a block,
    split each item over a cluster of CLUSTER blocks; everything else
    runs the wide form, one block per item below a wave."""
    items = rows * K
    if items == 0:
        return None
    depth = wide_depth(n, fwd, items, sms, smem_limit)
    if depth is not None and (n < CLUSTER_MIN_N or items >= sms):
        return Plan(0, depth)
    return Plan(CLUSTER, 0)


def plan_boundaries(K: int, n: int, sms: int, smem_limit: int) -> list:
    """Row counts on each side of every change of the forward or inverse
    `plan` at (K, n) on such a card, and of the wide form's first full
    wave of blocks (from the next row on, a block runs more than one
    item)."""
    wave = WIDE_BLOCKS_PER_SM * sms // K
    out = [wave, wave + 1]
    for fwd in (True, False):
        last = plan(1, K, n, sms, smem_limit, fwd)
        for rows in range(2, 2 * wave + 2):
            cur = plan(rows, K, n, sms, smem_limit, fwd)
            if cur != last:
                out += [rows - 1, rows]
            last = cur
    return sorted(set(out))


@functools.lru_cache(maxsize=None)
def card_shape(index: int) -> tuple:
    """(SMs, opt-in shared memory a block in bytes) of CUDA card `index`,
    read once per card."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def ntt_br(x: torch.Tensor, ring: R.Ring, *, fwd: bool = True
           ) -> torch.Tensor:
    """Forward (natural -> bit-reversed, with the psi pre-twist) or
    inverse (bit-reversed -> natural, with the psi^-1 n^-1 post-twist)
    negacyclic NTT over [..., K, n]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    t_in = _build.stamp()
    _check_poly(x, ring)
    if not x.is_cuda:
        return ntt_br_plain(x, ring, fwd=fwd)
    K, n = ring.num_towers, ring.n
    rows = math.prod(x.shape[:-2])
    src = x.reshape(rows, K, n).contiguous()
    if src.data_ptr() % 16:         # the wide form copies 16 bytes a time
        src = src.clone()
    out = torch.empty_like(src)
    if rows == 0:
        return out.reshape(x.shape)
    index = x.device.index
    launch = plan(rows, K, n, *card_shape(index), fwd=fwd)
    lib = _build.load("ntt")
    with _build.on_device(index):
        t_call = _build.stamp()
        rc = lib.hades_ntt_br(src.data_ptr(), out.data_ptr(), rows,
                              ring.shoup.data_ptr(), ring.q_arr.data_ptr(),
                              K, n, int(fwd), launch.cluster, launch.depth,
                              _build.stream_handle(x.device))
    _build.check(rc, "ntt_br")
    _build.count_launch("ntt_br_fwd" if fwd else "ntt_br_inv", t_in, t_call,
                        rows=rows, K=K, n=n, fwd=fwd,
                        form=("narrow" if launch.cluster
                              else f"wide{launch.depth}"))
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
    t_in = _build.stamp()
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
        t_call = _build.stamp()
        rc = lib.hades_negacyclic_mul(
            pa.data_ptr(), sa, pb.data_ptr(), sb, out.data_ptr(), rows,
            ring.shoup.data_ptr(), ring.q_arr.data_ptr(), K, n,
            _build.stream_handle(a.device))
    _build.check(rc, "negacyclic_mul")
    if rows:
        _build.count_launch("negacyclic_mul", t_in, t_call, rows=rows, K=K,
                            n=n)
    return out.reshape(batch + (K, n))


def negacyclic_mul_ntt(a: torch.Tensor, b_br: torch.Tensor, ring: R.Ring,
                       b_shoup: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """a ⊛ b over [..., K, n] for one polynomial b given as its forward
    transform b_br = ntt_br(b) ([K, n] or with leading dims of size 1):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    b_shoup is b_br's Shoup pairs (`R.shoup_pairs`), made here when not
    given; `KeySet.key_br` caches both once per key."""
    t_in = _build.stamp()
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
        t_call = _build.stamp()
        rc = lib.hades_negacyclic_mul_ntt(
            pa.data_ptr(), sa, key.data_ptr(), out.data_ptr(), rows,
            ring.shoup.data_ptr(), ring.q_arr.data_ptr(), K, n,
            _build.stream_handle(a.device))
    _build.check(rc, "negacyclic_mul_ntt")
    if rows:
        _build.count_launch("negacyclic_mul_ntt", t_in, t_call, rows=rows,
                            K=K, n=n)
    return out.reshape(batch + (K, n))
