"""Gadget-mode HADES Eval over a row tile: the CUDA kernel and its plain
version.

`eval_coeff0_gadget` returns, for each (atom a, row r) lane of a tile,
the per-tower residues [A, rows, K] of coefficient 0 of

    scale · (col.c0 - bound.c0)  +  GadgetKeyMul(col.c1 - bound.c1)

where `col` is row `row_offset + r` of unique column `sel[a]` and
`bound` is atom a's bound (one per atom, [A, K, n], or one per lane,
[A, rows, K, n]).  The gadget key-multiply's coefficient 0 is the dot
product of the digits of d1 with the reversed gadget CEK (`cek_rev`,
see `core.keys.KeySet.cek_rev`).  CRT centering happens afterwards in
PyTorch.

On CUDA tensors the wrapper launches `csrc/cmp_eval.cu` once per unique
column of the tile (once on the served path, which scans one column),
addressing the tile by offset into the column — no tile copy.  On CPU
tensors it runs `eval_coeff0_gadget_plain`, the same arithmetic in
PyTorch, in row chunks.  The reference kernel this replaces is
`repro/kernels/cmp_eval.py::_eval_gadget_kernel`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# elements of the plain version's [A, R, K_src, D, K, n] product per chunk
_PLAIN_CHUNK_ELEMS = 1 << 25


def _check(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0, bounds_c1,
           cek_rev, qs):
    tensors = (uniq_c0, uniq_c1, bounds_c0, bounds_c1, cek_rev, qs)
    if any(t.dtype != torch.int64 for t in tensors):
        raise ValueError("eval_coeff0_gadget takes int64 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("eval_coeff0_gadget operands on different devices")
    U, W, K, n = uniq_c1.shape
    if uniq_c0.shape != uniq_c1.shape:
        raise ValueError("uniq_c0/uniq_c1 shapes differ")
    if not (0 <= row_offset and row_offset + rows <= W):
        raise ValueError(f"rows [{row_offset}, {row_offset + rows}) "
                         f"outside [0, {W})")
    A = len(sel)
    if A and not (0 <= min(sel) and max(sel) < U):
        raise ValueError(f"sel {list(sel)} outside [0, {U})")
    want = {(A, K, n), (A, rows, K, n)}
    if tuple(bounds_c1.shape) not in want or \
            bounds_c0.shape != bounds_c1.shape:
        raise ValueError(f"bounds {tuple(bounds_c1.shape)} not in {want}")
    if cek_rev.dim() != 4 or tuple(cek_rev.shape[::2]) != (K, K) \
            or cek_rev.shape[3] != n:
        raise ValueError(f"cek_rev {tuple(cek_rev.shape)} is not "
                         f"[{K}, D, {K}, {n}]")
    if tuple(qs.shape) != (K,):
        raise ValueError(f"qs {tuple(qs.shape)} is not [{K}]")
    return A, K, n


def eval_coeff0_gadget_plain(uniq_c0, uniq_c1, row_offset, rows, sel,
                             bounds_c0, bounds_c1, cek_rev, qs, scale,
                             log_base) -> torch.Tensor:
    """The kernel's function in PyTorch (any device; CPU in production)."""
    A, K, n = _check(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, cek_rev, qs)
    D = cek_rev.shape[1]
    dev = uniq_c1.device
    selt = torch.as_tensor(np.asarray(sel, np.int64), device=dev)
    q = qs[:, None]                                         # [K, 1]
    shifts = (torch.arange(D, device=dev) * log_base)[:, None]
    mask = (1 << log_base) - 1
    per_lane = bounds_c1.dim() == 4
    out = torch.empty((A, rows, K), dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, A * K * D * K * n))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        lo, hi = row_offset + r0, row_offset + r1
        b0 = bounds_c0[:, r0:r1] if per_lane else bounds_c0[:, None]
        b1 = bounds_c1[:, r0:r1] if per_lane else bounds_c1[:, None]
        d1 = (uniq_c1[selt, lo:hi] - b1) % q                # [A, R, K, n]
        dig = (d1[..., :, None, :] >> shifts) & mask        # [A, R, K, D, n]
        keyed = (dig[..., None, :] * cek_rev).sum(dim=(-4, -3, -1)) % qs
        d0 = (uniq_c0[selt, lo:hi, :, 0] - b0[..., 0]) % qs  # [A, R, K]
        out[:, r0:r1] = ((d0 * scale) % qs + keyed) % qs
    return out


def eval_coeff0_gadget(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                       bounds_c1, cek_rev, qs, scale,
                       log_base) -> torch.Tensor:
    """[A, rows, K] coeff-0 residues of the gadget Eval over a row tile.

    uniq_c0/uniq_c1: [U, W, K, n] unique column stack; sel: host
    sequence of A indices into U; bounds: [A, K, n] or [A, rows, K, n];
    cek_rev: [K, D, K, n]; qs: [K].  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    A, K, n = _check(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, cek_rev, qs)
    if not uniq_c1.is_cuda:
        return eval_coeff0_gadget_plain(uniq_c0, uniq_c1, row_offset, rows,
                                        sel, bounds_c0, bounds_c1, cek_rev,
                                        qs, scale, log_base)
    if K not in (1, 2):
        raise ValueError(f"the Eval kernel takes 1 or 2 towers, not {K}")
    for t in (uniq_c0, uniq_c1):
        if t.stride()[1:] != (K * n, n, 1):
            raise ValueError("each unique column must be row-major "
                             "contiguous [W, K, n]")
    D = cek_rev.shape[1]
    dev = uniq_c1.device
    cek_rev, qs = cek_rev.contiguous(), qs.contiguous()
    bounds_c0, bounds_c1 = bounds_c0.contiguous(), bounds_c1.contiguous()
    per_lane = bounds_c1.dim() == 4
    out = torch.empty((A, rows, K), dtype=torch.int64, device=dev)
    if A == 0 or rows == 0:
        return out
    lib = _build.load("cmp_eval")
    stream = _build.stream_handle(dev)
    sel = np.asarray(sel, np.int64)
    for u in dict.fromkeys(sel.tolist()):       # unique, first-seen order
        atoms = np.nonzero(sel == u)[0]
        if len(atoms) == A:
            b0, b1, dst = bounds_c0, bounds_c1, out
        else:
            idx = torch.as_tensor(atoms, device=dev)
            b0, b1 = bounds_c0[idx].contiguous(), bounds_c1[idx].contiguous()
            dst = torch.empty((len(atoms), rows, K), dtype=torch.int64,
                              device=dev)
        b_rstride = K * n if per_lane else 0
        b_astride = rows * K * n if per_lane else K * n
        c0 = uniq_c0[u, row_offset:row_offset + rows]
        c1 = uniq_c1[u, row_offset:row_offset + rows]
        rc = lib.hades_eval_gadget(
            c0.data_ptr(), c1.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            b_astride, b_rstride, cek_rev.data_ptr(), qs.data_ptr(),
            int(scale), dst.data_ptr(), len(atoms), rows, K, n, D,
            int(log_base), stream)
        _build.check(rc, "eval_coeff0_gadget")
        _build.count_launch("eval_coeff0_gadget")
        if dst is not out:
            out[idx] = dst
    return out
