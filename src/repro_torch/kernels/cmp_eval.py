"""HADES Eval, coefficient 0: the CUDA kernels and their plain versions.

Gadget mode (`eval_coeff0_gadget`) over a row tile of a scan:

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
addressing the tile by offset into the column — no tile copy.  The
kernel runs the dot product on tensor cores in a byte-split form (see
"gadget mode on tensor cores" below): `eval_coeff0_gadget_bytes_plain`
is that arithmetic step by step in PyTorch, for the tests.  On CPU
tensors the wrapper runs `eval_coeff0_gadget_plain`, the function's
definition in PyTorch, in row chunks.  The reference kernel this
replaces is `repro/kernels/cmp_eval.py::_eval_gadget_kernel`.

Paper mode (`eval_coeff0_paper`) over lanes: the per-tower residues
[B, K] of coefficient 0 of scale · d0 + d1 ⊛ cek with d = a - b (lane
form, b possibly one polynomial for every lane) or d = a (column form:
the rows of one column, evaluated once so that the executor subtracts
the bounds' values afterwards; the Eval is linear mod q).  The key
multiply's coefficient 0 is the dot product of d1 with the reversed
paper CEK (`KeySet.cek_rev`, [K, n]), every term reduced mod q.  On CUDA
tensors it launches `csrc/cmp_eval.cu`'s paper kernel once (a cluster
of blocks per lane and tower for small lane sets, warps walking lanes
against rev(cek) in shared memory for wide ones); on CPU tensors it runs
`eval_coeff0_paper_plain`.  It replaces
`repro/kernels/cmp_eval.py::_eval_paper_kernel`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ring as R
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


# ---------------------------------------------------------------------------
# gadget mode on tensor cores: the byte-split form
# ---------------------------------------------------------------------------
#
# The key multiply's coefficient 0 is a matrix product.  Its reduction runs
# over (source tower, coefficient, digit); the kernel packs a coefficient's
# digits into bytes, 4 to a 32-bit word (WPC words per coefficient, the
# digits padded with zeros), and splits every cek_rev residue (< 2^31) into
# its 4 bytes, so that
#
#   Σ_{ks,i,j} dig_j(d_ks[i]) cek_rev[ks, j, k, i]
#       = Σ_b 2^(8b) Σ_{ks,i,j} dig_j(d_ks[i]) byte_b(cek_rev[ks, j, k, i])
#
# is a u8 x u8 product with 8 output columns (k, b), k < K <= 2, summed in
# s32 on tensor cores.  One term is below 2^16, so a run of s32 sums is
# flushed (reduced mod q_k into a wider sum) every FLUSH_WORDS words =
# 4 * FLUSH_WORDS terms, well inside the 33,025 terms after which s32 could
# overflow.  The epilogue recombines the byte columns mod q_k.

FLUSH_WORDS = 4096          # 16,384 terms per s32 run
_GROUP_WORDS = 32           # words per group: 4 mma steps of k = 32 bytes


def words_per_coeff(D: int, log_base: int) -> int:
    """Words of 4 digit bytes per coefficient: 1 when the digits are the
    residue's own bytes (log_base 8, at most 4 of them), else ceil(D / 4)
    rounded up to a power of two, at least 2 (a thread's 8 words of a
    group are then whole coefficients)."""
    if log_base == 8 and D <= 4:
        return 1
    return max(2, 1 << (-(-D // 4) - 1).bit_length())


def _fragment_words(wpc: int, device) -> torch.Tensor:
    """[4 steps, 4 tig, 2 slots]: the group word (of 32) that fragment slot
    s of mma step t holds in threadID_in_group tig.  A thread's 8 words
    are its coefficients c_j = 8 (j >> 1) + 2 tig + (j & 1), j < 8 / wpc
    (so the 4 threads of a group read 64 contiguous bytes per load), each
    in wpc words; step t takes its words 2t and 2t + 1."""
    t = torch.arange(4, device=device)[:, None, None]
    tig = torch.arange(4, device=device)[None, :, None]
    e = 2 * t + torch.arange(2, device=device)[None, None, :]
    j = e // wpc
    return (8 * (j >> 1) + 2 * tig + (j & 1)) * wpc + e % wpc


def gadget_cek_bytes(cek_rev: torch.Tensor, log_base: int) -> torch.Tensor:
    """cek_rev [K_src, D, K, n] as the tensor-core Eval's B operand.

    The columns are (k, b) = k*4 + b (8 of them; zero where k >= K), the
    rows the words (ks, i, w) of the reduction, each a uint32 holding the
    bytes b of cek_rev[ks, 4w + j, k, i] for j = 0..3 (zero for 4w + j >=
    D).  They are stored in the order the kernel's mma.m16n8k32 B fragments
    read them: [K_src, groups, step t, lane, slot] int32, lane g*4 + tig
    holding column g (PTX's groupID g and threadID_in_group tig) of group
    word `_fragment_words(wpc)[t, tig, slot]`; a group is 32 consecutive
    words."""
    if not 1 <= log_base <= 8:
        raise ValueError(f"the tensor-core Eval needs digits of at most 8 "
                         f"bits, not {log_base}")
    Ks, D, K, n = cek_rev.shape
    if K > 2:
        raise ValueError(f"the Eval takes 1 or 2 towers, not {K}")
    wpc = words_per_coeff(D, log_base)
    dev = cek_rev.device
    shifts = torch.arange(4, device=dev) * 8
    byt = (cek_rev.permute(0, 3, 1, 2)[..., None] >> shifts) & 255
    cols = torch.zeros((Ks, n, 4 * wpc, 8), dtype=torch.int64, device=dev)
    cols[:, :, :D, :4 * K] = byt.reshape(Ks, n, D, 4 * K)
    words = (cols.reshape(Ks, n * wpc, 4, 8) << shifts[:, None]).sum(2)
    frag = words.reshape(Ks, -1, 32, 8)[:, :, _fragment_words(wpc, dev)]
    frag = frag.permute(0, 1, 2, 5, 3, 4).reshape(Ks, -1, 4, 32, 2)
    return torch.where(frag >= 1 << 31, frag - (1 << 32),
                       frag).to(torch.int32).contiguous()


def _cek_byte_columns(cek_bytes: torch.Tensor, wpc: int) -> torch.Tensor:
    """`gadget_cek_bytes`'s fragment order back to [K_src, n * WPC * 4, 8]
    digit bytes: row (i, w, j) = byte b of digit 4w + j of coefficient i."""
    Ks, G = cek_bytes.shape[:2]
    frag = (cek_bytes.to(torch.int64) & 0xFFFFFFFF).reshape(
        Ks, G, 4, 8, 4, 2).permute(0, 1, 2, 4, 5, 3)   # [Ks, G, t, tig, s, g]
    words = torch.empty((Ks, G, 32, 8), dtype=torch.int64,
                        device=cek_bytes.device)
    words[:, :, _fragment_words(wpc, cek_bytes.device)] = frag
    shifts = torch.arange(4, device=words.device) * 8
    return ((words.reshape(Ks, -1, 1, 8) >> shifts[:, None]) & 255).reshape(
        Ks, -1, 8)


def eval_coeff0_gadget_bytes_plain(uniq_c0, uniq_c1, row_offset, rows, sel,
                                   bounds_c0, bounds_c1, cek_rev, qs, scale,
                                   log_base, cek_bytes=None) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in PyTorch, step by step: packed
    digit bytes of d1 against `gadget_cek_bytes` (given, or made from
    cek_rev), summed in runs of FLUSH_WORDS words that must each fit an
    s32 (raises otherwise), each run reduced mod q_k, the byte columns
    recombined, scale·d0 added.  Equals `eval_coeff0_gadget_plain`."""
    A, K, n = _check(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, cek_rev, qs)
    D = cek_rev.shape[1]
    wpc = words_per_coeff(D, log_base)
    if cek_bytes is None:
        cek_bytes = gadget_cek_bytes(cek_rev, log_base)
    dev = uniq_c1.device
    selt = torch.as_tensor(np.asarray(sel, np.int64), device=dev)
    lo, hi = row_offset, row_offset + rows
    b0, b1 = ((bounds_c0, bounds_c1) if bounds_c1.dim() == 4
              else (bounds_c0[:, None], bounds_c1[:, None]))
    d1 = (uniq_c1[selt, lo:hi] - b1) % qs[:, None]           # [A, R, K, n]
    shifts = torch.arange(D, device=dev) * log_base
    digits = torch.zeros(d1.shape + (4 * wpc,), dtype=torch.int64,
                         device=dev)
    digits[..., :D] = (d1[..., None] >> shifts) & ((1 << log_base) - 1)
    a_mat = digits.reshape(A * rows, K, -1)                # [L, Ks, n*4WPC]
    b_mat = _cek_byte_columns(cek_bytes, wpc)              # [Ks, n*4WPC, 8]
    col_q = qs[torch.arange(8, device=dev) // 4 % K]       # q of column k*4+b
    acc = torch.zeros((A * rows, 8), dtype=torch.int64, device=dev)
    run = 4 * FLUSH_WORDS
    for ks in range(K):
        for t0 in range(0, a_mat.shape[-1], run):
            part = a_mat[:, ks, t0:t0 + run] @ b_mat[ks, t0:t0 + run]
            if part.numel() and int(part.max()) >= 1 << 31:
                raise OverflowError("an s32 run of the Eval overflowed")
            acc = (acc + part % col_q) % col_q
    keyed = torch.zeros((A * rows, K), dtype=torch.int64, device=dev)
    for b in reversed(range(4)):
        keyed = (keyed * 256 + acc[:, b::4][:, :K]) % qs
    d0 = (uniq_c0[selt, lo:hi, :, 0] - b0[..., 0]) % qs        # [A, R, K]
    return ((d0 * scale) % qs + keyed.reshape(A, rows, K)) % qs


def eval_coeff0_gadget(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                       bounds_c1, cek_rev, qs, scale, log_base,
                       cek_bytes=None) -> torch.Tensor:
    """[A, rows, K] coeff-0 residues of the gadget Eval over a row tile.

    uniq_c0/uniq_c1: [U, W, K, n] unique column stack; sel: host
    sequence of A indices into U; bounds: [A, K, n] or [A, rows, K, n];
    cek_rev: [K, D, K, n]; qs: [K].  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  The kernel reads cek_rev as
    `gadget_cek_bytes`: pass `cek_bytes` (`KeySet.cek_rev_bytes`, made once
    per key set), or it is made here from cek_rev."""
    t_in = _build.stamp()
    A, K, n = _check(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, cek_rev, qs)
    if not uniq_c1.is_cuda:
        return eval_coeff0_gadget_plain(uniq_c0, uniq_c1, row_offset, rows,
                                        sel, bounds_c0, bounds_c1, cek_rev,
                                        qs, scale, log_base)
    D = cek_rev.shape[1]
    wpc = words_per_coeff(D, log_base)
    if wpc > 2:
        raise ValueError(f"the Eval kernel takes at most 8 digits per "
                         f"tower, not {D}")
    if cek_bytes is None:
        cek_bytes = gadget_cek_bytes(cek_rev, log_base)
    if cek_bytes.dtype != torch.int32 or cek_bytes.device != uniq_c1.device \
            or cek_bytes.numel() != K * n * wpc * 8:
        raise ValueError("cek_bytes is not gadget_cek_bytes(cek_rev)")
    for t in (uniq_c0, uniq_c1):
        if t.stride()[1:] != (K * n, n, 1):
            raise ValueError("each unique column must be row-major "
                             "contiguous [W, K, n]")
    dev = uniq_c1.device
    cek_bytes, qs = cek_bytes.contiguous(), qs.contiguous()
    bounds_c0, bounds_c1 = bounds_c0.contiguous(), bounds_c1.contiguous()
    if uniq_c1.data_ptr() % 16 or bounds_c1.data_ptr() % 16:
        raise ValueError("uniq_c1 and bounds_c1 must start on a 16-byte "
                         "boundary (the kernel reads them 16 bytes at a "
                         "time)")
    per_lane = bounds_c1.dim() == 4
    out = torch.empty((A, rows, K), dtype=torch.int64, device=dev)
    if A == 0 or rows == 0:
        return out
    lib = _build.load("cmp_eval")
    stream = _build.stream_handle(dev)
    sel = np.asarray(sel, np.int64)
    # the launches go to the current device: make it the operands' card
    uniq = dict.fromkeys(sel.tolist())          # unique, first-seen order
    with _build.on_device(dev.index):
        for u in uniq:
            atoms = np.nonzero(sel == u)[0]
            if len(atoms) == A:
                b0, b1, dst = bounds_c0, bounds_c1, out
            else:
                idx = torch.as_tensor(atoms, device=dev)
                b0 = bounds_c0[idx].contiguous()
                b1 = bounds_c1[idx].contiguous()
                dst = torch.empty((len(atoms), rows, K), dtype=torch.int64,
                                  device=dev)
            b_rstride = K * n if per_lane else 0
            b_astride = rows * K * n if per_lane else K * n
            c0 = uniq_c0[u, row_offset:row_offset + rows]
            c1 = uniq_c1[u, row_offset:row_offset + rows]
            t_call = _build.stamp()
            rc = lib.hades_eval_gadget(
                c0.data_ptr(), c1.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                b_astride, b_rstride, cek_bytes.data_ptr(), qs.data_ptr(),
                int(scale), dst.data_ptr(), len(atoms), rows, K, n, D,
                int(log_base), stream)
            _build.check(rc, "eval_coeff0_gadget")
            _build.count_launch("eval_coeff0_gadget", t_in, t_call,
                                lanes=len(atoms) * rows, rows=rows, K=K,
                                D=D, n=n, uniq=len(uniq))
            if dst is not out:
                out[idx] = dst
    return out


# ---------------------------------------------------------------------------
# paper mode
# ---------------------------------------------------------------------------

# the ring degrees the paper kernel is built for: every profile's n
# (core/params.py); the kernel's trip counts are compile-time constants
PAPER_N = (256, 512, 1024, 4096, 16384)


def _check_paper(a0, a1, b0, b1, cek_rev, qs):
    # written out operand by operand: the wrapper runs at every probe
    # step, and a loop over a tuple of tensors costs more than the launch
    has_b = b0 is not None
    if has_b != (b1 is not None):
        raise ValueError("pass both of b0, b1 or neither")
    i64 = torch.int64
    if (a0.dtype != i64 or a1.dtype != i64 or cek_rev.dtype != i64
            or qs.dtype != i64
            or has_b and (b0.dtype != i64 or b1.dtype != i64)):
        raise ValueError("eval_coeff0_paper takes int64 tensors")
    dev = a1.get_device()
    if (a0.get_device() != dev or cek_rev.get_device() != dev
            or qs.get_device() != dev
            or has_b and (b0.get_device() != dev or b1.get_device() != dev)):
        raise ValueError("eval_coeff0_paper operands on different devices")
    if cek_rev.dim() != 2:
        raise ValueError(f"cek_rev {tuple(cek_rev.shape)} is not [K, n]")
    K, n = cek_rev.shape
    shape = a1.shape
    if len(shape) != 3 or shape[1] != K or shape[2] != n \
            or a0.shape != shape:
        raise ValueError(f"a0/a1 {tuple(a0.shape)}/{tuple(shape)} are "
                         f"not one [B, {K}, {n}]")
    B = shape[0]
    if has_b:
        bs = b1.shape
        if (b0.shape != bs or len(bs) != 3 or bs[1] != K or bs[2] != n
                or bs[0] != B and bs[0] != 1):
            raise ValueError(f"b {tuple(bs)} is not [{B} or 1, {K}, {n}]")
    if qs.dim() != 1 or qs.shape[0] != K:
        raise ValueError(f"qs {tuple(qs.shape)} is not [{K}]")
    return B, K, n


def eval_coeff0_paper_plain(a0, a1, cek_rev, qs, scale, b0=None,
                            b1=None) -> torch.Tensor:
    """The kernel's function in PyTorch (any device; CPU in production)."""
    B, K, n = _check_paper(a0, a1, b0, b1, cek_rev, qs)
    q = qs[:, None]                                         # [K, 1]
    out = torch.empty((B, K), dtype=torch.int64, device=a1.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // (K * n))
    for r0 in range(0, B, step):
        r1 = min(B, r0 + step)
        d1, d0 = a1[r0:r1], a0[r0:r1, :, 0]
        if b1 is not None:
            sb = slice(r0, r1) if b1.shape[0] == B else slice(0, 1)
            d1 = (d1 - b1[sb]) % q
            d0 = (d0 - b0[sb, :, 0]) % qs
        keyed = ((d1 * cek_rev) % q).sum(dim=-1) % qs       # [R, K]
        out[r0:r1] = ((d0 * scale) % qs + keyed) % qs
    return out


def _rows(x: torch.Tensor, n: int):
    """x [B, K, n] as rows the kernel addresses by one batch stride (0
    when one polynomial serves every lane): a view when it already is
    one, else a contiguous copy.  Rows start on a 16-byte boundary at an
    even stride: the kernel reads them 16 bytes at a time."""
    if x.is_contiguous() and not x.data_ptr() % 16:
        return x, (0 if x.shape[0] == 1 else x.shape[1] * n)
    if x.shape[0] == 1:
        x = x[0]
        if not x.is_contiguous() or x.data_ptr() % 16:
            x = x.clone(memory_format=torch.contiguous_format)
        return x, 0
    if x.stride()[1:] != (n, 1) or x.stride(0) % 2 or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x, x.stride(0)


_paper_entry = None             # the C entry, resolved at the first launch


def _paper_launch():
    global _paper_entry
    if _paper_entry is None:
        _paper_entry = _build.load("cmp_eval").hades_eval_paper
    return _paper_entry


def paper_wide_lanes() -> int:
    """Lanes from which the paper kernel runs its wide form, below which
    its cluster-split form (csrc/cmp_eval.cu's kPaperWideLanes; builds
    the library)."""
    return _build.load("cmp_eval").hades_paper_wide_lanes()


def eval_coeff0_paper(a0, a1, cek_rev, qs, scale, b0=None,
                      b1=None) -> torch.Tensor:
    """[B, K] coeff-0 residues of the paper Eval of lanes a (minus b).

    a0/a1: [B, K, n] residues; b0/b1: [B, K, n], [1, K, n] (one
    polynomial for every lane) or None (column form); cek_rev: [K, n];
    qs: [K].  The CUDA kernel for CUDA tensors (n one of `PAPER_N`), the
    plain version for CPU tensors."""
    t_in = _build.stamp()
    B, K, n = _check_paper(a0, a1, b0, b1, cek_rev, qs)
    if not a1.is_cuda:
        return eval_coeff0_paper_plain(a0, a1, cek_rev, qs, scale, b0, b1)
    if n not in PAPER_N:
        raise ValueError(f"the paper Eval kernel is built for n in "
                         f"{PAPER_N}, not {n}")
    out = a1.new_empty((B, K))
    if B == 0:
        return out
    if not cek_rev.is_contiguous() or cek_rev.data_ptr() % 16:
        cek_rev = cek_rev.clone(memory_format=torch.contiguous_format)
    if not qs.is_contiguous():
        qs = qs.contiguous()
    (pa0, sa0), (pa1, sa1) = _rows(a0, n), _rows(a1, n)
    if b0 is None:
        p_b0 = p_b1 = None
        sb0 = sb1 = 0
    else:
        (pb0, sb0), (pb1, sb1) = _rows(b0, n), _rows(b1, n)
        p_b0, p_b1 = pb0.data_ptr(), pb1.data_ptr()
    dev = a1.get_device()
    with _build.on_device(dev):
        t_call = _build.stamp()
        rc = _paper_launch()(
            pa0.data_ptr(), sa0, pa1.data_ptr(), sa1, p_b0, sb0, p_b1, sb1,
            cek_rev.data_ptr(), qs.data_ptr(), int(scale), out.data_ptr(),
            B, K, n, _build.stream_handle(dev))
    _build.check(rc, "eval_coeff0_paper")
    _build.count_launch("eval_coeff0_paper", t_in, t_call, lanes=B, K=K,
                        n=n)
    return out


# ---------------------------------------------------------------------------
# the CEK in the reference kernels' bit-reversed eval order
# ---------------------------------------------------------------------------

def cek_to_br(ks) -> torch.Tensor:
    """Paper-mode `ks.cek` in the eval domain, bit-reversed ("br-eval")
    order, [K, n]: the operand the reference's Pallas paper kernel
    multiplies against.  No Hopper kernel reads it (both Evals read
    `KeySet.cek_rev`, in the coefficient domain); it exists for parity
    with the reference and for the tests."""
    return R.ntt(ks.ring, ks.cek).index_select(-1, ks.ring.bitrev)


def cek_gadget_to_br(ks) -> torch.Tensor:
    """The gadget CEK's eval-domain form (`ks.cek_gadget_ntt`) as [E, K,
    n], E = K · digits per tower, in bit-reversed order: the reference's
    Pallas gadget kernel operand.  No Hopper kernel reads it (they read
    `KeySet.cek_rev_bytes`, in the coefficient domain); it exists for
    parity with the reference and for the tests."""
    params = ks.params
    E = params.num_towers * params.gadget_digits_per_tower
    flat = ks.cek_gadget_ntt.reshape(E, params.num_towers, params.n)
    return flat.index_select(-1, ks.ring.bitrev)
