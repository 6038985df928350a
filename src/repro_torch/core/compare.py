"""Algorithms 2 & 4: HADES ciphertext comparison + database operations.

    ctΔ      = ct0 - ct1                      (component-wise, mod q)
    ct_eval  = ctΔ,0 * scale + ctΔ,1 ⊛ cek    (paper mode)
             = ctΔ,0 * scale + GadgetKeyMul(ctΔ,1)   (gadget mode)
    value    = CRT-centered coefficient 0 of ct_eval
    Alg. 2   -> -1 / 0 / +1   with |value| < τ  =>  0
    Alg. 4   -> strict bool (m_a > m_b); equality obfuscated by FAE noise

Batch dims broadcast as in `repro.core.compare`.  `eval_value` on CUDA
tensors runs the Eval kernel (`kernels/ops.broadcast_eval_values`), so
range queries, index probes and every sort/top-k compare-exchange stage
go through it; CPU tensors take the plain reference path below.

The sort networks pad a non-power-of-two column with encrypted sentinel
rows.  `pad_rows(value, count)` supplies them; by default they are fresh
encryptions under a generator seeded with `_PAD_KEY_SEED`, and a test
can pass the reference's own pad rows instead.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ckks as _CK
from repro_torch.core import encrypt as _E
from repro_torch.core import gadget
from repro_torch.core import ring as R
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet

# Seed of the public-key randomness for server-side sentinel padding
# rows (they carry no secret: their value is the public ±max_operand/2).
_PAD_KEY_SEED = 0x4ADE5

PadRows = Callable[[int, int], Ciphertext]


# ---------------------------------------------------------------------------
# the Eval primitive
# ---------------------------------------------------------------------------

def ct_sub(rng: R.Ring, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    return Ciphertext(R.sub(rng, a.c0, b.c0), R.sub(rng, a.c1, b.c1))


def eval_value(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext) -> torch.Tensor:
    """Centered integer eval value ≈ scale*Δ_enc*(m0-m1) + noise.  [...]."""
    if ct0.c1.is_cuda or ct1.c1.is_cuda:
        from repro_torch.kernels import ops as KO
        return KO.broadcast_eval_values(ks, ct0, ct1)
    params, rng = ks.params, ks.ring
    d = ct_sub(rng, ct0, ct1)                                  # Alg.2 line 2
    scaled = R.scalar_mul(rng, d.c0, params.scale)             # line 3a
    if params.mode == "paper":
        keyed = R.negacyclic_mul(rng, d.c1, ks.cek)            # line 3b
    else:
        keyed = gadget.gadget_keymul(ks, d.c1)
    ct_eval = R.add(rng, scaled, keyed)
    return R.crt_centered(params, ct_eval[..., :, 0])          # line 4


def resolve_tau(ks: KeySet, eps: Optional[float]) -> int:
    """The decode threshold an ε-tolerance request resolves to (None
    keeps the profile's native τ; ε below the noise floor clamps up)."""
    if eps is None:
        return ks.params.tau
    return _CK.eps_to_tau(ks.params, eps)


def three_way(ks: KeySet, v: torch.Tensor, *,
              eps: Optional[float] = None) -> torch.Tensor:
    """Alg. 2 line 5: eval value -> -1/0/+1 (τ-thresholded; `eps` widens
    the equality band to |m0-m1| <= ε in plaintext units)."""
    tau = resolve_tau(ks, eps)
    return torch.where(v.abs() < tau, 0, torch.sign(v)).to(torch.int32)


def compare(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext, *,
            eps: Optional[float] = None) -> torch.Tensor:
    """Algorithm 2: three-way comparison -1/0/+1."""
    return three_way(ks, eval_value(ks, ct0, ct1), eps=eps)


def compare_fae(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext) -> torch.Tensor:
    """Algorithm 4: strict bool m_a > m_b (no equality outcome)."""
    return eval_value(ks, ct0, ct1) > 0


# ---------------------------------------------------------------------------
# database operations
# ---------------------------------------------------------------------------

def _gather_ct(ct: Ciphertext, idx) -> Ciphertext:
    idx = torch.as_tensor(idx, device=ct.c0.device)
    return Ciphertext(ct.c0[idx], ct.c1[idx])


def range_query(ks: KeySet, column: Ciphertext, ct_lo: Ciphertext,
                ct_hi: Ciphertext, *,
                eps: Optional[float] = None) -> torch.Tensor:
    """Mask of rows with lo <= m <= hi, both bounds in ONE batched eval:
    the bounds stack into a [2, 1] batch against the column's [N] rows."""
    bounds = Ciphertext(torch.stack([ct_lo.c0, ct_hi.c0])[:, None],
                        torch.stack([ct_lo.c1, ct_hi.c1])[:, None])
    cmp = three_way(ks, eval_value(ks, column, bounds), eps=eps)  # [2, N]
    return (cmp[0] >= 0) & (cmp[1] <= 0)


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1) (n >= 0): the one padding
    geometry for table ingest and the sort/top-k sentinel padding."""
    n = int(n)
    if n < 0:
        raise ValueError(f"row count must be >= 0, got {n}")
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _bitonic_pairs(n: int):
    """Yield (lo, hi, asc) numpy index arrays per stage of a bitonic
    sorting network over n = 2^k."""
    k = n.bit_length() - 1
    for phase in range(1, k + 1):
        for sub in range(phase - 1, -1, -1):
            i = np.arange(n)
            partner = i ^ (1 << sub)
            first = i < partner
            up = ((i >> phase) & 1) == 0        # ascending iff bit phase is 0
            yield i[first], partner[first], up[first]


def bitonic_compare_count(n: int) -> int:
    """Compare-exchanges `encrypted_sort` performs for an n-row column
    (after its padding to 2^ceil(log2 n))."""
    n_pad = next_pow2(n)
    return sum(range(1, n_pad.bit_length())) * (n_pad // 2)


def default_pad_rows(ks: KeySet) -> PadRows:
    """Sentinel rows encrypted under a generator seeded `_PAD_KEY_SEED`."""
    def pad(value: int, count: int) -> Ciphertext:
        return _E.encrypt(ks, torch.full((count,), int(value),
                                         dtype=torch.int64), _PAD_KEY_SEED)
    return pad


def _pad_to_pow2(ks: KeySet, column: Ciphertext, pad_value: int,
                 pad_rows: Optional[PadRows]) -> Tuple[Ciphertext, int]:
    """Append encrypted `pad_value` sentinel rows up to the next power of
    two.  Returns (padded column, original row count)."""
    n_rows = column.c0.shape[0]
    n_pad = next_pow2(n_rows)
    if n_pad == n_rows:
        return column, n_rows
    pad = (pad_rows or default_pad_rows(ks))(pad_value, n_pad - n_rows)
    return Ciphertext(torch.cat([column.c0, pad.c0.to(column.c0.device)]),
                      torch.cat([column.c1, pad.c1.to(column.c1.device)])
                      ), n_rows


def _compare_swap(ks: KeySet, cmp: Callable, c0: torch.Tensor,
                  c1: torch.Tensor, perm: torch.Tensor, lo, hi, asc):
    """One batched compare-exchange stage over index pairs (lo[i], hi[i]),
    updating c0/c1/perm in place (callers own them).

    asc[i] True  => the smaller plaintext lands at lo[i];
    asc[i] False => the larger lands at lo[i].  ONE batched Eval per call.
    """
    dev = c0.device
    lo, hi = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    asc = torch.as_tensor(asc, device=dev)
    a = Ciphertext(c0[lo], c1[lo])
    b = Ciphertext(c0[hi], c1[hi])
    a_gt_b = cmp(ks, a, b)                                  # [pairs] bool
    swap = torch.where(asc, a_gt_b, ~a_gt_b)
    sw = swap[:, None, None]
    c0[lo] = torch.where(sw, b.c0, a.c0)
    c1[lo] = torch.where(sw, b.c1, a.c1)
    c0[hi] = torch.where(sw, a.c0, b.c0)
    c1[hi] = torch.where(sw, a.c1, b.c1)
    p_lo, p_hi = perm[lo], perm[hi]
    perm[lo] = torch.where(swap, p_hi, p_lo)
    perm[hi] = torch.where(swap, p_lo, p_hi)


def encrypted_sort(ks: KeySet, column: Ciphertext,
                   comparator: Callable | None = None, *,
                   pad_value: Optional[int] = None,
                   pad_rows: Optional[PadRows] = None,
                   ) -> Tuple[Ciphertext, torch.Tensor]:
    """Bitonic sort of a ciphertext column (ascending by plaintext).

    Returns (sorted ciphertexts, permutation).  Each network stage is ONE
    batched Eval over n/2 pairs.  Non-power-of-two columns are padded
    with encrypted `pad_value` sentinels (default +max_operand//2), which
    are stripped by permutation id, so real rows equal to the sentinel
    are still returned.
    """
    cmp = comparator or compare_fae
    if pad_value is None:
        pad_value = ks.params.max_operand // 2
    column, n_rows = _pad_to_pow2(ks, column, pad_value, pad_rows)
    n_padded = column.c0.shape[0]
    perm = torch.arange(n_padded, device=column.c0.device)
    c0, c1 = column.c0.clone(), column.c1.clone()
    for lo, hi, asc in _bitonic_pairs(n_padded):
        _compare_swap(ks, cmp, c0, c1, perm, lo, hi, asc)
    if n_padded == n_rows:
        return Ciphertext(c0, c1), perm
    keep = torch.nonzero(perm < n_rows).squeeze(1)
    return Ciphertext(c0[keep], c1[keep]), perm[keep]


def _block_pairs(n_blocks: int, block: int, lo, hi, asc):
    """Tile block-local pair indices across n_blocks contiguous blocks."""
    base = (np.arange(n_blocks) * block)[:, None]
    glo = (base + np.asarray(lo)[None, :]).ravel()
    ghi = (base + np.asarray(hi)[None, :]).ravel()
    return glo, ghi, np.tile(np.asarray(asc), n_blocks)


def encrypted_topk(ks: KeySet, column: Ciphertext, k: int,
                   comparator: Callable | None = None, *,
                   pad_value: Optional[int] = None,
                   pad_rows: Optional[PadRows] = None,
                   ) -> Tuple[Ciphertext, torch.Tensor]:
    """Top-k by plaintext value (descending) via a partial bitonic top-k
    network — O(n log^2 k) compares:

      1. sort each contiguous block of kp = 2^ceil(log2 k) rows descending;
      2. max-merge block pairs (position i of A against kp-1-i of B);
      3. bitonic-merge each survivor back to sorted descending, repeat.

    Sentinels default to -max_operand//2.  A real row equal to the
    sentinel can tie its way out; that case falls back to the tie-robust
    sort-based path.
    """
    cmp = comparator or compare_fae
    orig = column
    n_rows = column.c0.shape[0]
    k = min(k, n_rows)
    kp = next_pow2(k)
    if pad_value is None:
        pad_value = -(ks.params.max_operand // 2)
    column, n_rows = _pad_to_pow2(ks, column, pad_value, pad_rows)
    n_padded = column.c0.shape[0]
    if kp >= n_padded:
        return _topk_via_sort(ks, orig, k, cmp, pad_rows)

    c0, c1 = column.c0.clone(), column.c1.clone()
    perm = torch.arange(n_padded, device=c0.device)
    # phase 1: sort every kp-block descending (flipped ascending flags)
    for lo, hi, asc in _bitonic_pairs(kp):
        _compare_swap(ks, cmp, c0, c1, perm,
                      *_block_pairs(n_padded // kp, kp, lo, hi, ~asc))
    # phase 2: tournament of max-merges
    n_live = n_padded
    while n_live > kp:
        j = np.arange(n_live // kp // 2)
        i = np.arange(kp)
        lo_idx = ((2 * j * kp)[:, None] + i[None, :]).ravel()
        hi_idx = (((2 * j + 1) * kp)[:, None] + (kp - 1 - i)[None, :]).ravel()
        _compare_swap(ks, cmp, c0, c1, perm, lo_idx, hi_idx,
                      np.zeros(lo_idx.shape[0], bool))
        keep = torch.as_tensor(lo_idx, device=c0.device)
        c0, c1, perm = c0[keep], c1[keep], perm[keep]
        n_live //= 2
        # re-sort each bitonic survivor block descending: log kp stages
        stride = kp // 2
        while stride >= 1:
            within = np.arange(kp)
            p = within[(within & stride) == 0]
            _compare_swap(ks, cmp, c0, c1, perm,
                          *_block_pairs(n_live // kp, kp, p, p + stride,
                                        np.zeros(p.shape[0], bool)))
            stride //= 2
    top_idx = perm[:k]
    if bool((top_idx >= n_rows).any()):
        return _topk_via_sort(ks, orig, k, cmp, pad_rows)
    return Ciphertext(c0[:k], c1[:k]), top_idx


def _topk_via_sort(ks: KeySet, column: Ciphertext, k: int, cmp: Callable,
                   pad_rows: Optional[PadRows],
                   ) -> Tuple[Ciphertext, torch.Tensor]:
    """Tie-robust top-k: full ascending sort (id-based sentinel stripping)
    then the k largest, descending."""
    sorted_ct, perm = encrypted_sort(ks, column, cmp, pad_rows=pad_rows)
    n = column.c0.shape[0]
    sel = torch.arange(n - 1, n - 1 - k, -1, device=perm.device)
    return _gather_ct(sorted_ct, sel), perm[sel]
