"""Public entry points over the kernels: the lane-budget policy, the
bit-reversed-order NTT, the kernel-backed raw Eval over arbitrary
batches in both modes, and the join's pair grid (`PairGrid`).

Dispatch is by device, with no fallback: a CUDA tensor reaches a kernel
or raises, and only a CPU tensor runs a plain version.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ring as R
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.kernels import cmp_eval as CK
from repro_torch.kernels import ntt as NK

# ---------------------------------------------------------------------------
# lane-budget policy: the one knob bounding every eval launch's working set
# ---------------------------------------------------------------------------

# Default ceiling on eval LANES per launch (one lane = one [K, n]
# polynomial compare), the reference's value.  Scan tiles
# (`db.executor.fused_eval`) resolve through this policy; join pair
# grids (`db.join.pair_eval_values`) too, with their own default.
DEFAULT_LANE_BUDGET = 1 << 17

_LANE_BUDGET_OVERRIDE: int | None = None


def set_lane_budget(budget: int | None) -> int | None:
    """Install a process-wide lane-budget override (None clears it).
    Returns the previous override so callers can restore it."""
    global _LANE_BUDGET_OVERRIDE
    prev = _LANE_BUDGET_OVERRIDE
    _LANE_BUDGET_OVERRIDE = None if budget is None else int(budget)
    return prev


def resolve_lane_budget(explicit: int | None = None, *,
                        default: int = DEFAULT_LANE_BUDGET) -> int:
    """The effective lane budget: explicit argument > `set_lane_budget`
    override > `REPRO_LANE_BUDGET` env var > `default`."""
    if explicit is not None:
        return int(explicit)
    if _LANE_BUDGET_OVERRIDE is not None:
        return _LANE_BUDGET_OVERRIDE
    env = os.environ.get("REPRO_LANE_BUDGET")
    if env:
        return int(env)
    return default


def lane_tile(n_rows: int, lanes_per_row: int,
              lane_budget: int | None = None, *,
              default: int = DEFAULT_LANE_BUDGET) -> int:
    """Rows per tile: the largest power of two T with T·lanes_per_row
    within the lane budget, clamped to [1, n_rows]."""
    b = resolve_lane_budget(lane_budget, default=default)
    t = max(1, b // max(1, lanes_per_row))
    t = 1 << (t.bit_length() - 1)
    return min(t, n_rows)


# ---------------------------------------------------------------------------
# raw Eval
# ---------------------------------------------------------------------------

def ntt(x: torch.Tensor, ring: R.Ring) -> torch.Tensor:
    """Forward negacyclic NTT, bit-reversed (br-eval) order. x: [B, K, n]."""
    return NK.ntt_br(x, ring, fwd=True)


def intt(x: torch.Tensor, ring: R.Ring) -> torch.Tensor:
    """Inverse of `ntt`: br-eval order in, natural order out."""
    return NK.ntt_br(x, ring, fwd=False)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor,
                   ring: R.Ring) -> torch.Tensor:
    """a ⊛ b mod (x^n + 1, q) over [..., K, n] (`kernels.ntt`)."""
    return NK.negacyclic_mul(a, b, ring)


def gadget_tile_values(ks: KeySet, uniq: Ciphertext, sel, bounds0, bounds1,
                       row_offset: int, rows: int) -> torch.Tensor:
    """Centered gadget eval values [A, rows] of a row tile of a unique
    column stack (see `cmp_eval.eval_coeff0_gadget` for the layout)."""
    params = ks.params
    coeff0 = CK.eval_coeff0_gadget(
        uniq.c0, uniq.c1, row_offset, rows, sel, bounds0, bounds1,
        ks.cek_rev, ks.ring.q_arr[:, 0], params.scale,
        params.profile.gadget_log_base, cek_bytes=ks.cek_rev_bytes)
    return R.crt_centered(params, coeff0)


def paper_coeff0(ks: KeySet, ct0: Ciphertext,
                 ct1: Optional[Ciphertext] = None) -> torch.Tensor:
    """Paper-mode coeff-0 residues [B, K] of ct0 - ct1 (ct1 [B, K, n] or
    [1, K, n]), or of ct0 alone when ct1 is None (column form)."""
    b0, b1 = (None, None) if ct1 is None else (ct1.c0, ct1.c1)
    return CK.eval_coeff0_paper(ct0.c0, ct0.c1, ks.cek_rev,
                                ks.ring.q_arr[:, 0], ks.params.scale,
                                b0, b1)


def dedup_tile_values(ks: KeySet, uniq: Ciphertext, sel, bounds: Ciphertext,
                      row_offset: int, rows: int) -> torch.Tensor:
    """Raw eval values [A, rows] of one row tile of a deduped column stack
    ([U, W, K, n]) against the [A, 1] atom bounds.

    Gadget mode: one Eval-kernel launch per unique column, each atom's
    column gathered by `sel` inside the kernel.  Paper mode: `eval_value`
    is linear in the ciphertext pair, so the column side is evaluated
    once per unique column of the tile (the paper kernel's column form,
    addressed by row offset, no copy) and once on the [A] bounds; each
    atom lane is then a gather by `sel` + coefficient-0 subtract —
    bit-identical values."""
    if ks.params.mode != "paper":
        return gadget_tile_values(ks, uniq, sel, bounds.c0[:, 0],
                                  bounds.c1[:, 0], row_offset, rows)
    tile = slice(row_offset, row_offset + rows)
    g_col = torch.stack([
        paper_coeff0(ks, Ciphertext(uniq.c0[u, tile], uniq.c1[u, tile]))
        for u in range(uniq.c0.shape[0])])                  # [U, rows, K]
    g_bnd = paper_coeff0(ks, Ciphertext(bounds.c0[:, 0],
                                        bounds.c1[:, 0]))     # [A, K]
    idx = torch.as_tensor(np.asarray(sel, np.int64), device=uniq.c0.device)
    diff = (g_col[idx] - g_bnd[:, None]) % ks.ring.q_arr[:, 0]
    return R.crt_centered(ks.params, diff)


def eval_values(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext) -> torch.Tensor:
    """Kernel-backed centered eval values of lane pairs (Alg. 2 lines
    2-4, no threshold).  ct0, ct1: [B, K, n] -> [B]."""
    if ks.params.mode == "paper":
        return R.crt_centered(ks.params, paper_coeff0(ks, ct0, ct1))
    B = ct0.c1.shape[0]
    uniq = Ciphertext(ct0.c0.contiguous()[None], ct0.c1.contiguous()[None])
    return gadget_tile_values(ks, uniq, np.zeros(1, np.int64),
                              ct1.c0[None], ct1.c1[None], 0, B)[0]


def compare(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext) -> torch.Tensor:
    """Kernel-backed Algorithm 2 (-1/0/+1). Batched over the leading dim."""
    v = eval_values(ks, ct0, ct1)
    return torch.where(v.abs() < ks.params.tau, 0,
                       torch.sign(v)).to(torch.int32)


def broadcast_eval_values(ks: KeySet, ct0: Ciphertext,
                          ct1: Ciphertext) -> torch.Tensor:
    """Raw eval values over two mutually broadcastable batch shapes: the
    broadcast grid is flattened into lane pairs, evaluated in one launch,
    and reshaped back."""
    batch = tuple(torch.broadcast_shapes(ct0.c0.shape[:-2],
                                         ct1.c0.shape[:-2]))
    full = batch + tuple(ct0.c0.shape[-2:])

    def flat(x):
        return x.expand(full).reshape((-1,) + full[-2:])
    v = eval_values(ks, Ciphertext(flat(ct0.c0), flat(ct0.c1)),
                    Ciphertext(flat(ct1.c0), flat(ct1.c1)))
    return v.reshape(batch)


# ---------------------------------------------------------------------------
# the join's pair grid: [t, R] tiles of left rows against every right row
# ---------------------------------------------------------------------------

class PairGrid:
    """Raw eval values eval(left[l], right[r]) for tiles of left rows
    against all R right rows, without materializing the broadcast grid.

    Gadget mode maps a tile onto the Eval kernel's scan form with the
    right side as the column and the tile's left rows as the atoms.  The
    gadget Eval is not antisymmetric (each digit's key row carries its
    own noise), so eval(l, r) is the kernel's column - bound only with
    both sides negated mod q: (-r) - (-l) = l - r residue for residue,
    the same digits.  The negated right column is made once per grid,
    each tile negates its t left rows; a tile is ONE kernel launch over
    R rows x t atoms, every 16-row block of the kernel full.

    Paper mode uses the Eval's linearity mod q (the `dedup_tile_values`
    factoring): each side is evaluated once in column form
    (`paper_coeff0`, one launch per side), and a tile is the coefficient-0
    difference of its t left values against the R right values.

    Both are bit-identical to the reference's Eval of every (l, r) pair.
    """

    def __init__(self, ks: KeySet, left: Ciphertext, right: Ciphertext):
        self.ks = ks
        self.left = left
        self.n_left = int(left.c0.shape[0])
        self.n_right = int(right.c0.shape[0])
        if ks.params.mode == "paper":
            self.f_left = paper_coeff0(ks, left)            # [L, K]
            self.f_right = paper_coeff0(ks, right)          # [R, K]
        else:
            ring = ks.ring
            self.neg_right = Ciphertext(R.neg(ring, right.c0)[None],
                                        R.neg(ring, right.c1)[None])

    def tile(self, lo: int, t: int) -> torch.Tensor:
        """Centered raw values [t, R] of left rows [lo, lo + t)."""
        ks = self.ks
        if ks.params.mode == "paper":
            diff = (self.f_left[lo:lo + t, None] - self.f_right[None]
                    ) % ks.ring.q_arr[:, 0]
            return R.crt_centered(ks.params, diff)
        ring = ks.ring
        b0 = R.neg(ring, self.left.c0[lo:lo + t])
        b1 = R.neg(ring, self.left.c1[lo:lo + t])
        return gadget_tile_values(ks, self.neg_right, np.zeros(t, np.int64),
                                  b0, b1, 0, self.n_right)


# ---------------------------------------------------------------------------
# shard-aware eval entry (repro_torch.db.shard)
# ---------------------------------------------------------------------------

def slab_scan_values(ks: KeySet, uniq: Ciphertext, sel, bounds: Ciphertext,
                     row_offset: int, rows: int) -> torch.Tensor:
    """Raw eval values [s, A, rows] of one row tile of the fused filter
    scan over a slab of shards' deduped column stacks ([s, U, W, K, n],
    all on one device) against the [A, 1] atom bounds on that device:
    `dedup_tile_values` per shard, its rows addressed by offset (gadget
    mode: one Eval launch per shard per unique column; paper mode: one
    on the bounds and one per unique column, per shard)."""
    return torch.stack([
        dedup_tile_values(ks, Ciphertext(uniq.c0[i], uniq.c1[i]), sel,
                          bounds, row_offset, rows)
        for i in range(uniq.c0.shape[0])])


def shard_eval_values(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext, *,
                      mesh=None, axis_name: str = "shard", sel,
                      rows: Optional[tuple] = None) -> torch.Tensor:
    """Raw eval values [S, A, rows] of one row tile of the fused filter
    scan over a shard-leading stack, each slab on the device that holds
    it: the port of the reference's `shard_map` scan.

    ct0 is every shard's deduped columns [S, U, W, K, n] as
    `parallel.sharding.ShardStack` slabs (one slab when unplaced; a
    whole tensor is split over `mesh` here), ct1 the [A, 1, K, n] atom
    bounds, copied once per call to each distinct device, `sel` the [A]
    per-atom gather into U, applied per slab, and `rows` = (offset,
    count) the row tile (default: every row).  Each slab evaluates with
    its device's `KeySet` replica (`KeySet.replica`) through
    `slab_scan_values` (a CUDA slab launches the kernels, a CPU slab
    runs the plain versions).  HADES Eval is row-local, so no slab reads
    another's rows.  Every slab's work is launched before any result is
    read; the values are then gathered on the home device (slab 0's)."""
    from repro_torch.parallel.sharding import ShardStack, shard_leading
    if mesh is not None and not (isinstance(ct0.c0, ShardStack)
                                 and ct0.c0.devices == tuple(mesh.devices)):
        ct0 = shard_leading(mesh, ct0, axis_name)
    c0, c1 = ShardStack.of(ct0.c0), ShardStack.of(ct0.c1)
    lo, t = rows if rows is not None else (0, int(c0.shape[2]))
    here = {}
    for dev in dict.fromkeys(c0.devices):
        here[dev] = (ks.replica(dev),
                     Ciphertext(ct1.c0.to(dev), ct1.c1.to(dev)))
    parts = []
    for x0, x1 in zip(c0.slabs, c1.slabs):
        kd, b = here[x0.device]
        parts.append(slab_scan_values(kd, Ciphertext(x0, x1), sel, b, lo, t))
    return torch.cat([p.to(c0.device) for p in parts])
