"""Public entry points over the kernels: the lane-budget policy and the
kernel-backed raw Eval over arbitrary batches.

Dispatch is by device, with no fallback: a CUDA tensor reaches a kernel
or raises, and only a CPU tensor runs a plain version.  Paper mode has
no CUDA kernel yet (the reference's `_eval_paper_kernel` is the next
slice), so paper-mode Eval on a CUDA tensor raises `NotImplementedError`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core import ring as R
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.kernels import cmp_eval as CK

# ---------------------------------------------------------------------------
# lane-budget policy: the one knob bounding every eval launch's working set
# ---------------------------------------------------------------------------

# Default ceiling on eval LANES per launch (one lane = one [K, n]
# polynomial compare), the reference's value.  Scan tiles
# (`db.executor.fused_eval`) resolve through this policy.
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

def require_paper_plain(x: torch.Tensor) -> None:
    """Paper-mode Eval runs only on the plain CPU path for now."""
    if x.is_cuda:
        raise NotImplementedError(
            "paper-mode Eval on a CUDA tensor needs the eval_coeff0_paper "
            "kernel (repro/kernels/cmp_eval.py::_eval_paper_kernel), which "
            "is not ported yet; use mode='gadget' or CPU tensors")


def gadget_tile_values(ks: KeySet, uniq: Ciphertext, sel, bounds0, bounds1,
                       row_offset: int, rows: int) -> torch.Tensor:
    """Centered gadget eval values [A, rows] of a row tile of a unique
    column stack (see `cmp_eval.eval_coeff0_gadget` for the layout)."""
    params = ks.params
    coeff0 = CK.eval_coeff0_gadget(
        uniq.c0, uniq.c1, row_offset, rows, sel, bounds0, bounds1,
        ks.cek_rev, ks.ring.q_arr[:, 0], params.scale,
        params.profile.gadget_log_base)
    return R.crt_centered(params, coeff0)


def eval_values(ks: KeySet, ct0: Ciphertext, ct1: Ciphertext) -> torch.Tensor:
    """Kernel-backed centered eval values of lane pairs (Alg. 2 lines
    2-4, no threshold).  ct0, ct1: [B, K, n] -> [B]."""
    if ks.params.mode == "paper":
        require_paper_plain(ct0.c1)
        from repro_torch.core.compare import eval_value
        return eval_value(ks, ct0, ct1)
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
