"""HADES sorted index: build once, answer lookups in O(log n) compares.

The port of `repro.db.index`.  The index is built server-side with
`encrypted_sort` — trapdoor (Alg. 4) comparisons only — and stores the
column's ciphertext rows in sorted order plus the permutation back to
row ids.  Lookups run encrypted binary search: each step is ONE batched
raw Eval over the B probe lanes (a range query is 2 lanes; the
multi-query server stacks 2K lanes for K clients).  On the card both
the sort's compare-exchange stages and the probe steps run the Eval
kernel.

Every lane can carry its own decode threshold (`taus`), so an ε-band Eq
and an exact Range ride the same probe launch on float (CKKS) columns.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.ckks import eps_to_tau
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db.table import Table, rows_to_mask


def _stack_cts(cts) -> Ciphertext:
    return Ciphertext(torch.stack([ct.c0 for ct in cts]),
                      torch.stack([ct.c1 for ct in cts]))


def eps_lane_taus(ks: KeySet, eps: Optional[float]) -> Optional[np.ndarray]:
    """The [lower, upper] boundary-lane decode thresholds an ε-band
    predicate resolves to (None = profile default)."""
    if eps is None:
        return None
    tau = eps_to_tau(ks.params, eps)
    return np.asarray([tau, tau], dtype=np.int64)


class SortedIndex:
    """Sorted ciphertext column + permutation, with encrypted binary search."""

    def __init__(self, column: str, sorted_ct: Ciphertext, perm: np.ndarray,
                 *, build_compares: int = 0):
        self.column = column
        self.sorted_ct = sorted_ct
        self.perm = np.asarray(perm)
        self.n_rows = int(self.perm.shape[0])
        self.build_compares = build_compares
        self.search_compares = 0               # cumulative probe count
        self.last_probe_counts = np.zeros(0, np.int64)  # per-lane, last call

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, ks: KeySet, table: Table, column: str, *,
              comparator: Optional[Callable] = None) -> "SortedIndex":
        """Sort the column's valid rows once (O(n log^2 n) trapdoor
        compares), amortized over every later lookup."""
        col = table.gather(column, np.arange(table.n_rows))
        sorted_ct, perm = C.encrypted_sort(ks, col, comparator)
        return cls(column, sorted_ct, perm.cpu().numpy(),
                   build_compares=C.bitonic_compare_count(table.n_rows))

    def sorted_run(self) -> tuple:
        """The index as an ascending (ciphertext run, row-id array) pair,
        which the sort-merge join consumes directly."""
        return self.sorted_ct, self.perm

    # -- search ------------------------------------------------------------

    def _lane_taus(self, ks: KeySet, n_lanes: int,
                   taus: Optional[np.ndarray]) -> np.ndarray:
        if taus is None:
            return np.full(n_lanes, ks.params.tau, dtype=np.int64)
        taus = np.asarray(taus, dtype=np.int64)
        if taus.shape != (n_lanes,):
            raise ValueError(f"taus {taus.shape} for {n_lanes} lanes")
        return taus

    def search(self, ks: KeySet, values: Ciphertext, strict: np.ndarray,
               taus: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched boundary search over B lanes.

        strict[i] False -> lower bound: first sorted pos with col >= v_i;
        strict[i] True  -> upper bound: first sorted pos with col >  v_i.
        taus[i] (optional) is lane i's decode threshold.  Every iteration
        is ONE batched Eval over the B probe lanes.
        """
        strict = np.asarray(strict, bool)
        B = values.c0.shape[0]
        if strict.shape != (B,):
            raise ValueError(f"strict {strict.shape} for {B} lanes")
        taus = self._lane_taus(ks, B, taus)
        lo = np.zeros(B, np.int64)
        hi = np.full(B, self.n_rows, np.int64)
        probes = np.zeros(B, np.int64)
        dev = self.sorted_ct.c0.device
        with obs.span("index.search", column=self.column, lanes=B,
                      rows=self.n_rows) as sp:
            while np.any(lo < hi):
                # one step; its wait (the stream, while tracing only) sits
                # where the untraced `.cpu()` blocks
                with obs.span("index.probe_step"):
                    active = lo < hi
                    mid = (lo + hi) // 2
                    probe = torch.as_tensor(np.where(active, mid, 0),
                                            device=dev)
                    rows = Ciphertext(self.sorted_ct.c0[probe],
                                      self.sorted_ct.c1[probe])
                    obs.jit_launch("index.probe", rows.c0, values.c0)
                    obs.count("eval.launches")
                    obs.count("eval.lanes", B)
                    v = C.eval_value(ks, rows, values)
                    with obs.span("index.probe_wait") as wsp:
                        wsp.sync(v)
                    v = v.cpu().numpy()                             # [B] raw
                    c = np.where(np.abs(v) < taus, 0, np.sign(v))  # lane τ
                    probes += active
                    go_left = np.where(strict, c > 0, c >= 0)
                    hi = np.where(active & go_left, mid, hi)
                    lo = np.where(active & ~go_left, mid + 1, lo)
            sp.set(probes=int(probes.sum()))
        obs.count("index.probes", int(probes.sum()))
        self.search_compares += int(probes.sum())
        self.last_probe_counts = probes            # per-lane attribution
        return lo

    def search_range(self, ks: KeySet, ct_lo: Ciphertext, ct_hi: Ciphertext,
                     *, eps: Optional[float] = None) -> np.ndarray:
        """Row ids with lo <= value <= hi — 2 lanes, ~2 log2 n compares."""
        bounds = _stack_cts([ct_lo, ct_hi])
        l, r = self.search(ks, bounds, np.array([False, True]),
                           eps_lane_taus(ks, eps))
        return self.perm[l:r]

    def point_lookup(self, ks: KeySet, ct_value: Ciphertext, *,
                     eps: Optional[float] = None) -> np.ndarray:
        """Row ids with value == v (duplicates included) — 2 lanes."""
        bounds = _stack_cts([ct_value, ct_value])
        l, r = self.search(ks, bounds, np.array([False, True]),
                           eps_lane_taus(ks, eps))
        return self.perm[l:r]

    def mask_range(self, ks: KeySet, ct_lo: Ciphertext, ct_hi: Ciphertext,
                   n_padded: int, *, eps: Optional[float] = None) -> np.ndarray:
        """search_range as a [n_padded] bool row mask."""
        return rows_to_mask(self.search_range(ks, ct_lo, ct_hi, eps=eps),
                            n_padded)

    def mask_eq(self, ks: KeySet, ct_value: Ciphertext, n_padded: int, *,
                eps: Optional[float] = None) -> np.ndarray:
        """point_lookup as a [n_padded] bool row mask."""
        return rows_to_mask(self.point_lookup(ks, ct_value, eps=eps),
                            n_padded)

    def __repr__(self) -> str:
        return (f"SortedIndex({self.column!r}, rows={self.n_rows}, "
                f"build_compares={self.build_compares})")
