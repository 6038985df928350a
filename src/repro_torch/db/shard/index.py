"""`ShardedIndex`: one HADES sorted index per shard, probed fan-out.

The port of `repro.db.shard.index`.  Build is batched across shards:
every shard's valid rows pad to one common block and ONE tiled bitonic
network sorts all shards together (each stage a single batched Eval —
`merge.shard_block_sort`), then the per-shard `SortedIndex` objects are
carved out by id-stripping.

Lookups broadcast the client's trapdoor to every shard and binary-search
ALL shards' indexes together: a probe step evaluates the `[S, B]` grid
of (shard, lane) probes in one Eval, so a range query over S shards
costs ~log2(max shard size) launches.  Per-lane decode thresholds ride
as in `SortedIndex.search`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db.executor import fae_comparator
from repro_torch.db.index import SortedIndex, _stack_cts, eps_lane_taus
from repro_torch.db.shard import merge as M
from repro_torch.db.shard.table import ShardedTable
from repro_torch.db.table import rows_to_mask


class ShardedIndex:
    """Per-shard SortedIndexes + stacked sorted rows for fan-out probes."""

    def __init__(self, column: str, shards: List[SortedIndex], *,
                 build_compares: int = 0):
        self.column = column
        self.shards = shards
        self.counts = np.asarray([ix.n_rows for ix in shards], np.int64)
        self.build_compares = build_compares
        self.search_compares = 0
        # per-lane probe totals (summed over shards) of the LAST `search`
        # call — what the batched servers bill each query from
        self.last_probe_counts = np.zeros(0, np.int64)
        n_max = int(self.counts.max())
        like = shards[0].sorted_ct.c0
        shape = (len(shards), n_max) + tuple(like.shape[1:])
        # rows past a shard's count are never probed (hi is clamped to it)
        c0 = torch.zeros(shape, dtype=like.dtype, device=like.device)
        c1 = torch.zeros_like(c0)
        for s, ix in enumerate(shards):
            c0[s, :ix.n_rows] = ix.sorted_ct.c0
            c1[s, :ix.n_rows] = ix.sorted_ct.c1
            # each shard's run becomes a view of the stack, so the
            # column's sorted rows are held once (its own copy frees
            # here unless a caller keeps it)
            ix.sorted_ct = Ciphertext(c0[s, :ix.n_rows], c1[s, :ix.n_rows])
        self._sorted = Ciphertext(c0, c1)                  # [S, Nm, K, n]

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, ks: KeySet, stable: ShardedTable,
              column: str) -> "ShardedIndex":
        """Sort every shard's column in ONE batched per-shard network."""
        S = stable.num_shards
        block = C.next_pow2(int(stable.shard_rows.max()))
        per_shard = []
        for s in range(S):
            m = int(stable.shard_rows[s])
            per_shard.append((stable.gather(column, s, np.arange(m)),
                              np.arange(m, dtype=np.int64)))
        ct, ids = M.pad_shard_blocks(ks, per_shard, block=block,
                                     pad_value=ks.params.max_operand // 2,
                                     num_blocks=S)
        del per_shard
        c0, c1, gid, compares = M.shard_block_sort(
            ks, fae_comparator(ks), ct.c0, ct.c1,
            torch.as_tensor(ids, device=ct.c0.device), block=block)
        gid = gid.cpu().numpy()
        shards = []
        for s in range(S):
            keep = np.nonzero(gid[s * block:(s + 1) * block] >= 0)[0]
            keep += s * block
            kt = torch.as_tensor(keep, device=c0.device)
            shards.append(SortedIndex(
                column, Ciphertext(c0[kt], c1[kt]), gid[keep],
                # each shard rode a block-row network (the common padded
                # block): per-shard counts sum to the batched total
                build_compares=C.bitonic_compare_count(block)))
        del ct, c0, c1
        return cls(column, shards, build_compares=compares)

    # -- fan-out search ----------------------------------------------------

    @property
    def num_shards(self) -> int:
        """Number of per-shard SortedIndexes (= the table's shard count)."""
        return len(self.shards)

    def search(self, ks: KeySet, values: Ciphertext, strict: np.ndarray,
               taus: Optional[np.ndarray] = None) -> np.ndarray:
        """Fan-out boundary search: B lanes against ALL S shards.

        values: trapdoor ciphertexts with leading batch dim B, sent once
        and broadcast to every shard.  Returns [S, B] sorted positions;
        every binary-search step is ONE batched Eval over the S·B probes.
        strict/taus semantics match `SortedIndex.search` lane for lane."""
        strict = np.asarray(strict, bool)
        B = values.c0.shape[0]
        if strict.shape != (B,):
            raise ValueError(f"strict {strict.shape} for {B} lanes")
        if taus is None:
            taus = np.full(B, ks.params.tau, dtype=np.int64)
        taus = np.asarray(taus, np.int64)
        if taus.shape != (B,):
            raise ValueError(f"taus {taus.shape} for {B} lanes")
        S = self.num_shards
        dev = self._sorted.c0.device
        lo = np.zeros((S, B), np.int64)
        hi = np.broadcast_to(self.counts[:, None], (S, B)).copy()
        s_idx = torch.arange(S, device=dev)[:, None]
        lane_probes = np.zeros(B, np.int64)
        with obs.span("shard.index.search", column=self.column,
                      shards=S, lanes=B) as sp:
            while np.any(lo < hi):
                active = lo < hi
                mid = (lo + hi) // 2
                probe = torch.as_tensor(np.where(active, mid, 0), device=dev)
                rows = Ciphertext(self._sorted.c0[s_idx, probe],
                                  self._sorted.c1[s_idx, probe])  # [S,B,...]
                obs.jit_launch("shard.index.probe", rows.c0, values.c0)
                obs.count("eval.launches")
                obs.count("eval.lanes", S * B)
                v = C.eval_value(ks, rows, values).cpu().numpy()  # [S, B]
                c = np.where(np.abs(v) < taus[None, :], 0, np.sign(v))
                lane_probes += active.sum(axis=0)
                go_left = np.where(strict[None, :], c > 0, c >= 0)
                hi = np.where(active & go_left, mid, hi)
                lo = np.where(active & ~go_left, mid + 1, lo)
            sp.set(probes=int(lane_probes.sum()))
        obs.count("index.probes", int(lane_probes.sum()))
        self.search_compares += int(lane_probes.sum())
        self.last_probe_counts = lane_probes
        return lo

    # -- leaf resolution (executor plumbing) -------------------------------

    def lane_masks(self, pos: np.ndarray, lane: int,
                   n_padded: int) -> List[np.ndarray]:
        """Boundary lane pair (2·lane, 2·lane+1) -> per-shard local row
        masks (shared by the executor and ShardedQueryServer)."""
        out = []
        for s in range(self.num_shards):
            l, r = int(pos[s, 2 * lane]), int(pos[s, 2 * lane + 1])
            out.append(rows_to_mask(self.shards[s].perm[l:r], n_padded))
        return out

    def shard_masks_range(self, ks: KeySet, ct_lo: Ciphertext,
                          ct_hi: Ciphertext, n_padded: int, *,
                          eps: Optional[float] = None) -> List[np.ndarray]:
        """lo <= value <= hi as per-shard local row masks: one 2-lane
        fan-out search (`eps` makes the bounds ε-inclusive)."""
        pos = self.search(ks, _stack_cts([ct_lo, ct_hi]),
                          np.array([False, True]), eps_lane_taus(ks, eps))
        return self.lane_masks(pos, 0, n_padded)

    def shard_masks_eq(self, ks: KeySet, ct_value: Ciphertext,
                       n_padded: int, *,
                       eps: Optional[float] = None) -> List[np.ndarray]:
        """value == v (ε-band with `eps`) as per-shard local row masks:
        one 2-lane fan-out search."""
        pos = self.search(ks, _stack_cts([ct_value, ct_value]),
                          np.array([False, True]), eps_lane_taus(ks, eps))
        return self.lane_masks(pos, 0, n_padded)

    def __repr__(self) -> str:
        return (f"ShardedIndex({self.column!r}, shards={self.num_shards}, "
                f"rows={self.counts.tolist()}, "
                f"build_compares={self.build_compares})")
