"""Delta-run compaction: fold pending inserts into base + sorted index.

The port of `repro.db.delta`.  The write path
(`Table.insert`) accumulates new rows in a small pow2-padded delta run
that every read unions in.  `compact` retires it:

  1. INDEX MERGE — each `SortedIndex` merges its ascending base run with
     the delta run's ascending run (the per-run index the lookups were
     already probing) through `shard.merge.merge_sorted_runs`: both runs
     pad to a common block L = next_pow2(max(n_base, n_delta)) with
     ascending sentinels, and ONE merge round costs L·(1 + log2 L)
     compares, against the O(n log² n) of a rebuild.  Sentinels strip
     by id, never by value.
  2. BASE APPEND — the delta's ciphertext rows concatenate onto the base
     columns, re-padded to the next power of two with fresh encryptions
     of 0 (`table.append_rows`).  No row is re-encrypted and global row
     ids do not change.

Tombstones survive compaction: dead rows stay encrypted in place and
stay masked host-side.  A `ShardedTable` compacts per shard
(`_compact_sharded`): each shard's delta run folds onto its base block
and every `ShardedIndex` merges its per-shard (base run, delta run)
pairs through the same merge network.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db.executor import fae_comparator
from repro_torch.db.index import SortedIndex
from repro_torch.db.shard import merge as M
from repro_torch.db.table import append_rows


@dataclasses.dataclass
class CompactionStats:
    """What one compaction did: the merge stays a merge, O((n_delta +
    block)·log) compares, below `rebuild_compares` (what a from-scratch
    re-sort would have cost)."""
    n_base: int = 0                # base rows before the fold
    n_delta: int = 0               # delta rows folded in
    shards: int = 1
    merge_compares: int = 0        # merge-network compares, all indexes
    merge_rounds: int = 0          # pairwise merge invocations
    rebuild_compares: int = 0      # the avoided from-scratch sort cost
    indexes_merged: int = 0

    @property
    def merge_bound(self) -> int:
        """The headline (n_delta + block)·log cost form."""
        block = C.next_pow2(max(self.n_base, 1))
        return (C.next_pow2(max(self.n_delta, 1)) + block) * (
            1 + max(1, block.bit_length() - 1))


def merge_index_runs(ks: KeySet, base: SortedIndex, delta: SortedIndex,
                     *, id_offset: int) -> Tuple[SortedIndex, int]:
    """Merge a base index run with a delta run into one `SortedIndex`.

    `delta.perm` holds delta-LOCAL row ids; `id_offset` lifts them into
    the global id space.  Both runs pad to L = next_pow2(max(|base|,
    |delta|)) with ascending sentinels (id -1) and ride ONE
    `merge_sorted_runs` round.  Returns the merged index and its compare
    count."""
    carried = base.build_compares + delta.build_compares
    if delta.n_rows == 0:
        return base, 0
    if base.n_rows == 0:
        return SortedIndex(base.column, delta.sorted_ct,
                           delta.perm + id_offset,
                           build_compares=carried), 0
    L = C.next_pow2(max(base.n_rows, delta.n_rows))
    with obs.span("compact.merge_index", column=base.column, block=L):
        ct, ids = M.pad_shard_blocks(
            ks, [(base.sorted_ct, base.perm),
                 (delta.sorted_ct, delta.perm + id_offset)],
            block=L, pad_value=ks.params.max_operand // 2, num_blocks=2)
        gid = torch.as_tensor(ids, device=ct.c0.device)
        c0, c1, gid, compares = M.merge_sorted_runs(
            ks, fae_comparator(ks), ct.c0, ct.c1, gid, run=L)
        gid = gid.cpu().numpy()
        keep = np.nonzero(gid >= 0)[0]
        kt = torch.as_tensor(keep, device=c0.device)
        sorted_ct = Ciphertext(c0[kt], c1[kt])
        del ct, c0, c1
    merged = SortedIndex(base.column, sorted_ct, gid[keep],
                         build_compares=carried)
    merged.search_compares = base.search_compares + delta.search_compares
    return merged, compares


def compact(ks: KeySet, table, indexes: Optional[Dict] = None,
            ) -> CompactionStats:
    """Fold the pending delta run(s) of `table` into its base and merge
    them into every index in `indexes` (updated IN PLACE with the merged
    `SortedIndex` / `ShardedIndex` objects).  Accepts a `Table` or a
    `ShardedTable`; a no-op (zero stats) when nothing is pending."""
    shard_mod = sys.modules.get("repro_torch.db.shard.table")
    if shard_mod is not None and isinstance(table, shard_mod.ShardedTable):
        with obs.span("compact", shards=table.num_shards,
                      n_delta=table.n_delta):
            stats = _compact_sharded(ks, table, indexes)
        obs.absorb_compaction_stats(stats)
        return stats
    indexes = indexes if indexes is not None else {}
    stats = CompactionStats(n_base=table.n_rows, n_delta=table.n_delta)
    if not table.has_delta:
        return stats
    with obs.span("compact", n_base=table.n_rows, n_delta=table.n_delta):
        n_new = table.n_rows + table.n_delta
        for col in list(indexes):
            didx = table.delta_index(ks, col)
            merged, compares = merge_index_runs(ks, indexes[col], didx,
                                                id_offset=table.n_rows)
            indexes[col] = merged
            stats.merge_compares += compares
            stats.merge_rounds += 1
            stats.indexes_merged += 1
            stats.rebuild_compares += C.bitonic_compare_count(n_new)
        folded = append_rows(ks, table, table.delta, table.zero_pad_rows)
        table.columns = folded.columns
        table.n_rows = folded.n_rows
        table.delta = None
        table._invalidate()
    obs.absorb_compaction_stats(stats)
    return stats


def _compact_sharded(ks: KeySet, stable, indexes: Optional[Dict],
                     ) -> CompactionStats:
    """Per-shard compaction of a `ShardedTable`.

    Every shard folds its own delta run into its base block; if any
    shard's base + delta overflows the common block, ALL shards re-pad
    to the next power of two with fresh encryptions of 0 (no row is
    re-encrypted).  Each `ShardedIndex` merges its per-shard (base run,
    delta run) pairs through the merge network and is rebuilt as an
    object from the merged per-shard `SortedIndex`es; no sort is redone."""
    indexes = indexes if indexes is not None else {}
    stats = CompactionStats(n_base=stable.n_rows, n_delta=stable.n_delta,
                            shards=stable.num_shards)
    if not stable.has_delta:
        return stats
    for col in list(indexes):
        # the old index frees as the merged one replaces it, before the
        # next column's merge and before the fold grows the stacks
        indexes[col] = _merge_sharded_index(ks, stable, indexes[col], stats)
        stats.indexes_merged += 1
    stable._fold_deltas(ks)
    return stats


def _merge_sharded_index(ks: KeySet, stable, idx, stats: CompactionStats):
    """`idx` with each shard's delta run merged into its base run (the
    merge network, one round a shard with pending rows), as a new
    `ShardedIndex`; `stats` counts the merges."""
    from repro_torch.db.shard.index import ShardedIndex
    merged_shards = []
    for s in range(stable.num_shards):
        didx = stable.delta_index(ks, idx.column, s)
        if didx is None:
            merged_shards.append(idx.shards[s])
            continue
        # per-shard index perms are LOCAL slot ids: delta rows land at
        # slots base_rows .. base_rows + d - 1 after the fold
        merged, compares = merge_index_runs(
            ks, idx.shards[s], didx, id_offset=int(stable.shard_rows[s]))
        merged_shards.append(merged)
        stats.merge_compares += compares
        stats.merge_rounds += 1
        n_new_s = int(stable.shard_rows[s]) + stable.delta_rows(s)
        stats.rebuild_compares += C.bitonic_compare_count(n_new_s)
    return ShardedIndex(idx.column, merged_shards,
                        build_compares=idx.build_compares)
