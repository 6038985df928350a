"""Cross-shard encrypted joins: the [S_l, S_r] shard-pair grid.

The port of `repro.db.shard.join`.  Both single-table strategies lift
onto sharded layouts without new comparison machinery:

  * NESTED-LOOP.  Every (left shard, right shard) pair is a static
    [N_l, N_r] sub-grid.  Each left slab flattens to the pair matrix of
    its stacked rows against every right row and runs the single-table
    tiles (`kernels.ops.PairGrid`) where it lies: on a placed left table
    the left slabs stay on their cards and the right rows are copied to
    each card (no collective: HADES Eval is row-local); unplaced, the
    one slab is the reference's meshless `[S_l·N_l, S_r·N_r]` pair
    matrix (`db.join.grids_eval_values`).  Decode thresholds apply
    host-side; `from_table`-sharded tables carry the SAME ciphertext
    rows, so the values equal the unsharded grid's.

  * SORT-MERGE.  Each side contributes its per-shard ascending runs
    (reused from a `ShardedIndex`, or built in one batched per-shard
    network).  All S_l + S_r runs pad to one common block and merge
    through the log-depth merge network, then the shared adjacency /
    class / verify back half (`db.join.merge_runs_to_pairs`) emits pairs.

`JoinResult.pairs` is identical to the unsharded plan's for every
(S_l, S_r).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db import join as J
from repro_torch.db import plan as P
from repro_torch.db.shard import executor as SX
from repro_torch.db.shard.index import ShardedIndex
from repro_torch.db.shard.spec import ShardSpec
from repro_torch.db.shard.table import ShardedTable
from repro_torch.kernels import ops as KO


def _as_sharded(ks: KeySet, table) -> ShardedTable:
    """A join side as a ShardedTable: a plain `Table` wraps as one shard
    via `from_table`, which REUSES the ciphertext rows."""
    if isinstance(table, ShardedTable):
        return table
    return ShardedTable.from_table(ks, table,
                                   spec=ShardSpec.create(1, use_mesh=False))


def sharded_pair_eval(ks: KeySet, left: ShardedTable, right: ShardedTable,
                      lcol: str, rcol: str, *,
                      block_pairs: Optional[int] = None,
                      stats: Optional[J.JoinStats] = None) -> np.ndarray:
    """RAW eval values over the full shard-pair grid:
    [S_l, S_r, N_l, N_r] int64.  Thresholds are NOT applied here.

    Each left slab's rows, flattened where the slab lies, meet every
    right row (the [S_r·N_r] stacked right rows, copied once to each
    distinct device) in one `kernels.ops.PairGrid` with that device's
    `KeySet` replica, and `db.join.grids_eval_values` runs the grids'
    tiles side by side, one card each (no collective: HADES Eval is
    row-local).  Unplaced, the one slab is the reference's meshless
    branch: the [S_l·N_l, S_r·N_r] pair matrix of the stacked rows in
    the single-table tiles.  On a placed left table
    (`ShardSpec.shard_map_ok`) `stats` counts as the reference's
    `shard_map` branch does: one Eval call per chunk of t_r right rows
    (a power of two with S_r·N_l·t_r within `block_pairs`), and every
    pair."""
    block_pairs = J._resolve_block_pairs(block_pairs)
    lct, rct = left.columns[lcol], right.columns[rcol]
    S_l, N_l = lct.c0.shape[:2]
    S_r, N_r = rct.c0.shape[:2]
    tail = tuple(lct.c0.shape[2:])

    def rows(x):
        return x.reshape((-1,) + tail)
    right_rows = [rows(x.full(left.home)) for x in (rct.c0, rct.c1)]
    here, grids = {}, []
    for x0, x1 in zip(lct.c0.slabs, lct.c1.slabs):
        dev = x0.device
        if dev not in here:
            here[dev] = (ks.replica(dev),
                         Ciphertext(*(x.to(dev) for x in right_rows)))
        kd, r = here[dev]
        grids.append(KO.PairGrid(kd, Ciphertext(rows(x0), rows(x1)), r))
    placed = left.spec.shard_map_ok
    vals = J.grids_eval_values(grids, block_pairs=block_pairs,
                               stats=None if placed else stats)
    if placed and stats is not None:
        t_r = J._grid_tile(block_pairs, N_r, S_r * N_l)  # pow2, divides N_r
        stats.eval_calls += len(range(0, N_r, t_r))
        stats.pair_compares += S_l * S_r * N_l * N_r
    return vals.reshape(S_l, N_l, S_r, N_r).transpose(0, 2, 1, 3)


def _shard_masks(stable: ShardedTable, gmask: np.ndarray) -> List[np.ndarray]:
    """Global [n_rows] row mask -> per-shard [N_sp] padded masks (pad
    slots False), through the slot -> id map."""
    out = []
    for s in range(stable.num_shards):
        m = np.zeros(stable.n_padded_per_shard, bool)
        gids = stable.global_ids(s)
        sel = gids >= 0
        m[sel] = gmask[gids[sel]]
        out.append(m)
    return out


def pairs_from_shard_grid(vals: np.ndarray, tau: int, left: ShardedTable,
                          right: ShardedTable, left_mask: np.ndarray,
                          right_mask: np.ndarray) -> np.ndarray:
    """Raw [S_l, S_r, N_l, N_r] grid -> [P, 2] GLOBAL matched row ids in
    canonical lexicographic order."""
    lmasks = _shard_masks(left, left_mask)
    rmasks = _shard_masks(right, right_mask)
    chunks = []
    for sl in range(left.num_shards):
        for sr in range(right.num_shards):
            sub = np.abs(vals[sl, sr]) < tau
            sub &= lmasks[sl][:, None] & rmasks[sr][None, :]
            idx = np.argwhere(sub)
            if idx.size:
                idx[:, 0] = left.global_ids(sl)[idx[:, 0]]
                idx[:, 1] = right.global_ids(sr)[idx[:, 1]]
                chunks.append(idx)
    if not chunks:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.concatenate(chunks)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _side_mask_sharded(ks: KeySet, stable: ShardedTable,
                       plan: Optional[P.CompiledPlan], *,
                       indexes: Optional[Dict[str, ShardedIndex]],
                       stats: SX.ShardedExecStats) -> np.ndarray:
    """One join side -> its GLOBAL [n_rows] row mask, through the sharded
    filter / merge-order machinery (a pending delta run is refused,
    tombstoned rows drop out of the mask)."""
    if stable.has_delta:
        raise ValueError(
            f"sharded table {stable.name!r} has {stable.n_delta} "
            "uncompacted delta rows — joins address base slots; run "
            "repro_torch.db.delta.compact first")
    if plan is None:
        return stable.alive.copy()
    leaf_masks = SX.sharded_filter_masks(ks, stable, plan, indexes=indexes,
                                         stats=stats)
    mask = SX.combine_shard_masks(stable, plan, leaf_masks)
    q = plan.query
    if q.top_k is not None or q.order_by is not None or q.limit is not None:
        row_ids = SX.order_rows_sharded(ks, stable, q, np.nonzero(mask)[0],
                                        stats)
        mask = np.zeros(stable.n_rows, bool)
        mask[row_ids] = True
    return mask


def _shard_runs(ks: KeySet, stable: ShardedTable, column: str,
                index: Optional[ShardedIndex], id_base: int,
                stats: J.JoinStats) -> List[Tuple[Ciphertext, np.ndarray]]:
    """One side's per-shard ascending runs with GLOBAL combined-key ids
    (the slot -> id map of each shard-local perm, plus `id_base`).  Reuses
    the side's ShardedIndex, building one (cost attributed) when absent."""
    if index is None:
        index = ShardedIndex.build(ks, stable, column)
        stats.build_compares += index.build_compares
    runs = []
    for s, ix in enumerate(index.shards):
        ct, perm = ix.sorted_run()
        runs.append((ct, id_base + stable.global_ids(s)[perm]))
    return runs


def execute_join_sharded(ks: KeySet, left, right, join: P.Join, *,
                         strategy: str = "auto",
                         left_indexes: Optional[Dict[str, object]] = None,
                         right_indexes: Optional[Dict[str, object]] = None,
                         block_pairs: Optional[int] = None,
                         ) -> J.JoinResult:
    """Run a `Join` where either side is a `ShardedTable`: the result
    contract of `db.join.execute_join`, which dispatches here."""
    left = _as_sharded(ks, left)
    right = _as_sharded(ks, right)
    cj = P.compile_join(join)
    lcol, rcol = cj.on_columns
    left_indexes = dict(left_indexes or {})
    right_indexes = dict(right_indexes or {})
    stats = J.JoinStats(shards=(left.num_shards, right.num_shards))
    stats.left = SX.ShardedExecStats(shards=left.num_shards,
                                     mesh_devices=left.spec.mesh_devices)
    stats.right = SX.ShardedExecStats(shards=right.num_shards,
                                      mesh_devices=right.spec.mesh_devices)
    stats.strategy = J.resolve_strategy(strategy, lcol in left_indexes,
                                        rcol in right_indexes)
    lmask = _side_mask_sharded(ks, left, cj.left_plan, indexes=left_indexes,
                               stats=stats.left)
    rmask = _side_mask_sharded(ks, right, cj.right_plan,
                               indexes=right_indexes, stats=stats.right)
    tau = J.join_tau(ks, join)
    if stats.strategy == "nested":
        vals = sharded_pair_eval(ks, left, right, lcol, rcol,
                                 block_pairs=block_pairs, stats=stats)
        pairs = pairs_from_shard_grid(vals, tau, left, right, lmask, rmask)
    else:
        n_left = left.n_rows
        runs = (_shard_runs(ks, left, lcol, left_indexes.get(lcol), 0, stats)
                + _shard_runs(ks, right, rcol, right_indexes.get(rcol),
                              n_left, stats))
        pairs = J.merge_runs_to_pairs(
            ks, runs, n_left, tau, verify=J.needs_verify(ks, join),
            gather_left=lambda rows: left.gather_global(lcol, rows),
            gather_right=lambda rows: right.gather_global(rcol, rows),
            left_mask=lmask, right_mask=rmask, stats=stats)
    columns = J._project(cj, left.gather_global, right.gather_global, pairs)
    return J.JoinResult(pairs=pairs, left_mask=lmask, right_mask=rmask,
                        columns=columns, stats=stats)
