"""Sharded plan executor: shard-stacked fused filtering + merge stages.

The port of `repro.db.shard.executor`, stage for stage `db.executor`
with the shard dim threaded through:

  1. FILTER.  All scan atoms of the plan share one raw-eval pass over the
     `[S, U, W]` stacked unique columns (W = base block + delta block per
     shard), in power-of-two row tiles with S·A·T lanes within the lane
     budget, as the reference tiles them.  Each shard's part of a tile
     is `kernels.ops.dedup_tile_values` over its rows, addressed by
     offset (no tile copy): on the card one gadget-Eval launch per shard
     per unique column, or in paper mode one paper-Eval launch on the
     bounds and one per unique column, per shard.  On a placed table
     each slab's shards launch on the card that holds them (the
     reference's `shard_map` branch, `kernels.ops.shard_eval_values`).
     Thresholds apply host-side per shard per atom.
  2. COMBINE.  The boolean tree folds per shard; global row masks come
     from the id map.
  3. ORDER / TOPK.  Per-shard bitonic networks + log-depth cross-shard
     merges (`shard/merge.py`).
  4. LIMIT + PROJECT.  Global row ids slice/gather across shards.

`db.execute` dispatches here when handed a `ShardedTable`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db import executor as X
from repro_torch.db import plan as P
from repro_torch.db.shard import merge as M
from repro_torch.db.shard.table import ShardedTable
from repro_torch.kernels import ops as KO


@dataclasses.dataclass
class ShardedExecStats(X.ExecStats):
    """ExecStats + shard attribution (benchmarks assert on the split)."""
    shards: int = 0
    mesh_devices: int = 1
    per_shard_scan_compares: int = 0     # one shard's slice of the scan
    per_shard_order_compares: int = 0    # per-shard sort/top-k phases
    merge_compares: int = 0              # cross-shard merge networks only


def sharded_fused_eval(ks: KeySet, stable: ShardedTable,
                       atoms: List[P.Atom], *,
                       lane_budget: Optional[int] = None) -> np.ndarray:
    """RAW eval values for all atoms over all shards' fused scan:
    [S, A, shard_scan_width] int64 — each shard's lanes cover its base
    block AND its pending delta run (`scan_stack`).  Thresholds are NOT
    applied here (the `db.executor.fused_eval` contract).

    Each DISTINCT column's shard stack moves once and the shard row axis
    tiles into power-of-two chunks with S·A·T lanes within the lane
    budget.  A tile runs per slab on the device that holds it
    (`kernels.ops.shard_eval_values`, `sel` applied per slab against the
    bounds copied to each device): d slabs on a placed table
    (`ShardSpec.shard_map_ok`, the reference's `shard_map` branch), one
    slab on the table's device otherwise."""
    with obs.span("shard.fused_eval", shards=stable.num_shards,
                  atoms=len(atoms), rows=stable.shard_scan_width) as sp:
        S, A = stable.num_shards, len(atoms)
        W = stable.shard_scan_width
        uniq, sel = X.dedup_atom_columns(stable, atoms, stable.scan_stack)
        bounds = X.stack_atom_bounds(atoms)
        T = KO.lane_tile(W, S * A, lane_budget)
        obs.count("bytes.moved", 2 * (uniq.c0.nbytes + bounds.c0.nbytes))
        spec = stable.spec
        if spec.shard_map_ok:
            sp.set(shard_map=True)
        out = np.empty((S, A, W), dtype=np.int64)
        for lo in range(0, W, T):
            t = min(T, W - lo)
            with obs.span("shard.eval_tile", offset=lo, rows=t) as tsp:
                obs.jit_launch("shard.fused_eval", (S, uniq.c0.shape[1], t),
                               bounds.c0)
                obs.count("eval.launches")
                obs.count("eval.tiles")
                obs.count("eval.lanes", S * A * t)
                vals = KO.shard_eval_values(ks, uniq, bounds,
                                            mesh=spec.mesh,
                                            axis_name=spec.axis, sel=sel,
                                            rows=(lo, t))
                out[:, :, lo:lo + t] = tsp.sync(vals).cpu().numpy()
        return out


def shard_delta_probe_index(ks: KeySet, stable: ShardedTable, column: str,
                            s: int, stats):
    """Shard s's per-delta-run `SortedIndex` for an indexed union probe,
    with lazy-build compares attributed exactly once per delta state."""
    cached = stable._delta_index_cache.get((column, s))
    fresh = not (cached is not None and cached[0] == stable.version)
    didx = stable.delta_index(ks, column, s)
    if didx is not None and fresh:
        stats.delta_build_compares += didx.build_compares
    return didx


def sharded_index_leaf_mask(ks: KeySet, stable: ShardedTable, idx, leaf,
                            stats: ShardedExecStats) -> List[np.ndarray]:
    """One indexed leaf over base ∪ delta, per shard, as
    [shard_scan_width] union-slot masks: the `ShardedIndex` fan-out search
    answers the base blocks, and every shard with a pending delta run
    adds its own binary search, whose hits shift past the base block."""
    W = stable.shard_scan_width
    N0 = stable.n_padded_per_shard
    before = idx.search_compares
    if isinstance(leaf, P.Range):
        masks = idx.shard_masks_range(ks, leaf.lo, leaf.hi, W, eps=leaf.eps)
    else:
        masks = idx.shard_masks_eq(ks, leaf.value, W, eps=leaf.eps)
    stats.index_compares += idx.search_compares - before
    for s in range(stable.num_shards):
        didx = shard_delta_probe_index(ks, stable, leaf.column, s, stats)
        if didx is None:
            continue
        before = didx.search_compares
        if isinstance(leaf, P.Range):
            drows = didx.search_range(ks, leaf.lo, leaf.hi, eps=leaf.eps)
        else:
            drows = didx.point_lookup(ks, leaf.value, eps=leaf.eps)
        stats.index_compares += didx.search_compares - before
        masks[s][N0 + np.asarray(drows, np.int64)] = True
    return masks


def sharded_filter_masks(ks: KeySet, stable: ShardedTable,
                         plan: P.CompiledPlan, *,
                         indexes: Optional[Dict[str, object]] = None,
                         lane_budget: Optional[int] = None,
                         stats: Optional[ShardedExecStats] = None,
                         ) -> List[List[np.ndarray]]:
    """Per-leaf, per-shard union-slot masks (width `shard_scan_width`):
    indexed leaves via the fan-out search + per-delta-run probes, the rest
    via one shard-stacked fused scan covering base AND delta."""
    stats = stats if stats is not None else ShardedExecStats()
    indexes = indexes or {}
    S, W = stable.num_shards, stable.shard_scan_width
    leaf_masks: List[Optional[List[np.ndarray]]] = [None] * plan.num_leaves
    scan_atoms: List[P.Atom] = []
    scan_slices: List[Tuple[int, int, int]] = []
    for i, leaf in enumerate(plan.leaves):
        idx = indexes.get(leaf.column)
        if idx is not None:
            if not hasattr(idx, "shard_masks_range"):
                raise TypeError(
                    f"index for column {leaf.column!r} is {type(idx).__name__}"
                    " — a ShardedTable needs ShardedIndex instances "
                    "(db.ShardedIndex.build), not single-table SortedIndex")
            leaf_masks[i] = sharded_index_leaf_mask(ks, stable, idx, leaf,
                                                    stats)
            stats.indexed_leaves += 1
        else:
            atoms = plan.scan_atoms(i)
            scan_slices.append((i, len(scan_atoms), len(atoms)))
            scan_atoms.extend(atoms)
            stats.scan_leaves += 1
    if scan_atoms:
        vals = sharded_fused_eval(ks, stable, scan_atoms,
                                  lane_budget=lane_budget)
        stats.eval_calls += 1
        stats.scan_compares += len(scan_atoms) * S * W
        stats.per_shard_scan_compares += len(scan_atoms) * W
        for leaf_i, start, count in scan_slices:
            leaf_masks[leaf_i] = [
                X.scan_leaf_mask(ks, scan_atoms, vals[s], start, count)
                for s in range(S)]
    return leaf_masks  # type: ignore[return-value]


def combine_shard_masks(stable: ShardedTable, plan: P.CompiledPlan,
                        leaf_masks: List[List[np.ndarray]]) -> np.ndarray:
    """Fold the boolean tree per shard over union slots, then lift to a
    global row mask over the full id space (`n_total`); pads and
    tombstones drop out via `shard_slot_valid`."""
    W = stable.shard_scan_width
    mask = np.zeros(stable.n_total, bool)
    for s in range(stable.num_shards):
        per_leaf = [lm[s] for lm in leaf_masks]
        m = X.combine_tree(plan.tree, per_leaf, W)
        m &= stable.shard_slot_valid(s)
        gids = stable.shard_slot_gids(s)
        mask[gids[m]] = True
    return mask


# ---------------------------------------------------------------------------
# order / top-k via per-shard networks + cross-shard merges
# ---------------------------------------------------------------------------

def _shard_candidates(ks: KeySet, stable: ShardedTable, column: str,
                      row_ids: np.ndarray, *, block: int,
                      pad_value: int) -> Tuple[Ciphertext, np.ndarray, int]:
    """Matched rows grouped by owning shard, padded to `block` per shard
    and flattened for the merge networks: (ct, ids, num_blocks)."""
    s_idx = stable.shard_of(row_ids)
    num_blocks = C.next_pow2(stable.num_shards)
    per_shard = []
    for s in range(stable.num_shards):
        sel = s_idx == s
        per_shard.append((stable.gather_global(column, row_ids[sel]),
                          row_ids[sel]))
    ct, ids = M.pad_shard_blocks(ks, per_shard, block=block,
                                 pad_value=pad_value,
                                 num_blocks=num_blocks)
    return ct, ids, num_blocks


def order_rows_sharded(ks: KeySet, stable: ShardedTable, query: P.Query,
                       row_ids: np.ndarray,
                       stats: ShardedExecStats) -> np.ndarray:
    """TopK / OrderBy / Limit over globally-matched row ids, resolved per
    shard with cross-shard merge stages."""
    n_sel = int(row_ids.shape[0])
    cmp = X.fae_comparator(ks)
    if query.top_k is not None and n_sel:
        k = min(query.top_k.k, n_sel)
        kp = C.next_pow2(k)
        with obs.span("shard.order", kind="topk", rows=n_sel, k=k):
            counts = np.bincount(stable.shard_of(row_ids),
                                 minlength=stable.num_shards)
            block = max(C.next_pow2(int(counts.max())), kp)
            ct, ids, nb = _shard_candidates(
                ks, stable, query.top_k.column, row_ids, block=block,
                pad_value=-(ks.params.max_operand // 2))
            top, n_shard, n_merge = M.sharded_topk(ks, cmp, ct, ids,
                                                   num_blocks=nb, k=k)
            del ct
            if np.any(top < 0):
                # a real row tied the sentinel: re-resolve through the
                # tie-robust sort path, as encrypted_topk falls back
                sub = stable.gather_global(query.top_k.column, row_ids)
                _, sel = C._topk_via_sort(ks, sub, k, cmp, None)
                top = row_ids[sel.cpu().numpy()]
        stats.per_shard_order_compares += n_shard
        stats.merge_compares += n_merge
        stats.order_compares += n_shard + n_merge
        obs.count("eval.lanes", n_shard + n_merge)
        row_ids = np.asarray(top)
    elif query.order_by is not None and n_sel:
        with obs.span("shard.order", kind="sort", rows=n_sel):
            counts = np.bincount(stable.shard_of(row_ids),
                                 minlength=stable.num_shards)
            block = C.next_pow2(int(counts.max()))
            ct, ids, nb = _shard_candidates(
                ks, stable, query.order_by.column, row_ids, block=block,
                pad_value=ks.params.max_operand // 2)
            ordered, n_shard, n_merge = M.sharded_sort(ks, cmp, ct, ids,
                                                       num_blocks=nb)
            del ct
        stats.per_shard_order_compares += n_shard
        stats.merge_compares += n_merge
        stats.order_compares += n_shard + n_merge
        obs.count("eval.lanes", n_shard + n_merge)
        row_ids = ordered[::-1] if query.order_by.descending else ordered
    limit = query.limit_count
    if limit is not None:
        row_ids = row_ids[:limit]
    return row_ids


def execute_sharded(ks: KeySet, stable: ShardedTable, query, *,
                    indexes: Optional[Dict[str, object]] = None,
                    lane_budget: Optional[int] = None) -> X.QueryResult:
    """Run a Query (or bare predicate / precompiled plan) against a
    ShardedTable; the result contract of `db.execute`."""
    if isinstance(query, (P.Query, P.Predicate)):
        plan = P.compile_plan(query)
    elif isinstance(query, P.CompiledPlan):
        plan = query
    else:
        raise TypeError(f"cannot execute {query!r}")
    stats = ShardedExecStats(shards=stable.num_shards,
                             mesh_devices=stable.spec.mesh_devices)
    with obs.span("shard.execute", shards=stable.num_shards,
                  leaves=plan.num_leaves):
        leaf_masks = sharded_filter_masks(ks, stable, plan, indexes=indexes,
                                          lane_budget=lane_budget,
                                          stats=stats)
        mask = combine_shard_masks(stable, plan, leaf_masks)
        row_ids = np.nonzero(mask)[0]
        row_ids = order_rows_sharded(ks, stable, plan.query, row_ids, stats)
        columns = {c: stable.gather_global(c, row_ids)
                   for c in plan.query.select}
    if obs.is_enabled() and stable.n_rows:
        obs.observe("pad.waste",
                    stable.num_shards * stable.n_padded_per_shard
                    / stable.n_rows)
        obs.absorb_exec_stats(stats)
    return X.QueryResult(row_ids=row_ids, mask=mask, columns=columns,
                         stats=stats)
