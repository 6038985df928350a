"""Plan executor: fused batched filtering + encrypted order/top-k stages.

The port of `repro.db.executor` (single table).  Execution:

  1. FILTER.  Every scan leaf contributes 1 (Eq) or 2 (Range) atoms; ALL
     atoms of the predicate tree share one fused raw-eval pass
     (`fused_eval`) over base ∪ delta, in power-of-two row tiles of at
     most the lane budget.  Each atom's decode threshold (profile τ or
     ε-derived) is applied host-side.  Leaves whose column has a
     `SortedIndex` resolve by encrypted binary search instead, plus one
     search of the pending delta run's own index.
  2. COMBINE.  Leaf masks -> boolean tree, host-side numpy.
  3. ORDER / TOPK.  `encrypted_sort` / `encrypted_topk` over the matches.
  4. LIMIT + PROJECT.

Dispatch is by device.  On CUDA, a gadget-mode tile is ONE launch of
the gadget Eval kernel over the unique column stack (no per-atom copy,
no digit tensor); a paper-mode tile is one paper Eval launch per unique
column plus one on the atom bounds (`kernels.ops.dedup_tile_values`).
On CPU the same tiles run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.ckks import eps_to_tau
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db import plan as P
from repro_torch.db.index import SortedIndex
from repro_torch.db.table import Table, rows_to_mask
from repro_torch.kernels import ops as KO
from repro_torch.parallel.sharding import ShardStack


@dataclasses.dataclass
class ExecStats:
    """What the engine actually did — benchmarks and tests assert on this."""
    eval_calls: int = 0            # batched Eval passes in the filter stage
    scan_compares: int = 0         # comparisons inside fused linear scans
    index_compares: int = 0        # binary-search probe comparisons (the
    #                                base index AND any delta-run index)
    scan_leaves: int = 0
    indexed_leaves: int = 0
    order_compares: int = 0        # sort / top-k network comparisons
    delta_build_compares: int = 0  # lazy per-delta-run index builds

    @property
    def filter_compares(self) -> int:
        """Total filter-stage compare lanes (fused scans + index probes)."""
        return self.scan_compares + self.index_compares


@dataclasses.dataclass
class QueryResult:
    """One executed plan's answer: matched/ordered row ids, the filter
    mask, still-encrypted projected columns, and the engine stats."""
    row_ids: np.ndarray                      # selected (ordered) row ids
    mask: np.ndarray                         # [n_total] global filter mask
    columns: Dict[str, Ciphertext]           # projected ciphertexts
    stats: ExecStats

    def __len__(self) -> int:
        return int(self.row_ids.shape[0])


def dedup_atom_columns(table, atoms: List[P.Atom],
                       stack) -> Tuple[Ciphertext, np.ndarray]:
    """Stack each DISTINCT scan column once + the [A] per-atom gather.

    `stack(column)` is the column's scan ciphertext (`scan_column` on a
    Table, [W, K, n]; `scan_stack` on a ShardedTable, [S, W, K, n] as
    `ShardStack` slabs, stacked slab by slab); the unique axis goes
    first, or after the shard dim.  One distinct column
    is a view (no copy): the served batches over one column never
    duplicate the table."""
    order: Dict[str, int] = {}
    for a in atoms:
        order.setdefault(a.column, len(order))
    cols = [stack(c) for c in order]
    axis = 0 if cols[0].c0.dim() == 3 else 1
    if isinstance(cols[0].c0, ShardStack):        # a placed table's slabs
        uniq = Ciphertext(ShardStack.stack([c.c0 for c in cols], axis),
                          ShardStack.stack([c.c1 for c in cols], axis))
    elif len(cols) == 1:
        uniq = Ciphertext(cols[0].c0.unsqueeze(axis),
                          cols[0].c1.unsqueeze(axis))
    else:
        uniq = Ciphertext(torch.stack([c.c0 for c in cols], dim=axis),
                          torch.stack([c.c1 for c in cols], dim=axis))
    sel = np.asarray([order[a.column] for a in atoms], np.int64)
    return uniq, sel


def stack_atom_bounds(atoms: List[P.Atom]) -> Ciphertext:
    """The [A, 1] per-atom trapdoor bounds stack."""
    return Ciphertext(torch.stack([a.value.c0 for a in atoms])[:, None],
                      torch.stack([a.value.c1 for a in atoms])[:, None])


def atom_tau(ks: KeySet, atom: P.Atom) -> int:
    """The decode threshold an atom resolves to (profile τ or ε-derived)."""
    if atom.eps is None:
        return ks.params.tau
    return eps_to_tau(ks.params, atom.eps)


def fae_comparator(ks: KeySet):
    """Alg. 4 trapdoor comparator in `encrypted_sort` signature."""
    return lambda _ks, a, b: C.compare_fae(ks, a, b)


def fused_eval(ks: KeySet, table: Table, atoms: List[P.Atom], *,
               lane_budget: Optional[int] = None) -> np.ndarray:
    """RAW eval values for all atoms' fused scan: [A, N] int64
    (N = `table.scan_width`).

    Each DISTINCT column is stacked once and each atom reads its column
    by index inside the launch; rows tile into power-of-two chunks of T
    with A·T lanes within the lane budget (`kernels.ops.lane_tile`), one
    launch per tile.  Thresholds are applied later, per atom, in
    `scan_leaf_mask`, so mixed exact/ε plans share launches.
    """
    with obs.span("executor.fused_eval", atoms=len(atoms),
                  rows=table.scan_width):
        A, W = len(atoms), table.scan_width
        uniq, sel = dedup_atom_columns(table, atoms, table.scan_column)
        bounds = stack_atom_bounds(atoms)
        T = KO.lane_tile(W, A, lane_budget)
        obs.count("bytes.moved", 2 * (uniq.c0.nbytes + bounds.c0.nbytes))
        out = np.empty((A, W), dtype=np.int64)
        for lo in range(0, W, T):
            t = min(T, W - lo)
            with obs.span("executor.eval_tile", offset=lo, rows=t) as tsp:
                obs.jit_launch("executor.fused_eval", uniq.c0[:, lo:lo + t],
                               bounds.c0)
                obs.count("eval.launches")
                obs.count("eval.tiles")
                obs.count("eval.lanes", A * t)
                vals = tsp.sync(KO.dedup_tile_values(ks, uniq, sel, bounds,
                                                     lo, t))
                out[:, lo:lo + t] = vals.cpu().numpy()
        return out


def fused_compare(ks: KeySet, table: Table, atoms: List[P.Atom], *,
                  lane_budget: Optional[int] = None) -> np.ndarray:
    """Three-way outcomes (profile τ) for all atoms' fused scan: [A, N]
    int32 -1/0/+1, the view of `fused_eval`'s raw values for callers
    that want it (the executor itself consumes the raw values)."""
    v = fused_eval(ks, table, atoms, lane_budget=lane_budget)
    tau = ks.params.tau
    return np.where(np.abs(v) < tau, 0, np.sign(v)).astype(np.int32)


def _atom_mask(op: str, vals: np.ndarray, tau: int) -> np.ndarray:
    """Raw eval row -> bool mask under this atom's decode threshold."""
    if op == ">=":
        return vals > -tau
    if op == "<=":
        return vals < tau
    if op == "==":
        return np.abs(vals) < tau
    raise ValueError(f"unknown atom op {op!r}")


def scan_leaf_mask(ks: KeySet, atoms: List[P.Atom], vals: np.ndarray,
                   start: int, count: int) -> np.ndarray:
    """AND one leaf's atoms' raw eval rows into its row mask, each atom
    under its own τ (shared by executor and QueryServer)."""
    a = atoms[start]
    m = _atom_mask(a.op, vals[start], atom_tau(ks, a))
    for j in range(1, count):
        a = atoms[start + j]
        m = m & _atom_mask(a.op, vals[start + j], atom_tau(ks, a))
    return m


def combine_tree(tree: Optional[tuple], leaf_masks: List[np.ndarray],
                 n_padded: int) -> np.ndarray:
    """Fold the compiled boolean tree over per-leaf row masks."""
    if tree is None:
        return np.ones(n_padded, bool)
    kind = tree[0]
    if kind == "leaf":
        return leaf_masks[tree[1]]
    if kind == "and":
        out = np.ones(n_padded, bool)
        for t in tree[1]:
            out &= combine_tree(t, leaf_masks, n_padded)
        return out
    if kind == "or":
        out = np.zeros(n_padded, bool)
        for t in tree[1]:
            out |= combine_tree(t, leaf_masks, n_padded)
        return out
    if kind == "not":
        return ~combine_tree(tree[1], leaf_masks, n_padded)
    raise ValueError(f"bad tree node {tree!r}")


def delta_probe_index(ks: KeySet, table: Table, column: str,
                      stats) -> Optional[SortedIndex]:
    """The per-delta-run `SortedIndex` for an indexed union probe, with
    its lazy-build compares attributed to `stats` exactly once per delta
    state (shared by executor and QueryServer).  None without a delta."""
    if table.n_delta == 0:
        return None
    cached = table._delta_index_cache.get(column)
    fresh = not (cached is not None and cached[0] == table.version)
    with obs.span("delta.index_build", column=column, fresh=fresh):
        didx = table.delta_index(ks, column)
    if fresh:
        stats.delta_build_compares += didx.build_compares
        obs.count("eval.lanes", didx.build_compares)
    return didx


def _probe(ks: KeySet, idx: SortedIndex, leaf) -> np.ndarray:
    if isinstance(leaf, P.Range):
        return idx.search_range(ks, leaf.lo, leaf.hi, eps=leaf.eps)
    return idx.point_lookup(ks, leaf.value, eps=leaf.eps)


def index_leaf_mask(ks: KeySet, table: Table, idx: SortedIndex,
                    leaf, stats: ExecStats) -> np.ndarray:
    """Resolve one indexed leaf over base ∪ delta as a
    [table.scan_width] slot mask: ~2·log2(n_base) probe compares in the
    base index, plus at most 2·ceil(log2 |delta|) in the pending delta
    run's own index.  Base row ids are base slot ids; delta-local hits
    shift past the base block."""
    before = idx.search_compares
    slots = [np.asarray(_probe(ks, idx, leaf), np.int64)]
    stats.index_compares += idx.search_compares - before
    didx = delta_probe_index(ks, table, leaf.column, stats)
    if didx is not None:
        before = didx.search_compares
        slots.append(table.n_padded
                     + np.asarray(_probe(ks, didx, leaf), np.int64))
        stats.index_compares += didx.search_compares - before
    return rows_to_mask(np.concatenate(slots), table.scan_width)


def filter_masks(ks: KeySet, table: Table, plan: P.CompiledPlan, *,
                 indexes: Optional[Dict[str, SortedIndex]] = None,
                 lane_budget: Optional[int] = None,
                 stats: Optional[ExecStats] = None) -> List[np.ndarray]:
    """Per-leaf row masks over the scan slots: indexed leaves via binary
    search, the rest via one fused scan."""
    stats = stats if stats is not None else ExecStats()
    indexes = indexes or {}
    W = table.scan_width
    leaf_masks: List[Optional[np.ndarray]] = [None] * plan.num_leaves
    scan_atoms: List[P.Atom] = []
    scan_slices: List[Tuple[int, int, int]] = []   # (leaf, start, count)
    for i, leaf in enumerate(plan.leaves):
        idx = indexes.get(leaf.column)
        if idx is not None:
            leaf_masks[i] = index_leaf_mask(ks, table, idx, leaf, stats)
            stats.indexed_leaves += 1
        else:
            atoms = plan.scan_atoms(i)
            scan_slices.append((i, len(scan_atoms), len(atoms)))
            scan_atoms.extend(atoms)
            stats.scan_leaves += 1
    if scan_atoms:
        vals = fused_eval(ks, table, scan_atoms, lane_budget=lane_budget)
        stats.eval_calls += 1
        stats.scan_compares += len(scan_atoms) * W
        for leaf_i, start, count in scan_slices:
            leaf_masks[leaf_i] = scan_leaf_mask(ks, scan_atoms, vals,
                                                start, count)
    return leaf_masks  # type: ignore[return-value]


def order_rows(ks: KeySet, table: Table, query: P.Query,
               row_ids: np.ndarray, stats: ExecStats) -> np.ndarray:
    """Apply TopK / OrderBy / Limit to the filtered row ids."""
    n_sel = int(row_ids.shape[0])
    if query.top_k is not None and n_sel:
        k = min(query.top_k.k, n_sel)
        with obs.span("executor.order", kind="topk", rows=n_sel, k=k):
            sub = table.gather(query.top_k.column, row_ids)
            _, sel = C.encrypted_topk(ks, sub, k, fae_comparator(ks))
        row_ids = row_ids[sel.cpu().numpy()]
        stats.order_compares += _topk_compares(n_sel, k)
        obs.count("eval.lanes", _topk_compares(n_sel, k))
    elif query.order_by is not None and n_sel:
        with obs.span("executor.order", kind="sort", rows=n_sel):
            sub = table.gather(query.order_by.column, row_ids)
            _, perm = C.encrypted_sort(ks, sub, fae_comparator(ks))
        row_ids = row_ids[perm.cpu().numpy()]
        if query.order_by.descending:
            row_ids = row_ids[::-1]
        stats.order_compares += _sort_compares(n_sel)
        obs.count("eval.lanes", _sort_compares(n_sel))
    limit = query.limit_count
    if limit is not None:
        row_ids = row_ids[:limit]
    return row_ids


def _sort_compares(n: int) -> int:
    return C.bitonic_compare_count(n)


def _topk_compares(n: int, k: int) -> int:
    n_pad = C.next_pow2(n)
    kp = C.next_pow2(k)
    if kp >= n_pad:
        return _sort_compares(n_pad)
    total = sum(range(1, kp.bit_length())) * (n_pad // 2)  # block sorts
    live = n_pad
    while live > kp:
        total += live // 2                                  # max-merge
        live //= 2
        total += (kp.bit_length() - 1) * (live // 2)        # re-merge
    return total


def execute(ks: KeySet, table, query, *,
            indexes: Optional[Dict[str, SortedIndex]] = None,
            lane_budget: Optional[int] = None) -> QueryResult:
    """Run a Query (or bare predicate / precompiled plan) against a table.
    `lane_budget` caps the fused scan's per-launch eval lanes (None = the
    shared `kernels.ops` policy default).  A `ShardedTable` dispatches to
    `db.shard.executor.execute_sharded` (its indexes are
    `ShardedIndex`es)."""
    # a ShardedTable argument implies its module is loaded already
    shard_mod = sys.modules.get("repro_torch.db.shard.table")
    if shard_mod is not None and isinstance(table, shard_mod.ShardedTable):
        from repro_torch.db.shard.executor import execute_sharded
        return execute_sharded(ks, table, query, indexes=indexes,
                               lane_budget=lane_budget)
    if isinstance(query, (P.Query, P.Predicate)):
        plan = P.compile_plan(query)
    elif isinstance(query, P.CompiledPlan):
        plan = query
    else:
        raise TypeError(f"cannot execute {query!r}")
    stats = ExecStats()
    with obs.span("executor.execute", leaves=plan.num_leaves):
        leaf_masks = filter_masks(ks, table, plan, indexes=indexes,
                                  lane_budget=lane_budget, stats=stats)
        slot_mask = combine_tree(plan.tree, leaf_masks, table.scan_width)
        slot_mask &= table.slot_valid      # pads AND tombstones excluded
        row_ids = table.slot_global_ids[np.nonzero(slot_mask)[0]]
        mask = rows_to_mask(row_ids, table.n_total)
        row_ids = order_rows(ks, table, plan.query, row_ids, stats)
        columns = {c: table.gather(c, row_ids) for c in plan.query.select}
    if obs.is_enabled() and table.n_rows:
        obs.observe("pad.waste", table.n_padded / table.n_rows)
        obs.absorb_exec_stats(stats)
    return QueryResult(row_ids=row_ids, mask=mask,
                       columns=columns, stats=stats)
