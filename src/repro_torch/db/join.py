"""Encrypted two-table joins: batched nested-loop and sort-merge.

The port of `repro.db.join`.  A `plan.Join` names a join-key column pair
plus optional per-side filter sub-plans; `execute_join` resolves the
sides through the single-table machinery (fused scans / index probes),
then matches key pairs with one of two strategies, both built from the
raw-eval + host-side-threshold design of the filter stage, so ε-band
(CKKS float) joins ride the launches the integer path uses:

  * NESTED-LOOP (`strategy="nested"`).  All N_l × N_r key comparisons
    run as tiles of T left rows against the whole right column
    (`kernels.ops.PairGrid`: on the card one Eval-kernel launch per
    tile, with no broadcast grid in memory), T the largest power of two
    with T·N_r within the pair budget.  The join's decode threshold
    (profile τ or ε-derived) applies host-side on the raw grid.

  * SORT-MERGE (`strategy="sort_merge"`).  Reuses two `SortedIndex`es
    (building them on the fly when absent, cost attributed): the two
    ascending ciphertext runs merge through the log-depth merge network
    (`shard.merge.merge_sorted_runs`, every stage one batched Eval),
    then ONE adjacency Eval over consecutive merged rows splits the run
    into equal-key classes; cross-side pairs within a class are the
    candidates.  Band (ε / CKKS) joins verify the candidates (band
    equality is not transitive): a class's candidates are all its
    (left, right) member pairs, so each class runs as one pair grid of
    its left rows against its right rows, the same values the
    reference's one batched per-pair Eval gives, without gathering two
    ciphertexts per candidate (a chained band class makes millions).

`strategy="auto"` picks sort-merge when both sides carry an index on
their join-key column, else nested-loop.  Handed a `ShardedTable` on
either side, `execute_join` dispatches to `db.shard.join`.

Output contract: `JoinResult.pairs` is the [P, 2] array of (left_row_id,
right_row_id) matches in canonical lexicographic order, independent of
strategy and placement.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db import executor as X
from repro_torch.db import plan as P
from repro_torch.db.index import SortedIndex
from repro_torch.db.table import Table, rows_to_mask
from repro_torch.kernels import ops as KO

# Upper bound on row pairs per nested-loop tile, the reference's value.
# Pair-grid entry points take `block_pairs=None` and resolve it through
# the shared lane-budget policy with THIS default, so `set_lane_budget` /
# `REPRO_LANE_BUDGET` govern join grids and fused scans with one knob.
DEFAULT_BLOCK_PAIRS = 1 << 14


def _resolve_block_pairs(block_pairs: Optional[int]) -> int:
    """The effective pair budget: explicit argument > shared lane-budget
    overrides > `DEFAULT_BLOCK_PAIRS`."""
    return KO.resolve_lane_budget(block_pairs, default=DEFAULT_BLOCK_PAIRS)


@dataclasses.dataclass
class JoinStats:
    """What the join actually did — benchmarks and tests assert on this.

    `join_compares` is the strategy's own work; `left`/`right` hold the
    per-side filter stats."""
    strategy: str = ""
    eval_calls: int = 0            # batched Eval passes (grid tiles etc.)
    pair_compares: int = 0         # nested-loop grid lanes (padded N_l·N_r)
    build_compares: int = 0        # on-the-fly sort-merge index builds
    merge_compares: int = 0        # sorted-run merge network stages
    adjacency_compares: int = 0    # equal-class detection lanes
    verify_compares: int = 0       # ε-band candidate verification lanes
    shards: Tuple[int, int] = (1, 1)
    left: X.ExecStats = dataclasses.field(default_factory=X.ExecStats)
    right: X.ExecStats = dataclasses.field(default_factory=X.ExecStats)

    @property
    def join_compares(self) -> int:
        """All compare lanes the matching phase itself spent (side
        filters and index builds excluded)."""
        return (self.pair_compares + self.merge_compares
                + self.adjacency_compares + self.verify_compares)


@dataclasses.dataclass
class JoinResult:
    """Matched row-id pairs + projected ciphertexts.

    `pairs` is [P, 2] (left_row_id, right_row_id), lexicographically
    sorted.  `columns` carries the sides' `select` projections gathered
    at the pair rows, keyed "left.<col>" / "right.<col>" (encrypted)."""
    pairs: np.ndarray
    left_mask: np.ndarray                    # [n_l] post-filter row mask
    right_mask: np.ndarray                   # [n_r] post-filter row mask
    columns: Dict[str, Ciphertext]
    stats: JoinStats

    def __len__(self) -> int:
        return int(self.pairs.shape[0])

    @property
    def left_row_ids(self) -> np.ndarray:
        """Left-side row id of each matched pair (with repetition)."""
        return self.pairs[:, 0]

    @property
    def right_row_ids(self) -> np.ndarray:
        """Right-side row id of each matched pair (with repetition)."""
        return self.pairs[:, 1]


def join_tau(ks: KeySet, join: P.Join) -> int:
    """The decode threshold the join's equality resolves to."""
    return C.resolve_tau(ks, join.eps)


def needs_verify(ks: KeySet, join: P.Join) -> bool:
    """Band equality (explicit ε, or CKKS) is not transitive, so
    sort-merge classes need a per-pair verification Eval; exact BFV
    equality is, and skips it."""
    return join.eps is not None or ks.params.profile.scheme == "ckks"


# ---------------------------------------------------------------------------
# nested-loop: tiled pair-grid Eval
# ---------------------------------------------------------------------------

def _grid_tile(block_pairs: int, n_left: int, n_right: int) -> int:
    """Left rows per tile: the largest power of two with T·N_r within the
    pair budget, clamped to [1, N_l]."""
    t = max(1, block_pairs // max(1, n_right))
    t = 1 << (t.bit_length() - 1)
    return min(t, n_left)


def pair_eval_values(ks: KeySet, left_ct: Ciphertext, right_ct: Ciphertext,
                     *, block_pairs: Optional[int] = None,
                     stats: Optional[JoinStats] = None) -> np.ndarray:
    """RAW eval values for every (left row, right row) pair: [L, R] int64.

    Left rows chunk into tiles of T left rows (a power of two with T·R
    within the pair budget), each tile ONE pass of `kernels.ops.PairGrid`
    over the [T, R] grid (`grids_eval_values` over one grid).
    Thresholds are NOT applied — callers decode with the join's own τ
    host-side."""
    return grids_eval_values([KO.PairGrid(ks, left_ct, right_ct)],
                             block_pairs=block_pairs, stats=stats)[0]


def grids_eval_values(grids: List[KO.PairGrid], *,
                      block_pairs: Optional[int] = None,
                      stats: Optional[JoinStats] = None) -> np.ndarray:
    """RAW eval values of G pair grids of one shape, [G, L, R] int64:
    each grid's left rows in tiles of T (a power of two with T·R within
    the pair budget), one `PairGrid.tile` pass each.  Tile `lo` of every
    grid is launched before any of them is read, so grids on different
    cards (a placed table's slabs, `db.shard.join`) run side by side;
    each tile is read to the host as it finishes, so a device holds at
    most one [T, R] tile per grid.  `stats` counts one Eval call per
    tile and every pair."""
    block_pairs = _resolve_block_pairs(block_pairs)
    L, R = grids[0].n_left, grids[0].n_right
    T = _grid_tile(block_pairs, L, R)
    out = np.empty((len(grids), L, R), dtype=np.int64)
    with obs.span("join.pair_grid", left=L, right=R, tile=T) as sp:
        for lo in range(0, L, T):
            t = min(T, L - lo)
            tiles = []
            for grid in grids:
                obs.jit_launch("join.pair_grid", (t, R))
                obs.count("eval.launches")
                obs.count("eval.tiles")
                obs.count("eval.lanes", t * R)
                tiles.append(grid.tile(lo, t))
            for g, v in enumerate(tiles):
                out[g, lo:lo + t] = sp.sync(v).cpu().numpy()
            if stats is not None:
                stats.eval_calls += len(grids)
    if stats is not None:
        stats.pair_compares += len(grids) * L * R
    return out


def pairs_from_grid(vals: np.ndarray, tau: int, left_mask: np.ndarray,
                    right_mask: np.ndarray) -> np.ndarray:
    """Raw pair grid -> [P, 2] matched (left, right) row ids.

    |value| < τ is the equality decode; the per-side masks gate pad rows
    (real encryptions of 0) and filtered-out rows host-side."""
    grid = np.abs(vals) < tau
    grid &= left_mask[:, None] & right_mask[None, :]
    return np.argwhere(grid)          # argwhere is already lexsorted


# ---------------------------------------------------------------------------
# sort-merge: run merge + adjacency classes (+ ε verification)
# ---------------------------------------------------------------------------

def _class_values(ks: KeySet, left: Ciphertext,
                  right: Ciphertext) -> np.ndarray:
    """Raw values [L, R] of one sort-merge class's left rows against its
    right rows, on the host: `kernels.ops.PairGrid` tiles of T left rows
    (T·R within the pair budget), each value that of the pair's own
    Eval, bit for bit.  Each row is read once a tile, where a batched
    per-pair Eval gathers two ciphertexts per pair."""
    grid = KO.PairGrid(ks, left, right)
    T = _grid_tile(_resolve_block_pairs(None), grid.n_left, grid.n_right)
    return np.concatenate([
        grid.tile(lo, min(T, grid.n_left - lo)).cpu().numpy()
        for lo in range(0, grid.n_left, T)])


def merge_runs_to_pairs(ks: KeySet, runs: List[Tuple[Ciphertext, np.ndarray]],
                        n_left: int, tau: int, *, verify: bool,
                        gather_left: Callable[[np.ndarray], Ciphertext],
                        gather_right: Callable[[np.ndarray], Ciphertext],
                        left_mask: np.ndarray, right_mask: np.ndarray,
                        stats: JoinStats) -> np.ndarray:
    """Sorted runs -> matched pairs (the shared sort-merge back half).

    `runs` are ascending (Ciphertext, id-array) runs whose ids encode the
    side: left row l is id l, right row r is id n_left + r.  The runs pad
    to one power-of-two block and merge through `merge_sorted_runs`, then
    ONE adjacency Eval splits the merged run into equal-key classes under
    τ; cross-side pairs inside a class are candidates, masks filter them,
    and `verify` re-checks each survivor: per class, one pair grid of
    its left rows against its right rows (`_class_values`).  `stats`
    and obs count the verification as the reference's one batched Eval
    over the candidates padded to a power of two."""
    from repro_torch.db.shard import merge as M
    cmp = X.fae_comparator(ks)
    block = C.next_pow2(max(int(ids.shape[0]) for _, ids in runs))
    num_blocks = C.next_pow2(len(runs))
    ct, ids = M.pad_shard_blocks(ks, runs, block=block,
                                 pad_value=ks.params.max_operand // 2,
                                 num_blocks=num_blocks)
    c0, c1 = ct.c0, ct.c1
    gid = torch.as_tensor(ids, device=c0.device)
    del ct
    if num_blocks > 1:
        c0, c1, gid, n_merge = M.merge_sorted_runs(ks, cmp, c0, c1, gid,
                                                   run=block)
        stats.merge_compares += n_merge
    gid = gid.cpu().numpy()
    keep = np.nonzero(gid >= 0)[0]            # strip sentinels BY ID
    mids = gid[keep]
    m = int(mids.shape[0])
    if m < 2:
        return np.zeros((0, 2), dtype=np.int64)
    kt = torch.as_tensor(keep, device=c0.device)
    mc0, mc1 = c0[kt], c1[kt]
    del c0, c1
    # ONE batched adjacency Eval: consecutive merged rows equal under τ?
    with obs.span("join.adjacency", lanes=m - 1) as sp:
        obs.jit_launch("join.adjacency", mc0[:-1])
        obs.count("eval.launches")
        obs.count("eval.lanes", m - 1)
        v = sp.sync(C.eval_value(ks, Ciphertext(mc0[:-1], mc1[:-1]),
                                 Ciphertext(mc0[1:], mc1[1:]))).cpu().numpy()
    del mc0, mc1
    stats.adjacency_compares += m - 1
    stats.eval_calls += 1
    eq_adj = np.abs(v) < tau
    # equal-key classes: split where adjacency breaks
    breaks = np.nonzero(~eq_adj)[0] + 1
    cand: List[np.ndarray] = []
    classes: List[Tuple[np.ndarray, np.ndarray]] = []
    for members in np.split(mids, breaks):
        l = members[members < n_left]
        r = members[members >= n_left] - n_left
        l = l[left_mask[l]]
        r = r[right_mask[r]]
        if l.size and r.size:
            li, ri = np.meshgrid(l, r, indexing="ij")
            cand.append(np.stack([li.ravel(), ri.ravel()], axis=1))
            classes.append((l, r))
    if not cand:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.concatenate(cand)
    if verify and len(pairs):
        # band equality: every candidate's Eval, class by class in the
        # candidates' order; counted as the reference's one batched Eval
        # over the candidates padded to a power of two
        n_cand = len(pairs)
        n_pad = C.next_pow2(n_cand)
        K, n = ks.params.num_towers, ks.params.n
        with obs.span("join.verify", candidates=n_cand, lanes=n_pad):
            obs.jit_launch("join.verify", (n_pad, K, n))
            obs.count("eval.launches")
            obs.count("eval.lanes", n_pad)
            vv = np.concatenate([
                _class_values(ks, gather_left(l), gather_right(r)).ravel()
                for l, r in classes])
        stats.verify_compares += n_pad
        stats.eval_calls += 1
        pairs = pairs[np.abs(vv) < tau]
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


def _side_mask(ks: KeySet, table: Table, plan: Optional[P.CompiledPlan], *,
               indexes: Optional[Dict[str, SortedIndex]],
               stats: X.ExecStats,
               leaf_masks: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """Resolve one join side to its [n_padded] row mask (filters + any
    order/top-k/limit stage, through the single-table executor helpers).

    `leaf_masks` short-circuits leaf resolution (the batched QueryServer
    passes masks whose leaves already rode its shared launches).  A side
    with a PENDING DELTA RUN is refused: the pair grids and runs address
    rows by base slot, so compact first.  Tombstoned rows drop out of the
    mask (`alive`)."""
    if table.has_delta:
        raise ValueError(
            f"table {table.name!r} has {table.n_delta} uncompacted delta "
            "rows — joins address base slots; run repro_torch.db.delta."
            "compact first")
    if plan is None:
        mask = table.valid.copy()
        mask[:table.n_rows] &= table.alive
        return mask
    if leaf_masks is None:
        leaf_masks = X.filter_masks(ks, table, plan, indexes=indexes,
                                    stats=stats)
    mask = X.combine_tree(plan.tree, leaf_masks, table.n_padded)
    mask &= table.valid
    mask[:table.n_rows] &= table.alive
    q = plan.query
    if q.top_k is not None or q.order_by is not None or q.limit is not None:
        row_ids = X.order_rows(ks, table, q, np.nonzero(mask)[0], stats)
        mask = rows_to_mask(row_ids, table.n_padded)
    return mask


def _sorted_run(ks: KeySet, table: Table, column: str,
                index: Optional[SortedIndex],
                stats: JoinStats) -> Tuple[Ciphertext, np.ndarray]:
    """The side's ascending (ciphertext run, row-id array): reused from
    its SortedIndex, or built once (cost attributed)."""
    if index is None:
        index = SortedIndex.build(ks, table, column)
        stats.build_compares += index.build_compares
    return index.sorted_run()


def resolve_strategy(strategy: str, has_left_idx: bool,
                     has_right_idx: bool) -> str:
    """"auto" -> sort-merge iff both join keys are indexed, else
    nested-loop."""
    if strategy == "auto":
        return "sort_merge" if (has_left_idx and has_right_idx) else "nested"
    if strategy in ("nested", "sort_merge"):
        return strategy
    raise ValueError(
        f"unknown join strategy {strategy!r} (auto|nested|sort_merge)")


def _project(join: P.CompiledJoin, gather_left, gather_right,
             pairs: np.ndarray) -> Dict[str, Ciphertext]:
    """Gather each side's `select` columns at the matched pair rows."""
    columns: Dict[str, Ciphertext] = {}
    for plan, gather, side, col_ids in (
            (join.left_plan, gather_left, "left", pairs[:, 0]),
            (join.right_plan, gather_right, "right", pairs[:, 1])):
        if plan is None:
            continue
        for c in plan.query.select:
            columns[f"{side}.{c}"] = gather(c, col_ids)
    return columns


def execute_join(ks: KeySet, left, right, join: P.Join, *,
                 strategy: str = "auto",
                 left_indexes: Optional[Dict[str, SortedIndex]] = None,
                 right_indexes: Optional[Dict[str, SortedIndex]] = None,
                 block_pairs: Optional[int] = None) -> JoinResult:
    """Run a `Join` between two encrypted tables.

    Accepts `Table`s or `ShardedTable`s: a sharded side dispatches to
    `db.shard.join.execute_join_sharded` (a plain other side wraps as
    one shard reusing its ciphertext rows).  Per-side `indexes` resolve
    filter leaves by binary search, and sort-merge reuses the join-key
    index's sorted run."""
    shard_mod = sys.modules.get("repro_torch.db.shard.table")
    if shard_mod is not None and (isinstance(left, shard_mod.ShardedTable)
                                  or isinstance(right, shard_mod.ShardedTable)):
        from repro_torch.db.shard.join import execute_join_sharded
        return execute_join_sharded(ks, left, right, join,
                                    strategy=strategy,
                                    left_indexes=left_indexes,
                                    right_indexes=right_indexes,
                                    block_pairs=block_pairs)
    cj = P.compile_join(join)
    lcol, rcol = cj.on_columns
    left_indexes = left_indexes or {}
    right_indexes = right_indexes or {}
    stats = JoinStats()
    stats.strategy = resolve_strategy(strategy, lcol in left_indexes,
                                      rcol in right_indexes)
    lmask = _side_mask(ks, left, cj.left_plan, indexes=left_indexes,
                       stats=stats.left)
    rmask = _side_mask(ks, right, cj.right_plan, indexes=right_indexes,
                       stats=stats.right)
    tau = join_tau(ks, join)
    if stats.strategy == "nested":
        vals = pair_eval_values(ks, left.column(lcol), right.column(rcol),
                                block_pairs=block_pairs, stats=stats)
        pairs = pairs_from_grid(vals, tau, lmask, rmask)
    else:
        lrun_ct, lrun_ids = _sorted_run(ks, left, lcol,
                                        left_indexes.get(lcol), stats)
        rrun_ct, rrun_ids = _sorted_run(ks, right, rcol,
                                        right_indexes.get(rcol), stats)
        pairs = merge_runs_to_pairs(
            ks, [(lrun_ct, lrun_ids), (rrun_ct, rrun_ids + left.n_padded)],
            left.n_padded, tau, verify=needs_verify(ks, join),
            gather_left=lambda rows: left.gather(lcol, rows),
            gather_right=lambda rows: right.gather(rcol, rows),
            left_mask=lmask, right_mask=rmask, stats=stats)
    columns = _project(cj, left.gather, right.gather, pairs)
    return JoinResult(pairs=pairs, left_mask=lmask[:left.n_rows],
                      right_mask=rmask[:right.n_rows],
                      columns=columns, stats=stats)
