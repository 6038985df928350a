"""Batched multi-query serving over one encrypted table.

The port of `repro.db.query_serve` for plain queries: client queries
enqueue, the server drains them in fixed-size batches, and each batch
executes against the table in one vectorized pass —

  * every scan atom of every query in the batch joins ONE fused
    [sum(A_i), N] raw-eval pass (`executor.fused_eval`: on the card, one
    Eval-kernel launch per lane-budget tile);
  * every index-eligible leaf joins ONE lane-batched binary search per
    index (2 lanes per Range/Eq);
  * float (CKKS) lanes carry their predicate's decode threshold, so a
    batch mixing exact and ε-tolerant predicates still fuses;
  * JOINS batch too (`submit_join`): a join's left-side filter leaves
    bind into the SAME shared scan/index launches as plain queries, and
    nested-loop pair grids dedupe across the batch — K joins against the
    same right table and key columns share ONE tiled raw-eval grid, each
    join applying its own τ/ε and masks host-side.

Per-query combine / order / limit stages then run on each query's own
mask.

MUTATIONS interleave with queries on the same queue (`submit_insert` /
`submit_delete` / `submit_update`): the drain splits the queue into
maximal same-kind runs in submit order, so a query enqueued after an
insert sees the inserted rows, and each query batch answers over base ∪
delta (the shared fused scan widens by the delta block; the lane-batched
index searches add ONE per-delta-run search per column).  `compact()`
retires the pending delta between batches (`db.delta.compact`);
`compact_threshold` triggers it once the delta outgrows the threshold.

Usage (on the card; `--device cpu` runs the plain path):
  PYTHONPATH=src python -m repro_torch.db.query_serve --dataset hg38 \
      --requests 8 --batch 4 --rows 4096
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.ckks import eps_to_tau
from repro_torch.core.keys import KeySet
from repro_torch.db import delta as D
from repro_torch.db import executor as X
from repro_torch.db import join as J
from repro_torch.db import plan as P
from repro_torch.db.index import SortedIndex, _stack_cts
from repro_torch.db.table import Table, rows_to_mask


@dataclasses.dataclass
class BatchStats:
    """Shared-launch accounting for one drained batch (the fused Eval, the
    lane-batched searches and the deduped join grids are counted ONCE
    here; per-query shares live on each result's own stats)."""
    queries: int = 0
    joins: int = 0
    eval_calls: int = 0
    scan_compares: int = 0
    index_compares: int = 0
    delta_build_compares: int = 0  # lazy per-delta-run index builds
    grid_evals: int = 0            # deduped nested-join pair-grid tiles
    pair_compares: int = 0         # deduped pair-grid lanes
    wall_s: float = 0.0


@dataclasses.dataclass
class MutationResult:
    """Outcome of one queued mutation: the inserted rows' global ids
    (empty for a pure delete) and the newly-tombstoned row count."""
    kind: str                      # "insert" | "delete" | "update"
    row_ids: np.ndarray
    deleted: int = 0


@dataclasses.dataclass
class _QueuedMutation:
    """A submitted write: insert data, delete rows, or both (update).
    The new rows encrypt under `seed`, or from pre-drawn `samples`."""
    kind: str
    rows: Optional[np.ndarray] = None
    data: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    samples: Optional[Dict[str, tuple]] = None


@dataclasses.dataclass
class _QueuedJoin:
    """A submitted join: the plan plus its right-hand table context."""
    join: P.Join
    right: Table
    right_indexes: Dict[str, SortedIndex]
    strategy: str


class QueryServer:
    """Queue + batch executor over one encrypted table."""

    def __init__(self, ks: KeySet, table: Table, *,
                 indexes: Optional[Dict[str, SortedIndex]] = None,
                 batch: int = 4, compact_threshold: Optional[int] = None,
                 lane_budget: Optional[int] = None):
        self.ks = ks
        self.table = table
        self.indexes = indexes or {}
        self.batch = int(batch)
        self.compact_threshold = compact_threshold
        self.compaction_log: list = []
        # per-launch eval-lane cap for the shared fused scans
        # (None = the kernels.ops policy default)
        self.lane_budget = lane_budget
        self._queue: List[Tuple[int, P.Query]] = []
        self._next_id = 0
        self.batch_log: List[BatchStats] = []
        self._tenants: Dict[int, str] = {}     # request id -> tenant label
        # server-scope memo of on-the-fly sort-merge runs: (id(table),
        # column) -> (weakref to the table, version at build, sorted run).
        # A hit needs the referent to STILL be the probing table (ids are
        # recycled) and its version to match (every mutation bumps it);
        # the weakref's callback evicts the entry when the table dies
        self._run_cache: Dict[Tuple[int, str],
                              Tuple["weakref.ref", int, tuple]] = {}

    # -- queue -------------------------------------------------------------

    def _enqueue(self, item, tenant: Optional[str]) -> int:
        """Assign the next request id, remember its tenant, enqueue."""
        qid = self._next_id
        self._next_id += 1
        if tenant is not None:
            self._tenants[qid] = tenant
        self._queue.append((qid, item))
        return qid

    def submit(self, query, *, tenant: Optional[str] = None) -> int:
        """Enqueue a Query (or bare predicate); returns a request id.
        `tenant` labels the request for per-tenant metrics attribution."""
        if isinstance(query, P.Predicate):
            query = P.Query(where=query)
        return self._enqueue(query, tenant)

    def submit_join(self, join: P.Join, right: Table, *,
                    right_indexes: Optional[Dict[str, SortedIndex]] = None,
                    strategy: str = "auto",
                    tenant: Optional[str] = None) -> int:
        """Enqueue a Join of the server's table (left side) against
        `right`; returns a request id resolving to a `JoinResult`.

        The join's LEFT filter leaves fuse into the batch's shared
        scan/index launches; its nested-loop pair grid dedupes with every
        other queued join naming the same `right` table and key columns.
        `right_indexes` serve the right-side filters and (with a left
        index on the server) enable the sort-merge strategy."""
        P.compile_join(join)          # validate kind/on shape at submit time
        return self._enqueue(_QueuedJoin(join, right,
                                         dict(right_indexes or {}),
                                         strategy), tenant)

    def submit_insert(self, data: Dict[str, np.ndarray], seed: int = 0, *,
                      samples: Optional[Dict[str, tuple]] = None,
                      tenant: Optional[str] = None) -> int:
        """Enqueue an insert of new rows (encrypted under `seed`, or from
        pre-drawn `samples` as `Table.insert` takes them); resolves to a
        `MutationResult` carrying the rows' global ids.  Queries
        submitted AFTER this see the new rows."""
        return self._enqueue(_QueuedMutation("insert", data=data, seed=seed,
                                             samples=samples), tenant)

    def submit_delete(self, rows, *, tenant: Optional[str] = None) -> int:
        """Enqueue a tombstone of the given global row ids; resolves to
        a `MutationResult` with the newly-dead count."""
        return self._enqueue(_QueuedMutation(
            "delete", rows=np.asarray(rows, np.int64)), tenant)

    def submit_update(self, rows, data: Dict[str, np.ndarray],
                      seed: int = 0, *,
                      samples: Optional[Dict[str, tuple]] = None,
                      tenant: Optional[str] = None) -> int:
        """Enqueue an update (tombstone `rows` + insert replacements);
        resolves to a `MutationResult` with the replacement global ids."""
        return self._enqueue(_QueuedMutation(
            "update", rows=np.asarray(rows, np.int64), data=data, seed=seed,
            samples=samples), tenant)

    def clear_queue(self) -> int:
        """Drop every queued, not-yet-drained request; returns how many
        were dropped (the reset after `run()` raised mid-drain)."""
        dropped = len(self._queue)
        self._queue = []
        return dropped

    @contextlib.contextmanager
    def batch_size(self, n: int):
        """Temporarily set the drain batch size (restored on exit, even
        if the drain raises)."""
        old, self.batch = self.batch, max(1, int(n))
        try:
            yield self
        finally:
            self.batch = old

    def _bill_tenant(self, qid: int, stats) -> None:
        """Per-tenant served-query + compare-lane attribution (counted
        only when the obs layer is enabled)."""
        if not obs.is_enabled():
            return
        tenant = self._tenants.get(qid, "default")
        obs.count("server.queries", 1, tenant=tenant)
        compares = getattr(stats, "filter_compares",
                           getattr(stats, "join_compares", 0))
        obs.count("server.compares", compares, tenant=tenant)

    def run(self) -> Dict[int, object]:
        """Drain the queue; returns {request id: result} (a `QueryResult`
        per query, a `JoinResult` per join, a `MutationResult` per
        mutation).  The queue splits
        into maximal same-kind runs in submit order: query runs drain in
        shared-launch batches, mutation runs apply in turn, so reads
        observe exactly the writes submitted before them.  After a
        mutation run, `compact_threshold` may trigger a compaction."""
        results: Dict[int, object] = {}
        while self._queue:
            is_mut = isinstance(self._queue[0][1], _QueuedMutation)
            n = 1
            while (n < len(self._queue) and isinstance(
                    self._queue[n][1], _QueuedMutation) == is_mut):
                n += 1
            chunk, self._queue = self._queue[:n], self._queue[n:]
            if is_mut:
                for qid, m in chunk:
                    results[qid] = self._apply_mutation(m)
                if (self.compact_threshold is not None
                        and self.table.n_delta >= self.compact_threshold):
                    self.compact()
            else:
                for i in range(0, len(chunk), self.batch):
                    results.update(self._run_batch(chunk[i:i + self.batch]))
        return results

    # -- mutations ---------------------------------------------------------

    def _apply_mutation(self, m: _QueuedMutation) -> MutationResult:
        table = self.table
        with obs.span("server.mutation", kind=m.kind), \
                obs.count_mallocs("server.mutation", self.ks.device):
            deleted = 0
            if m.rows is not None:
                deleted = table.delete(m.rows)
            row_ids = np.zeros(0, np.int64)
            if m.data is not None:
                row_ids = table.insert(self.ks, m.data, m.seed,
                                       samples=m.samples)
        return MutationResult(m.kind, row_ids, deleted=deleted)

    def compact(self):
        """Retire the pending delta run NOW (between batches): fold it into
        the base and merge it into every served index
        (`db.delta.compact`).  Returns the `CompactionStats`, also
        appended to `compaction_log`."""
        stats = D.compact(self.ks, self.table, self.indexes)
        self.compaction_log.append(stats)
        return stats

    # -- batch execution ---------------------------------------------------

    def _run_batch(self, chunk: List[Tuple[int, object]],
                   ) -> Dict[int, object]:
        with obs.span("server.batch", size=len(chunk)) as bsp:
            return self._run_batch_traced(chunk, bsp)

    def _run_batch_traced(self, chunk: List[Tuple[int, object]], bsp,
                          ) -> Dict[int, object]:
        t0 = time.perf_counter()
        ks, table = self.ks, self.table
        W = table.scan_width
        queries: List[Tuple[int, P.CompiledPlan]] = []
        joins: List[Tuple[int, P.CompiledJoin, _QueuedJoin]] = []
        for qid, item in chunk:
            if isinstance(item, _QueuedJoin):
                joins.append((qid, P.compile_join(item.join), item))
            else:
                queries.append((qid, P.compile_plan(item)))
        bstats = BatchStats(queries=len(queries), joins=len(joins))

        # slots: every left-table plan whose leaves ride the shared
        # launches — plain queries first, then joins' left sub-plans
        plans: List[Tuple[Optional[int], P.CompiledPlan]] = list(queries)
        join_slot: List[Optional[int]] = []
        for _, cj, _ in joins:
            if cj.left_plan is not None:
                join_slot.append(len(plans))
                plans.append((None, cj.left_plan))
            else:
                join_slot.append(None)

        # partition every slot's leaves into index lanes vs scan atoms
        scan_atoms: List[P.Atom] = []
        scan_ref: List[Tuple[int, int, int, int]] = []  # (plan#, leaf, start, count)
        lane_cts: Dict[str, list] = {}                   # column -> [ct, ...]
        lane_strict: Dict[str, list] = {}
        lane_taus: Dict[str, list] = {}                  # per-lane decode τ
        lane_ref: Dict[str, list] = {}                   # -> (plan#, leaf)
        for pi, (_, plan) in enumerate(plans):
            for li, leaf in enumerate(plan.leaves):
                idx = self.indexes.get(leaf.column)
                if idx is not None:
                    lo, hi = ((leaf.lo, leaf.hi) if isinstance(leaf, P.Range)
                              else (leaf.value, leaf.value))
                    tau = (ks.params.tau if leaf.eps is None
                           else eps_to_tau(ks.params, leaf.eps))
                    lane_cts.setdefault(leaf.column, []).extend([lo, hi])
                    lane_strict.setdefault(leaf.column, []).extend(
                        [False, True])
                    lane_taus.setdefault(leaf.column, []).extend([tau, tau])
                    lane_ref.setdefault(leaf.column, []).append((pi, li))
                else:
                    atoms = plan.scan_atoms(li)
                    scan_ref.append((pi, li, len(scan_atoms), len(atoms)))
                    scan_atoms.extend(atoms)

        leaf_masks: List[List[Optional[np.ndarray]]] = [
            [None] * plan.num_leaves for _, plan in plans]
        # per-query stats bill each query its own leaves/compares; shared
        # launches are counted once in BatchStats
        qstats = [X.ExecStats() for _ in plans]

        # ONE lane-batched binary search per index (all queries together);
        # a pending delta run adds ONE more lane-batched search per column
        # against its own (lazily built, cached) sorted run
        for column, cts in lane_cts.items():
            idx = self.indexes[column]
            lanes = _stack_cts(cts)
            strict = np.asarray(lane_strict[column])
            taus = np.asarray(lane_taus[column], np.int64)
            before = idx.search_compares
            pos = idx.search(ks, lanes, strict, taus)
            bstats.index_compares += idx.search_compares - before
            counts = idx.last_probe_counts.copy()
            didx = X.delta_probe_index(ks, table, column, bstats)
            dpos = dcounts = None
            if didx is not None:
                before = didx.search_compares
                dpos = didx.search(ks, lanes, strict, taus)
                bstats.index_compares += didx.search_compares - before
                dcounts = didx.last_probe_counts.copy()
            for j, (pi, li) in enumerate(lane_ref[column]):
                l, r = int(pos[2 * j]), int(pos[2 * j + 1])
                slots = [np.asarray(idx.perm[l:r], np.int64)]
                qstats[pi].indexed_leaves += 1
                qstats[pi].index_compares += int(counts[2 * j]
                                                 + counts[2 * j + 1])
                if dpos is not None:
                    dl, dr = int(dpos[2 * j]), int(dpos[2 * j + 1])
                    slots.append(table.n_padded
                                 + np.asarray(didx.perm[dl:dr], np.int64))
                    qstats[pi].index_compares += int(
                        dcounts[2 * j] + dcounts[2 * j + 1])
                leaf_masks[pi][li] = rows_to_mask(np.concatenate(slots), W)

        # ONE fused Eval pass for every scan atom of every query
        if scan_atoms:
            vals = X.fused_eval(ks, table, scan_atoms,
                                lane_budget=self.lane_budget)
            bstats.eval_calls += 1
            bstats.scan_compares += len(scan_atoms) * W
            for pi, li, start, count in scan_ref:
                leaf_masks[pi][li] = X.scan_leaf_mask(ks, scan_atoms, vals,
                                                      start, count)
                qstats[pi].scan_leaves += 1
                qstats[pi].scan_compares += count * W
                qstats[pi].eval_calls = 1     # its share of the fused pass

        # per-query combine + order/limit/project over the union slot
        # space (join slots resolve in `_run_joins`); pads and tombstones
        # drop via slot_valid
        results: Dict[int, object] = {}
        with obs.span("server.combine", queries=len(queries)):
            for pi, (qid, plan) in enumerate(plans):
                if qid is None:
                    continue
                stats = qstats[pi]
                slot_mask = X.combine_tree(plan.tree, leaf_masks[pi], W)
                slot_mask &= table.slot_valid
                row_ids = table.slot_global_ids[np.nonzero(slot_mask)[0]]
                gmask = rows_to_mask(row_ids, table.n_total)
                row_ids = X.order_rows(ks, table, plan.query, row_ids, stats)
                columns = {c: table.gather(c, row_ids)
                           for c in plan.query.select}
                results[qid] = X.QueryResult(
                    row_ids=row_ids, mask=gmask, columns=columns,
                    stats=stats)
                self._bill_tenant(qid, stats)

        if joins:
            with obs.span("server.joins", joins=len(joins)):
                jres = self._run_joins(joins, join_slot, leaf_masks,
                                       qstats, bstats)
            for qid, r in jres.items():
                self._bill_tenant(qid, r.stats)
            results.update(jres)
        bstats.wall_s = time.perf_counter() - t0
        bsp.set(queries=bstats.queries, joins=bstats.joins,
                eval_calls=bstats.eval_calls)
        obs.absorb_batch_stats(bstats)
        if obs.is_enabled() and table.n_rows:
            obs.observe("pad.waste", table.n_padded / table.n_rows)
        self.batch_log.append(bstats)
        return results

    def _side_run(self, side_table: Table, col: str,
                  index: Optional[SortedIndex], jstats: J.JoinStats):
        """A sort-merge side's ascending run: its index's, or one built on
        the fly and memoized in `_run_cache` until the table mutates or
        dies."""
        if index is not None:
            return index.sorted_run()
        key = (id(side_table), col)
        hit = self._run_cache.get(key)
        if (hit is not None and hit[0]() is side_table
                and hit[1] == side_table.version):
            return hit[2]
        run = J._sorted_run(self.ks, side_table, col, None, jstats)

        def evict(ref, key=key, cache=self._run_cache):
            ent = cache.get(key)
            if ent is not None and ent[0] is ref:
                del cache[key]
        self._run_cache[key] = (weakref.ref(side_table, evict),
                                side_table.version, run)
        return run

    def _run_joins(self, joins, join_slot, leaf_masks, qstats,
                   bstats: BatchStats) -> Dict[int, J.JoinResult]:
        """Resolve the batch's joins after the shared leaf launches.

        Nested-loop pair grids dedupe by (right table, key columns): each
        distinct triple costs ONE tiled raw-eval grid for the batch, every
        join decoding it under its own τ/ε and masks.  Sort-merge runs
        come from the sides' indexes, or from the server-scope run cache
        (`_side_run`)."""
        ks, table = self.ks, self.table
        grids: Dict[Tuple[int, str, str], np.ndarray] = {}
        out: Dict[int, J.JoinResult] = {}
        for (qid, cj, item), slot in zip(joins, join_slot):
            lcol, rcol = cj.on_columns
            right = item.right
            jstats = J.JoinStats()
            jstats.strategy = J.resolve_strategy(
                item.strategy, lcol in self.indexes,
                rcol in item.right_indexes)
            lmask = J._side_mask(
                ks, table, cj.left_plan, indexes=self.indexes,
                stats=jstats.left,
                leaf_masks=None if slot is None else leaf_masks[slot])
            if slot is not None:      # its leaves rode the shared launches
                jstats.left.scan_leaves += qstats[slot].scan_leaves
                jstats.left.indexed_leaves += qstats[slot].indexed_leaves
                jstats.left.scan_compares += qstats[slot].scan_compares
                jstats.left.index_compares += qstats[slot].index_compares
            rmask = J._side_mask(ks, right, cj.right_plan,
                                 indexes=item.right_indexes,
                                 stats=jstats.right)
            tau = J.join_tau(ks, item.join)
            if jstats.strategy == "nested":
                key = (id(right), lcol, rcol)
                if key not in grids:
                    scratch = J.JoinStats()
                    grids[key] = J.pair_eval_values(
                        ks, table.column(lcol), right.column(rcol),
                        block_pairs=self.lane_budget, stats=scratch)
                    bstats.grid_evals += scratch.eval_calls
                    bstats.pair_compares += scratch.pair_compares
                jstats.pair_compares += table.n_padded * right.n_padded
                jstats.eval_calls = 1      # its share of the deduped grid
                pairs = J.pairs_from_grid(grids[key], tau, lmask, rmask)
            else:
                lrun = self._side_run(table, lcol, self.indexes.get(lcol),
                                      jstats)
                rrun_ct, rrun_ids = self._side_run(
                    right, rcol, item.right_indexes.get(rcol), jstats)
                pairs = J.merge_runs_to_pairs(
                    ks, [lrun, (rrun_ct, rrun_ids + table.n_padded)],
                    table.n_padded, tau,
                    verify=J.needs_verify(ks, item.join),
                    gather_left=lambda rows: table.gather(lcol, rows),
                    gather_right=lambda rows, r=right: r.gather(rcol, rows),
                    left_mask=lmask, right_mask=rmask, stats=jstats)
            columns = J._project(cj, table.gather, right.gather, pairs)
            out[qid] = J.JoinResult(
                pairs=pairs, left_mask=lmask[:table.n_rows],
                right_mask=rmask[:right.n_rows], columns=columns,
                stats=jstats)
        return out


# ---------------------------------------------------------------------------
# CLI demo: random range queries against a paper dataset
# ---------------------------------------------------------------------------

def main(argv=None) -> dict:
    """CLI demo: serve random encrypted range queries over a paper
    dataset in batches (see the module docstring for usage)."""
    from repro_torch.core import encrypt as E
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.data import load_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="hg38")
    ap.add_argument("--rows", type=int, default=4096,
                    help="0 = full dataset")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--index", action="store_true",
                    help="build a sorted index and serve lookups through it")
    ap.add_argument("--lane-budget", type=int, default=0,
                    help="eval lanes per fused-scan launch "
                         "(0 = kernels.ops policy default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain path)")
    args = ap.parse_args(argv)

    params = make_params("test-bfv", mode="gadget")
    ks = keygen(params, args.seed, device=args.device)
    vals = load_dataset(args.dataset, scheme="bfv", t=params.t)
    if args.rows:
        vals = vals[:args.rows]
    vals = (vals % (params.max_operand // 2)).astype(np.int64)

    table = Table.from_arrays(ks, args.dataset, {"value": vals},
                              args.seed + 1)
    indexes = {}
    t_build = 0.0
    if args.index:
        t0 = time.perf_counter()
        indexes["value"] = SortedIndex.build(ks, table, "value")
        t_build = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    server = QueryServer(ks, table, indexes=indexes, batch=args.batch,
                         lane_budget=args.lane_budget or None)
    truth = {}
    for _ in range(args.requests):
        lo, hi = np.sort(rng.choice(vals, 2, replace=False))
        ct_lo = E.encrypt(ks, int(lo), int(rng.integers(1 << 30)))
        ct_hi = E.encrypt(ks, int(hi), int(rng.integers(1 << 30)))
        qid = server.submit(P.Range("value", ct_lo, ct_hi))
        truth[qid] = np.nonzero((vals >= lo) & (vals <= hi))[0]

    t0 = time.perf_counter()
    results = server.run()
    wall = time.perf_counter() - t0
    correct = sum(int(np.array_equal(np.sort(r.row_ids), truth[qid]))
                  for qid, r in results.items())
    out = {
        "dataset": args.dataset, "rows": int(len(vals)),
        "device": str(ks.device),
        "requests": args.requests, "batch": args.batch,
        "indexed": bool(args.index),
        "index_build_s": round(t_build, 3),
        "wall_s": round(wall, 3),
        "queries_per_s": round(args.requests / wall, 2),
        "fused_eval_calls": sum(b.eval_calls for b in server.batch_log),
        "scan_compares": sum(b.scan_compares for b in server.batch_log),
        "index_compares": sum(b.index_compares for b in server.batch_log),
        "correct": f"{correct}/{args.requests}",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
