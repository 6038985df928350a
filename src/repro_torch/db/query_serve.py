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
    batch mixing exact and ε-tolerant predicates still fuses.

Per-query combine / order / limit stages then run on each query's own
mask.  Joins (`submit_join`) and mutations (`submit_insert/delete/
update`, `compact`) arrive with the join and write-path slices.

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
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.ckks import eps_to_tau
from repro_torch.core.keys import KeySet
from repro_torch.db import executor as X
from repro_torch.db import plan as P
from repro_torch.db.index import SortedIndex, _stack_cts
from repro_torch.db.table import Table, rows_to_mask


@dataclasses.dataclass
class BatchStats:
    """Shared-launch accounting for one drained batch (the fused Eval and
    the lane-batched searches are counted ONCE here; per-query shares
    live on each result's own stats)."""
    queries: int = 0
    eval_calls: int = 0
    scan_compares: int = 0
    index_compares: int = 0
    wall_s: float = 0.0


class QueryServer:
    """Queue + batch executor over one encrypted table."""

    def __init__(self, ks: KeySet, table: Table, *,
                 indexes: Optional[Dict[str, SortedIndex]] = None,
                 batch: int = 4, lane_budget: Optional[int] = None):
        self.ks = ks
        self.table = table
        self.indexes = indexes or {}
        self.batch = int(batch)
        # per-launch eval-lane cap for the shared fused scans
        # (None = the kernels.ops policy default)
        self.lane_budget = lane_budget
        self._queue: List[Tuple[int, P.Query]] = []
        self._next_id = 0
        self.batch_log: List[BatchStats] = []
        self._tenants: Dict[int, str] = {}     # request id -> tenant label

    # -- queue -------------------------------------------------------------

    def submit(self, query, *, tenant: Optional[str] = None) -> int:
        """Enqueue a Query (or bare predicate); returns a request id.
        `tenant` labels the request for per-tenant metrics attribution."""
        if isinstance(query, P.Predicate):
            query = P.Query(where=query)
        qid = self._next_id
        self._next_id += 1
        if tenant is not None:
            self._tenants[qid] = tenant
        self._queue.append((qid, query))
        return qid

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

    def _bill_tenant(self, qid: int, stats: X.ExecStats) -> None:
        """Per-tenant served-query + compare-lane attribution (counted
        only when the obs layer is enabled)."""
        if not obs.is_enabled():
            return
        tenant = self._tenants.get(qid, "default")
        obs.count("server.queries", 1, tenant=tenant)
        obs.count("server.compares", stats.filter_compares, tenant=tenant)

    def run(self) -> Dict[int, X.QueryResult]:
        """Drain the queue in batches; returns {request id: result}."""
        results: Dict[int, X.QueryResult] = {}
        while self._queue:
            chunk = self._queue[:self.batch]
            self._queue = self._queue[self.batch:]
            results.update(self._run_batch(chunk))
        return results

    # -- batch execution ---------------------------------------------------

    def _run_batch(self, chunk: List[Tuple[int, P.Query]],
                   ) -> Dict[int, X.QueryResult]:
        with obs.span("server.batch", size=len(chunk)) as bsp:
            return self._run_batch_traced(chunk, bsp)

    def _run_batch_traced(self, chunk: List[Tuple[int, P.Query]], bsp,
                          ) -> Dict[int, X.QueryResult]:
        t0 = time.perf_counter()
        ks, table = self.ks, self.table
        W = table.scan_width
        plans = [(qid, P.compile_plan(q)) for qid, q in chunk]
        bstats = BatchStats(queries=len(plans))

        # partition every plan's leaves into index lanes vs scan atoms
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

        # ONE lane-batched binary search per index (all queries together)
        for column, cts in lane_cts.items():
            idx = self.indexes[column]
            before = idx.search_compares
            pos = idx.search(ks, _stack_cts(cts),
                             np.asarray(lane_strict[column]),
                             np.asarray(lane_taus[column], np.int64))
            bstats.index_compares += idx.search_compares - before
            counts = idx.last_probe_counts
            for j, (pi, li) in enumerate(lane_ref[column]):
                l, r = int(pos[2 * j]), int(pos[2 * j + 1])
                qstats[pi].indexed_leaves += 1
                qstats[pi].index_compares += int(counts[2 * j]
                                                 + counts[2 * j + 1])
                leaf_masks[pi][li] = rows_to_mask(idx.perm[l:r], W)

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

        results: Dict[int, X.QueryResult] = {}
        for pi, (qid, plan) in enumerate(plans):
            stats = qstats[pi]
            slot_mask = X.combine_tree(plan.tree, leaf_masks[pi], W)
            slot_mask &= table.slot_valid
            row_ids = table.slot_global_ids[np.nonzero(slot_mask)[0]]
            gmask = rows_to_mask(row_ids, table.n_total)
            row_ids = X.order_rows(ks, table, plan.query, row_ids, stats)
            columns = {c: table.gather(c, row_ids)
                       for c in plan.query.select}
            results[qid] = X.QueryResult(
                row_ids=row_ids, mask=gmask, columns=columns, stats=stats)
            self._bill_tenant(qid, stats)

        bstats.wall_s = time.perf_counter() - t0
        bsp.set(queries=bstats.queries, eval_calls=bstats.eval_calls)
        obs.absorb_batch_stats(bstats)
        if obs.is_enabled() and table.n_rows:
            obs.observe("pad.waste", table.n_padded / table.n_rows)
        self.batch_log.append(bstats)
        return results


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
