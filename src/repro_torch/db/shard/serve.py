"""`ShardedQueryServer`: K client queries × S shards in one pass.

The port of `repro.db.shard.serve`: the `db.query_serve.QueryServer`
queue/batch pattern lifted onto a `ShardedTable`.  A drained batch of K
queries routes to ALL shards in one sweep —

  * every scan atom of every query joins ONE shard-stacked raw-eval pass
    over `[S, ΣA_i, W]` (`shard.executor.sharded_fused_eval`);
  * every index-eligible leaf joins ONE fan-out binary search per indexed
    column (the `[S, 2K]` probe grid of all queries against all shards);
  * per-query combine / merge-order stages then run on each query's
    global mask.

The queue, MUTATIONS and compaction are the single-table server's
(`ShardedQueryServer` subclasses `QueryServer`): same-kind runs drain
in submit order, query batches answer over base ∪ delta, and `compact()`
/ `compact_threshold` retire deltas between batches through the
per-shard merge networks (`db.delta.compact` takes either table).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.ckks import eps_to_tau
from repro_torch.db import executor as X
from repro_torch.db import plan as P
from repro_torch.db.index import _stack_cts
from repro_torch.db.query_serve import QueryServer
from repro_torch.db.shard import executor as SX
from repro_torch.db.shard.table import ShardedTable


@dataclasses.dataclass
class ShardedBatchStats:
    """Shared-launch accounting for one drained batch across all shards
    (the fused pass and the fan-out searches count ONCE here; per-query
    shares live on each result's own stats)."""
    queries: int = 0
    shards: int = 0
    eval_calls: int = 0
    scan_compares: int = 0
    per_shard_scan_compares: int = 0
    index_compares: int = 0
    delta_build_compares: int = 0
    merge_compares: int = 0
    wall_s: float = 0.0


class ShardedQueryServer(QueryServer):
    """Queue + batch executor over one sharded encrypted table,
    `ShardedQueryServer(ks, stable, indexes=..., batch=...)` with
    `ShardedIndex`es: the `QueryServer` queue, mutations and compaction
    over `stable` (its `table`), with batches run shard-stacked."""

    @property
    def stable(self) -> ShardedTable:
        """The served sharded table."""
        return self.table

    def submit_join(self, *args, **kwargs) -> int:
        raise TypeError("a ShardedQueryServer serves no joins: run them "
                        "through repro_torch.db.execute_join")

    # -- batch execution ---------------------------------------------------

    def _run_batch(self, chunk: List[Tuple[int, P.Query]],
                   ) -> Dict[int, X.QueryResult]:
        with obs.span("server.shard_batch", size=len(chunk),
                      shards=self.stable.num_shards) as bsp:
            return self._run_batch_traced(chunk, bsp)

    def _run_batch_traced(self, chunk: List[Tuple[int, P.Query]], bsp,
                          ) -> Dict[int, X.QueryResult]:
        t0 = time.perf_counter()
        ks, stable = self.ks, self.stable
        S, N = stable.num_shards, stable.n_padded_per_shard
        W = stable.shard_scan_width   # base block ∪ pending delta block
        plans = [(qid, P.compile_plan(q)) for qid, q in chunk]
        bstats = ShardedBatchStats(queries=len(chunk), shards=S)

        # partition leaves into fan-out index lanes vs scan atoms
        scan_atoms: List[P.Atom] = []
        scan_ref: List[Tuple[int, int, int, int]] = []
        lane_cts: Dict[str, list] = {}
        lane_strict: Dict[str, list] = {}
        lane_taus: Dict[str, list] = {}
        lane_ref: Dict[str, list] = {}
        for pi, (_, plan) in enumerate(plans):
            for li, leaf in enumerate(plan.leaves):
                idx = self.indexes.get(leaf.column)
                if idx is not None:
                    lo, hi = ((leaf.lo, leaf.hi)
                              if isinstance(leaf, P.Range)
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

        leaf_masks: List[List[Optional[List[np.ndarray]]]] = [
            [None] * plan.num_leaves for _, plan in plans]
        qstats = [SX.ShardedExecStats(shards=S,
                                      mesh_devices=stable.spec.mesh_devices)
                  for _ in plans]

        # ONE fan-out search per indexed column ([S, 2K] probe grid); every
        # shard holding a pending delta run adds ONE more lane-batched
        # search against its own per-run index
        for column, cts in lane_cts.items():
            idx = self.indexes[column]
            lanes = _stack_cts(cts)
            strict = np.asarray(lane_strict[column])
            taus = np.asarray(lane_taus[column], np.int64)
            before = idx.search_compares
            pos = idx.search(ks, lanes, strict, taus)
            bstats.index_compares += idx.search_compares - before
            base_counts = idx.last_probe_counts.copy()
            dsearch = {}
            for s in range(S):
                didx = SX.shard_delta_probe_index(ks, stable, column, s,
                                                  bstats)
                if didx is None:
                    continue
                before = didx.search_compares
                dsearch[s] = (didx, didx.search(ks, lanes, strict, taus),
                              didx.last_probe_counts.copy())
                bstats.index_compares += didx.search_compares - before
            for j, (pi, li) in enumerate(lane_ref[column]):
                masks = idx.lane_masks(pos, j, W)
                # this query's two boundary lanes, base fan-out AND every
                # delta-run search (sums across queries reconcile)
                qstats[pi].index_compares += int(
                    base_counts[2 * j] + base_counts[2 * j + 1])
                for s, (didx, dpos, dcounts) in dsearch.items():
                    dl, dr = int(dpos[2 * j]), int(dpos[2 * j + 1])
                    masks[s][N + np.asarray(didx.perm[dl:dr],
                                            np.int64)] = True
                    qstats[pi].index_compares += int(
                        dcounts[2 * j] + dcounts[2 * j + 1])
                leaf_masks[pi][li] = masks
                qstats[pi].indexed_leaves += 1

        # ONE shard-stacked fused pass for every scan atom in the batch
        # (over the union scan width: base blocks AND delta runs)
        if scan_atoms:
            vals = SX.sharded_fused_eval(ks, stable, scan_atoms,
                                         lane_budget=self.lane_budget)
            bstats.eval_calls += 1
            bstats.scan_compares += len(scan_atoms) * S * W
            bstats.per_shard_scan_compares += len(scan_atoms) * W
            for pi, li, start, count in scan_ref:
                leaf_masks[pi][li] = [
                    X.scan_leaf_mask(ks, scan_atoms, vals[s], start, count)
                    for s in range(S)]
                qstats[pi].scan_leaves += 1
                qstats[pi].scan_compares += count * S * W
                qstats[pi].per_shard_scan_compares += count * W
                qstats[pi].eval_calls = 1

        # per-query combine + merge-order/limit/project
        results: Dict[int, X.QueryResult] = {}
        for pi, (qid, plan) in enumerate(plans):
            stats = qstats[pi]
            mask = SX.combine_shard_masks(stable, plan, leaf_masks[pi])
            row_ids = np.nonzero(mask)[0]
            row_ids = SX.order_rows_sharded(ks, stable, plan.query,
                                            row_ids, stats)
            columns = {c: stable.gather_global(c, row_ids)
                       for c in plan.query.select}
            bstats.merge_compares += stats.merge_compares
            results[qid] = X.QueryResult(row_ids=row_ids, mask=mask,
                                         columns=columns, stats=stats)
            self._bill_tenant(qid, stats)
        bstats.wall_s = time.perf_counter() - t0
        bsp.set(queries=bstats.queries, eval_calls=bstats.eval_calls)
        obs.absorb_batch_stats(bstats, shards=str(S))
        self.batch_log.append(bstats)
        return results
