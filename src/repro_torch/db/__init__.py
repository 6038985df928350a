"""The encrypted query engine over HADES comparisons, on PyTorch.

    Table        — named Ciphertext columns, rows padded to powers of two
    SortedIndex  — built once via encrypted_sort; binary-search lookups
    Range/Eq/And/Or/Not + OrderBy/TopK/Limit/Query — the plan IR
    Join         — two-table equi-join node (ε-band capable)
    compile_plan / execute — lower + run a plan (indexes optional)
    execute_join — batched nested-loop or sort-merge join execution
    QueryServer  — K client queries (and joins) against one table in one
                   fused pass, with inserts/deletes/updates on the queue
    compact      — fold a table's pending delta run into base + indexes
    ServeLoop    — always-on multi-tenant loop: admission control,
                   two-class deadline scheduling, pow2 batch buckets,
                   write barriers and per-request fault isolation over
                   any number of servers

Writes (`Table.insert/delete/update`) land in a small delta run and as
host-side tombstones; every read answers over base ∪ delta, and
`compact` retires the run through the merge network.

Sharded variants (`repro_torch.db.shard`): ShardSpec / ShardedTable /
ShardedIndex / ShardedQueryServer partition rows into logical shards on
one card, with cross-shard merge stages; `execute`, `execute_join` and
`compact` dispatch automatically.
"""
from repro_torch.core.ckks import eps_to_tau, equality_tolerance  # noqa: F401
from repro_torch.core.compare import (  # noqa: F401
    encrypted_sort,
    encrypted_topk,
    range_query,
)
from repro_torch.db.delta import (  # noqa: F401
    CompactionStats,
    compact,
    merge_index_runs,
)
from repro_torch.db.executor import (  # noqa: F401
    ExecStats,
    QueryResult,
    execute,
    fused_compare,
    fused_eval,
)
from repro_torch.db.index import SortedIndex  # noqa: F401
from repro_torch.db.join import (  # noqa: F401
    JoinResult,
    JoinStats,
    execute_join,
)
from repro_torch.db.plan import (  # noqa: F401
    And,
    Atom,
    CompiledJoin,
    CompiledPlan,
    Eq,
    Join,
    Limit,
    Not,
    Or,
    OrderBy,
    Query,
    Range,
    TopK,
    compile_join,
    compile_plan,
)
from repro_torch.db.table import Table  # noqa: F401


_SHARD_EXPORTS = ("ShardSpec", "ShardedTable", "ShardedIndex",
                  "ShardedQueryServer", "ShardedExecStats",
                  "execute_sharded", "execute_join_sharded")

_SERVE_EXPORTS = ("QueryServer", "BatchStats", "MutationResult")

_LOOP_EXPORTS = ("ServeLoop", "AdmissionPolicy", "Response", "LoopStats")


def __getattr__(name):
    # lazy: keeps `python -m repro_torch.db.query_serve` (and
    # `.serve_loop`) free of the runpy double-import warning while
    # preserving `db.QueryServer`; the shard subsystem loads on first
    # use for the same reason
    if name in _SERVE_EXPORTS:
        from repro_torch.db import query_serve as _qs
        return getattr(_qs, name)
    if name in _LOOP_EXPORTS:
        from repro_torch.db import serve_loop as _sl
        return getattr(_sl, name)
    if name in _SHARD_EXPORTS:
        from repro_torch.db import shard as _shard
        return getattr(_shard, name)
    raise AttributeError(name)
