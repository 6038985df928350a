"""The encrypted query engine over HADES comparisons, on PyTorch.

    Table        — named Ciphertext columns, rows padded to powers of two
    SortedIndex  — built once via encrypted_sort; binary-search lookups
    Range/Eq/And/Or/Not + OrderBy/TopK/Limit/Query — the plan IR
    compile_plan / execute — lower + run a plan (indexes optional)
    QueryServer  — K client queries against one table in one fused pass,
                   with inserts/deletes/updates on the same queue
    compact      — fold a table's pending delta run into base + indexes

Writes (`Table.insert/delete/update`) land in a small delta run and as
host-side tombstones; every read answers over base ∪ delta, and
`compact` retires the run through the merge network.  Joins, shards and
the serving loop of `repro.db` are not ported yet.
"""
from repro_torch.core.ckks import eps_to_tau, equality_tolerance  # noqa: F401
from repro_torch.core.compare import (  # noqa: F401
    encrypted_sort,
    encrypted_topk,
    range_query,
)
from repro_torch.db.delta import CompactionStats, compact  # noqa: F401
from repro_torch.db.executor import (  # noqa: F401
    ExecStats,
    QueryResult,
    execute,
    fused_eval,
)
from repro_torch.db.index import SortedIndex  # noqa: F401
from repro_torch.db.plan import (  # noqa: F401
    And,
    Atom,
    CompiledPlan,
    Eq,
    Limit,
    Not,
    Or,
    OrderBy,
    Query,
    Range,
    TopK,
    compile_plan,
)
from repro_torch.db.table import Table  # noqa: F401


def __getattr__(name):
    # lazy: keeps `python -m repro_torch.db.query_serve` free of the
    # runpy double-import warning while preserving `db.QueryServer`
    if name in ("QueryServer", "BatchStats", "MutationResult"):
        from repro_torch.db import query_serve as _qs
        return getattr(_qs, name)
    raise AttributeError(name)
