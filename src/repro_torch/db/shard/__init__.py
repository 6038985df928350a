"""repro_torch.db.shard — logically sharded encrypted tables.

Partitions ciphertext rows into S logical shards (`ShardSpec`,
decoupled from devices) placed on a shard mesh of one or several cards
(`ShardSpec.place`: per-card slabs of each column stack), runs the fused
filter stage over the shard-stacked columns (per slab, on its card),
resolves OrderBy/TopK with per-shard bitonic networks + log-depth
cross-shard merge networks, and fans lookups out over per-shard sorted
indexes in one lane-batched launch per step.
Decrypted answers are independent of the shard count.

    ShardSpec          — logical shard count + the shard mesh
    ShardedTable       — [S, N_sp, ...] stacked encrypted columns
    ShardedIndex       — per-shard SortedIndexes, fan-out binary search
    execute_sharded    — the sharded plan executor (db.execute dispatches
                         here for ShardedTable arguments)
    execute_join_sharded — cross-shard joins on the [S_l, S_r] pair grid
                         (db.execute_join dispatches here)
    ShardedQueryServer — K queries x S shards in one pass
"""
from repro_torch.db.shard.executor import (  # noqa: F401
    ShardedExecStats,
    execute_sharded,
    sharded_fused_eval,
)
from repro_torch.db.shard.index import ShardedIndex  # noqa: F401
from repro_torch.db.shard.join import (  # noqa: F401
    execute_join_sharded,
    sharded_pair_eval,
)
from repro_torch.db.shard.serve import (  # noqa: F401
    ShardedBatchStats,
    ShardedQueryServer,
)
from repro_torch.db.shard.spec import ShardSpec  # noqa: F401
from repro_torch.db.shard.table import ShardedTable  # noqa: F401
