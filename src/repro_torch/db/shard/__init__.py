"""Sharded storage and cross-shard merge networks.

Only `merge.pad_shard_blocks` and `merge.merge_sorted_runs` are ported so
far: delta compaction (`db.delta`) merges index runs through them.  The
sharded table, executor, index, join and server are still to port.
"""
