"""`ShardSpec`: how many logical shards a sharded table has.

The shard count is a LOGICAL choice (how the rows partition, how many
merge lanes the cross-shard networks get), deliberately decoupled from
the devices: query answers are the same for every shard count and every
placement.  The port places every shard on one card: `mesh_devices` is
1 and `shard_map_ok` is False, so each sharded stage runs its launches
on that card (the reference's meshless branch).  Placing shards on
several cards is not ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSpec:
    """S logical shards on one device."""
    num_shards: int
    axis: str = "shard"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1: {self.num_shards}")

    @classmethod
    def create(cls, num_shards: int, *, axis: str = "shard") -> "ShardSpec":
        """Spec over the one device the tables live on."""
        return cls(num_shards=num_shards, axis=axis)

    # -- placement geometry -------------------------------------------------

    @property
    def mesh_devices(self) -> int:
        """Devices on the shard axis: 1."""
        return 1

    @property
    def shard_map_ok(self) -> bool:
        """Whether launches split across devices: never, on one device."""
        return False

    def __repr__(self) -> str:
        return (f"ShardSpec(shards={self.num_shards}, "
                f"devices={self.mesh_devices}, axis={self.axis!r})")
