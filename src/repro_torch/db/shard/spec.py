"""`ShardSpec`: how a sharded table maps logical shards onto devices.

The shard count is a LOGICAL choice (how the rows partition, how many
merge lanes the cross-shard networks get), deliberately decoupled from
the devices: the same 4-shard table runs 4-way on four cards, 2-way on
two, and on one card or the CPU — query answers are identical in every
placement (the shard-invariance contract of tests/test_db_shard.py).

Placement: `launch.mesh.make_shard_mesh` builds the 1-D mesh of devices
(one process; a device may fill several positions) and
`parallel.sharding.shard_leading` splits `[S, ...]` ciphertext stacks
into per-position slabs on their devices.  The fused filter's and the
join grid's Eval launches run per slab on the card that holds it (the
scan through `kernels.ops.shard_eval_values`, the grid as one
`kernels.ops.PairGrid` a slab); without a usable mesh the one slab is
the whole stack on the table's device, with no semantic change.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSpec:
    """S logical shards + an optional 1-D device mesh to place them on."""
    num_shards: int
    mesh: Optional[object] = None       # launch.mesh.ShardMesh with `axis`
    axis: str = "shard"
    # the mesh is the visible cards (devices=None), not a caller's list
    visible: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1: {self.num_shards}")

    @classmethod
    def create(cls, num_shards: int, *, use_mesh: bool = True,
               devices=None, axis: str = "shard") -> "ShardSpec":
        """Spec over the visible cards, or over `devices` (one mesh
        position each, repeats allowed; position 0 must be the device the
        table and its keys live on).  `use_mesh=False` keeps everything
        on the table's device — useful for differential testing of the
        placement itself."""
        mesh = None
        if use_mesh:
            from repro_torch.launch.mesh import make_shard_mesh
            mesh = make_shard_mesh(num_shards, axis=axis, devices=devices)
        return cls(num_shards=num_shards, mesh=mesh, axis=axis,
                   visible=use_mesh and devices is None)

    # -- placement geometry -------------------------------------------------

    @property
    def mesh_devices(self) -> int:
        """Positions on the shard axis (1 when meshless)."""
        return int(self.mesh.shape[self.axis]) if self.mesh is not None else 1

    @property
    def placeable(self) -> bool:
        """Can a [S, ...] stack split evenly over the mesh axis?"""
        return (self.mesh is not None
                and self.num_shards % self.mesh_devices == 0)

    @property
    def shard_map_ok(self) -> bool:
        """Run the Eval launches per slab (needs >1 position AND even
        placement; one position gains nothing)."""
        return self.placeable and self.mesh_devices > 1

    def place(self, tree):
        """Split every [S, ...] tensor leaf's leading dim over the mesh
        (`parallel.sharding.ShardStack` leaves).  A no-op when the spec
        has no usable mesh, so callers never branch."""
        if not self.placeable or self.mesh_devices == 1:
            return tree
        from repro_torch.parallel.sharding import shard_leading
        return shard_leading(self.mesh, tree, self.axis)

    def on(self, device) -> "ShardSpec":
        """The spec a table built on `device` is placed by.  The mesh's
        home (position 0) must be that device.  A mesh of the visible
        cards that does not start there (a table on the CPU of a machine
        with cards) leaves the table where it is: a meshless spec.  An
        explicit mesh that does not start there raises: nothing moves a
        table to another device unasked."""
        dev = torch.device(device)
        if self.mesh is None or self.mesh.home == dev:
            return self
        if self.visible:
            return ShardSpec(self.num_shards, axis=self.axis)
        raise ValueError(
            f"the shard mesh's home is {self.mesh.home}, the table lies on "
            f"{dev}: build the table (and its keys) on the home device, or "
            f"pass devices starting with {dev}")

    def __repr__(self) -> str:
        return (f"ShardSpec(shards={self.num_shards}, "
                f"devices={self.mesh_devices}, axis={self.axis!r})")
