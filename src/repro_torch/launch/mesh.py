"""Production mesh construction (the dry-run contract), for an H100 cluster.

The port of `repro.launch.mesh`.  A FUNCTION, not a module-level
constant: importing this module touches no process group.  A mesh is a
`DeviceMesh` over the default process group, which is a real one or the
fake one `launch/dryrun.py` sets up.

Geometry: 8-GPU H100 SXM5 nodes, NVLink 4 inside a node, InfiniBand NDR
between nodes.  256 GPUs = (data=32, model=8); 512 = (pod=2, data=32,
model=8).  The model axis stays at 8: tensor-parallel all-reduces run on
it every layer, and they must stay inside one NVLink node (a model axis
of 16 would cross InfiniBand).  `pod` composes with `data` for the batch;
weights are never sharded across pods.

`make_shard_mesh` is the other kind: the 1-D, one-process mesh of
devices a sharded table's shards are placed on (`db.shard.ShardSpec`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


def _device_type() -> str:
    """The mesh's device type: the default group's backend decides (NCCL
    on the card; gloo, and the dry-run's fake group, on the host)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def _mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(),
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    import torch.distributed as dist
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, the default process group "
            f"has {have} -- launch/dryrun.py sets up a fake group of "
            f"{need}")
    return _mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """Small mesh over the ranks of the default process group (tests,
    training on one host): on one card, (1, 1)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    dp = n // model_parallel
    return _mesh((dp, model_parallel), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The 1-D mesh of a sharded table, in one process: an ordered tuple
    of devices, one per mesh position, and the axis name.  Not a
    `DeviceMesh` (that needs a rank per device; the database runs in one
    process).  A device may fill several positions.  Position 0 is the
    HOME device: the `KeySet`'s, where tables are built and answers
    land."""
    devices: Tuple[torch.device, ...]
    axis: str = "shard"

    @property
    def shape(self) -> Dict[str, int]:
        """Positions on the axis, as the reference's `mesh.shape`."""
        return {self.axis: len(self.devices)}

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices in position order, each once."""
        return tuple(dict.fromkeys(self.devices))


def make_shard_mesh(num_shards: int, *, axis: str = "shard",
                    devices: Optional[Sequence] = None) -> ShardMesh:
    """1-D mesh for `repro_torch.db.shard` tables.

    The shard count is LOGICAL (chosen by the table's `ShardSpec`); this
    picks d = the largest divisor of `num_shards` the positions can
    supply, so a `[num_shards, ...]` stack always places evenly.
    `devices=None` means the visible cards (the CPU when there are none);
    an explicit list may repeat a device, each entry one position (the
    counterpart of the reference's forced host device count)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(n)]
                   or [torch.device("cpu")])
    devices = [_position(d) for d in devices]
    if not devices:
        raise ValueError("a shard mesh needs at least one device")
    d = 1
    for cand in range(min(num_shards, len(devices)), 0, -1):
        if num_shards % cand == 0:
            d = cand
            break
    return ShardMesh(tuple(devices[:d]), axis)


def _position(device) -> torch.device:
    """A mesh position's device, with its index (`cuda` alone is the
    current card, where a tensor placed on `cuda` would go)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# H100 SXM5 per-GPU peaks (roofline constants), from the NVIDIA H100
# Tensor Core GPU datasheet (SXM5 column)
PEAK_FLOPS_BF16 = 989.4e12     # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s a direction, NVLink 4 (900 GB/s both)
IB_BW = 50e9                   # B/s a GPU, one InfiniBand NDR 400 Gb/s port
HBM_BYTES = 80e9               # B of HBM per card
INT8_TC_OPS_PER_S = 1979e12    # op/s, dense int8 tensor cores
# 32 x 32 -> 64-bit integer multiply-adds: 132 SMs x 64 INT32 lanes x the
# 1,980 MHz maximum SM clock (H100 architecture whitepaper)
INT32_MACS_PER_S = 132 * 64 * 1.98e9
# which fabric carries each mesh axis's collectives
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}
# the reference's one interconnect rate: here the slowest fabric a
# collective crosses (the roofline sums per axis over AXIS_BW instead)
ICI_BW = IB_BW
