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
"""
from __future__ import annotations

import math

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
