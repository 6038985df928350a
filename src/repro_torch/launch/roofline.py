"""Roofline terms of a dry-run cell, for an H100 cluster.

The port of `repro.launch.roofline`.  Three terms per (arch x shape x
mesh) cell, all in seconds per step for the per-rank program the dry-run
traced (`launch/dryrun.py`):

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = sum over mesh axes of that axis's collective bytes per
                 device / that axis's fabric rate (AXIS_BW: NVLink 4 for
                 `model`, InfiniBand NDR for `data` and `pod`)

plus MODEL_FLOPS = 6*N*D (dense train) / 6*N_active*D (MoE) / 2*N per
token (decode), and the usefulness ratio MODEL_FLOPS / (FLOPs * chips).

The reference parses collective bytes out of XLA's post-SPMD HLO text;
the port has no HLO.  Its collectives are the ones recorded while the
cell was traced: op kind, mesh axis and RESULT bytes of every
all-gather / all-reduce / reduce-scatter / all-to-all / broadcast
(the dominant cost for ring algorithms is ~result bytes on the wire;
all-reduce counted 2x for its reduce-scatter + all-gather phases,
`count_collective`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import (AXIS_BW, HBM_BW, ICI_BW,  # noqa: F401
                                     PEAK_FLOPS_BF16)
from repro_torch.models.config import ModelConfig


def count_collective(by_axis: Dict[str, Dict[str, int]], op: str,
                     axis: str, result_bytes: int) -> None:
    """Add one collective to {axis: {op: bytes}} (all-reduce twice: its
    reduce-scatter and all-gather phases both cross the wire)."""
    b = result_bytes * (2 if op == "all-reduce" else 1)
    ops = by_axis.setdefault(axis, {})
    ops[op] = ops.get(op, 0) + b


def by_op(by_axis: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """{op: bytes} summed over the mesh axes (the reference's schema)."""
    out: Dict[str, int] = {}
    for ops in by_axis.values():
        for op, b in ops.items():
            out[op] = out.get(op, 0) + b
    return out


def collective_seconds(by_axis: Dict[str, Dict[str, int]]) -> float:
    """Each mesh axis's bytes over its fabric's rate, summed."""
    return sum(sum(ops.values()) / AXIS_BW[axis]
               for axis, ops in by_axis.items())


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float          # every op's operand bytes: UNFUSED bound
    coll_bytes_per_dev: float
    coll_by_op: Dict[str, int]
    model_flops_per_dev: float
    mem_floor_bytes: float = 0.0  # analytic fused floor (see memory_floor)
    coll_by_axis: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    compute_s: float = 0.0
    memory_s: float = 0.0         # floor-based (a fused program's traffic)
    memory_upper_s: float = 0.0   # unfused bytes-accessed bound
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops_per_dev / PEAK_FLOPS_BF16
        self.memory_upper_s = self.bytes_per_dev / HBM_BW
        floor = self.mem_floor_bytes or self.bytes_per_dev
        self.memory_s = floor / HBM_BW
        self.collective_s = collective_seconds(self.coll_by_axis)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs -- how much traced compute is
        'useful' (catches remat recompute / masked attention waste)."""
        return (self.model_flops_per_dev / self.flops_per_dev
                if self.flops_per_dev else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak FLOP/s at the roofline step time (MFU bound)."""
        t = self.step_time_s
        return (self.model_flops_per_dev / PEAK_FLOPS_BF16) / t if t else 0.0


def model_flops(cfg: ModelConfig, shape_kind: str, seq: int, gb: int,
                chips: int) -> float:
    """Analytic MODEL_FLOPS per device per step."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        total = 6.0 * n_active * (seq * gb)
    elif shape_kind == "prefill":
        total = 2.0 * n_active * (seq * gb)
    else:  # decode: one token per sequence (+ attention reads not counted)
        total = 2.0 * n_active * gb
    return total / chips


def memory_floor(cfg: ModelConfig, shape_kind: str, seq: int, gb: int,
                 chips: int, data_shards: int) -> float:
    """Analytic per-device HBM-traffic floor (perfect fusion).

    Every op's operand bytes are a gross upper bound.  The floor below is
    what a well-fused program must still move:

      train   : params fwd-read + bwd-read + grad-write + opt m/v rw (f32)
                + one activation write+read per layer boundary
      prefill : params read + activations once + cache write
      decode  : active params read + full cache/state read (per token)
    """
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    p_dev = p_total * 2 / chips                    # bf16, fully sharded
    toks_dev = seq * gb / max(data_shards, 1)
    act_rw = 2 * toks_dev * cfg.d_model * 2 * cfg.num_layers
    if shape_kind == "train":
        opt_rw = p_total * 4 * 4 / chips           # m,v f32 read+write
        grads = p_total * 4 / chips
        return 3 * p_dev + opt_rw + grads + act_rw
    if shape_kind == "prefill":
        kv_dev = _cache_bytes(cfg, seq, gb) / chips
        return p_dev + act_rw + kv_dev
    # decode
    kv_dev = _cache_bytes(cfg, seq, gb) / chips
    return p_active * 2 / chips + kv_dev


def _cache_bytes(cfg: ModelConfig, seq: int, gb: int) -> float:
    if cfg.attention == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.num_kv_heads * cfg.hd
    n_attn = sum(k in ("attn",) for k in cfg.pattern) * cfg.num_groups
    n_local = sum(k == "local" for k in cfg.pattern) * cfg.num_groups
    n_state = sum(k in ("rglru", "mlstm", "slstm")
                  for k in cfg.pattern) * cfg.num_groups
    total = n_attn * gb * seq * per_tok * 2
    total += n_local * gb * min(seq, cfg.window or seq) * per_tok * 2
    total += n_state * gb * 4 * cfg.d_model * 4     # rough state bytes
    return float(total)


def make_terms(cfg: ModelConfig, arch: str, shape: str, mesh_name: str,
               chips: int, shape_kind: str, seq: int, gb: int,
               cost: Dict, coll_by_axis: Dict[str, Dict[str, int]],
               data_shards: int = 32) -> RooflineTerms:
    coll = by_op(coll_by_axis)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=float(cost.get("flops", 0.0)),
        bytes_per_dev=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_dev=float(sum(coll.values())),
        coll_by_op=coll,
        model_flops_per_dev=model_flops(cfg, shape_kind, seq, gb, chips),
        mem_floor_bytes=memory_floor(cfg, shape_kind, seq, gb, chips,
                                     data_shards),
        coll_by_axis=coll_by_axis,
    )
