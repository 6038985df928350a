"""Dry-run for an H100 cluster: trace every (arch x shape x mesh) cell's
per-rank program.

The port of `repro.launch.dryrun`.  The reference compiles each cell with
XLA for 512 fake host devices and reads memory, FLOPs, bytes and
collectives from the compiled program.  Here each LM cell runs on rank 0
of a fake process group of 512 ranks (`FakeStore`, backend "fake"),
under `FakeTensorMode`, so nothing is allocated and no byte moves: the
parameters, the batch, the optimizer state and the caches are DTensors
placed by the sharding rules on a (32, 8) or (2, 32, 8) `DeviceMesh`, and
the step (train_step, prefill or decode_step) runs eagerly on them.  A
dispatch mode below DTensor sees the rank's own ops and records:

  * FLOPs per device: each local op's count from the formulas of
    `torch.utils.flop_counter` (FlopCounterMode itself, above DTensor,
    would count the global shapes);
  * bytes accessed: every local op's input and output bytes (views
    excluded), an unfused upper bound, as XLA's "bytes accessed";
  * collectives: op kind, mesh axis and result bytes (`roofline.
    count_collective`);
  * the peak of live bytes per device (`MemTracker`).

Every layer is traced (an eager trace counts each one), so the
reference's depth-1/depth-2 extrapolation has no counterpart.  The
sLSTM's recurrence is the exception: traced step by step at 32,768 steps
it would cost more than the rest of the cell, so the trace runs
`SLSTM_TRACE_STEPS` of its steps and `_slstm_correction` adds the other
steps' matmul FLOPs, the reference's remedy.  These figures are
ESTIMATES for an H100 cluster from a traced program, not measurements.

The paper's own cell, hades-cmp, is row-local: each device compares its
batch rows, with no collective.  Its terms are analytic; with
`--execute`, on a card, `run_hades_cell` also runs the per-device
program once for real (`core.compare.compare` over b_dev lanes, through
the gadget Eval kernel) and records its wall, peak memory and launches.

The dry-run replaces the default process group, so run it in a process
of its own:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
      [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hades-cmp \\
      --shape cmp_1m --execute        # on a card
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, cell_supported, input_specs
from repro_torch.models import serve as SV
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.constrain import P, _Regather, use_mesh
from repro_torch.train import train_lib as TL
from repro_torch.train.optimizer import AdamState

PyTree = Any

# the fake process group's size: both production meshes fit in it
WORLD = 512
# sLSTM recurrence steps traced per sequence (see the module docstring)
SLSTM_TRACE_STEPS = 1

# sanitize-move toggle: conservative (drop-to-replicated) by default, as
# the reference measured better; run_cell retries WITH moves if the
# conservative layout fails.
_ALLOW_MOVE = {"v": False}


def mesh_name(multi_pod: bool) -> str:
    return "2x32x8" if multi_pod else "32x8"


def fake_world(world: int = WORLD) -> None:
    """Make the default process group a fake one of `world` ranks, this
    process rank 0 (replacing any other)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


_TRACE_MESHES: Dict[Any, Any] = {}
_FAKE = None


def _production_mesh(multi_pod: bool):
    """One DeviceMesh per layout and process: DTensor caches sharding
    decisions by the mesh's value, and its collectives then run on the
    groups of the first mesh of that layout."""
    if multi_pod not in _TRACE_MESHES:
        _TRACE_MESHES[multi_pod] = make_production_mesh(
            multi_pod=multi_pod)
    return _TRACE_MESHES[multi_pod]


def _dp_mesh(chips: int):
    """A 1-D mesh ("data",) over `chips` ranks: pure data parallelism."""
    from repro_torch.launch.mesh import _mesh
    key = ("dp", chips)
    if key not in _TRACE_MESHES:
        _TRACE_MESHES[key] = _mesh((chips,), ("data",))
    return _TRACE_MESHES[key]


def trace_plan(cfg: ModelConfig, shape: str, multi_pod: bool) -> Dict:
    """The mesh a cell's rank-0 program is traced on, and at what global
    batch.  A batch split over several mesh axes would be a dimension
    DTensor shards twice, whose merges it represents in strides that its
    propagation cannot always take under a fake mode; so:
      * the small-model layout (params replicated, the batch over its
        batch axes) is pure DP: a 1-D mesh over the batch axes' ranks
        (on two pods, where the batch spans data x model, each pod runs
        the same program: the pods hold replicas);
      * the two-pod FSDP/TP layout (batch over pod and data, weights
        never sharded over pod) runs, on each rank, the one-pod program
        on its pod's half of the batch; the pods' one collective, the
        gradients' all-reduce over `pod` (train), is added from the
        gradient shards' bytes (`pod_allreduce`).  A batch that pod x
        data does not divide is not split at all (the rules drop the
        axes), so each rank runs the one-pod program on all of it.
    `layout` is (the batch axes to set, replicate params)."""
    meta = SHAPES[shape]
    prod = _production_mesh(multi_pod)
    axes, replicate = SH.choose_layout(prod, cfg.param_count(),
                                       meta["global_batch"])
    if replicate:
        sizes = dict(zip(prod.mesh_dim_names, prod.shape))
        return {"mesh": _dp_mesh(math.prod(sizes[a] for a in axes)),
                "layout": (("data",), True),
                "global_batch": meta["global_batch"], "pod_allreduce": False}
    if multi_pod:
        sizes = dict(zip(prod.mesh_dim_names, prod.shape))
        split = meta["global_batch"] % (sizes["pod"] * sizes["data"]) == 0
        return {"mesh": _production_mesh(False),
                "layout": (("data",) if split else (), False),
                "global_batch": meta["global_batch"] // (2 if split else 1),
                "pod_allreduce": meta["kind"] == "train" and split}
    return {"mesh": prod, "layout": (axes, False),
            "global_batch": meta["global_batch"], "pod_allreduce": False}


def build_cell(cfg: ModelConfig, shape: str, mesh,
               tcfg: Optional[TL.TrainConfig] = None, *, layout=None,
               global_batch: Optional[int] = None):
    """-> (step_fn, args_specs, in_shardings, out_shardings), the
    shardings as P trees (sanitized for the inputs).

    Chooses the cell's layout first (or takes `layout`, (batch axes,
    replicate params), from `trace_plan`): small models replicate params
    and spread the batch over ALL axes (pure DP) -- callers must trace
    while this layout is set."""
    from repro_torch.parallel.constrain import set_batch_axes
    meta = SHAPES[shape]
    axes, replicate = layout or SH.choose_layout(
        mesh, cfg.param_count(), meta["global_batch"])
    set_batch_axes(axes if replicate or layout else None)
    param_specs_fn = (SH.replicated_param_specs if replicate
                      else SH.param_specs)

    spec = input_specs(cfg, shape, tcfg, global_batch=global_batch)
    kind = spec["kind"]
    args = spec["args"]

    def named(sp, shapes):
        return SH.sanitize_specs(mesh, sp, shapes,
                                 allow_move=_ALLOW_MOVE["v"])

    b = SH.batch_axes(mesh)
    if kind == "train":
        tcfg = tcfg or TL.TrainConfig()
        state_specs, batch_specs = args
        p_spec = param_specs_fn(state_specs.params)
        st_spec = TL.TrainState(
            params=p_spec, opt=AdamState(step=P(), mu=p_spec, nu=p_spec),
            compressor=None)
        st_sh = named(st_spec, state_specs)
        in_sh = (st_sh, named(SH.data_specs(mesh, batch_specs), batch_specs))
        out_sh = (st_sh, {"loss": P(), "lr": P(), "grad_norm": P()})
        fn = TL.make_train_step(cfg, tcfg)
    elif kind == "prefill":
        params_specs, batch_specs = args
        in_sh = (named(param_specs_fn(params_specs), params_specs),
                 named(SH.data_specs(mesh, batch_specs), batch_specs))
        out_sh = (P(b, "model"), None)
        fn = lambda params, batch: SV.prefill(cfg, params, batch)
    else:  # decode
        params_specs, cache_specs_, token_spec = args
        cache_sh = named(SH.cache_specs(mesh, cache_specs_), cache_specs_)
        in_sh = (named(param_specs_fn(params_specs), params_specs),
                 cache_sh, named(P(b), token_spec))
        out_sh = (P(b, "model"), cache_sh)
        fn = lambda params, cache, token: SV.decode_step(
            cfg, params, cache, token)
    return fn, args, in_sh, out_sh


def _slstm_correction(cfg: ModelConfig, shape: str, mesh) -> float:
    """The sLSTM's hidden-to-hidden recurrence runs SLSTM_TRACE_STEPS of
    its S steps in the trace; add the other steps' matmul FLOPs
    analytically (the reference's formula, for S - 1 untraced steps)."""
    n_slstm = sum(k == "slstm" for k in cfg.pattern) * cfg.num_groups
    if not n_slstm:
        return 0.0
    meta = SHAPES[shape]
    S = meta["seq_len"] if meta["kind"] != "decode" else 1
    if S <= SLSTM_TRACE_STEPS:
        return 0.0
    gb = meta["global_batch"]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    chips_batch = sizes.get("data", 1) * sizes.get("pod", 1)
    b_dev = max(1, gb // chips_batch)
    w = cfg.d_model
    hd = w // cfg.num_heads
    per_step = b_dev * cfg.num_heads * hd * 4 * hd * 2
    mult = 3.0 if meta["kind"] == "train" else 1.0
    return n_slstm * (S - SLSTM_TRACE_STEPS) * per_step * mult


@contextlib.contextmanager
def _slstm_steps_traced():
    """Run each sLSTM recurrence over its first SLSTM_TRACE_STEPS steps
    and hold the last hidden for the remaining ones (shapes unchanged)."""
    scan = X.slstm_scan

    def cut(params, cfg, x, state=None):
        S = x.shape[1]
        if S <= SLSTM_TRACE_STEPS:
            return scan(params, cfg, x, state)
        h, st = scan(params, cfg, x[:, :SLSTM_TRACE_STEPS], state)
        pad = h[:, -1:].expand(h.shape[0], S - SLSTM_TRACE_STEPS,
                               h.shape[2])
        return torch.cat([h, pad], dim=1), st
    X.slstm_scan = cut
    try:
        yield
    finally:
        X.slstm_scan = scan


def _auto_microbatches(cfg: ModelConfig, shape: str, mesh) -> int:
    """Grad-accumulation factor so the residual (x carried per group,
    bf16) stays under ~2 GiB/device.  Respects the cell's chosen layout
    (small models spread batch over model too, so their per-device batch
    is already tiny)."""
    meta = SHAPES[shape]
    if meta["kind"] != "train":
        return 1
    axes, _ = SH.choose_layout(mesh, cfg.param_count(),
                               meta["global_batch"])
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    chips_batch = math.prod(sizes[a] for a in axes)
    b_dev = max(1, meta["global_batch"] // chips_batch)
    carry = cfg.num_groups * b_dev * meta["seq_len"] * cfg.d_model * 2
    budget = 2 * 2**30
    mb = 1
    while carry / mb > budget and mb < b_dev:
        mb *= 2
    return min(mb, b_dev)


# ---------------------------------------------------------------------------
# the trace: what one rank's program computes, moves and holds
# ---------------------------------------------------------------------------

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Propagation:
    """While a cell is traced, marks the ops DTensor runs on
    global-shaped fake tensors to derive an op's output metadata (its
    `ShardingPropagator`'s tensor-meta propagation).  Under an active fake
    mode DTensor runs them in that mode, so the mode alone cannot tell
    them from the rank's own ops."""

    depth = 0


@contextlib.contextmanager
def _marking_propagation():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if hasattr(ShardingPropagator, n)]
    if not names:
        raise RuntimeError("this torch's ShardingPropagator has no "
                           "tensor-meta propagation to mark")
    saved = {n: getattr(ShardingPropagator, n) for n in names}

    def marked(fn):
        def run(*args, **kwargs):
            _Propagation.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _Propagation.depth -= 1
        return run
    for n, fn in saved.items():
        setattr(ShardingPropagator, n, marked(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _rank_mem_tracker():
    """A MemTracker that leaves DTensor's propagation ops out."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class RankMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _Propagation.depth:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return RankMemTracker()


class _CellProbe(TorchDispatchMode):
    """A dispatch mode below DTensor (it lets DTensor desugar first):
    FLOPs, bytes accessed and collectives of the rank's local ops.  Ops
    of DTensor's own sharding propagation are not the rank's work and
    are skipped."""

    def __init__(self, mesh):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, Dict[str, int]] = {}
        self.group_axis = {mesh.get_group(i).group_name: name
                           for i, name in enumerate(mesh.mesh_dim_names)}
        self.group_axis.update({mesh.get_group(i).group_name: name
                                for mesh in _TRACE_MESHES.values()
                                for i, name in
                                enumerate(mesh.mesh_dim_names)})
        self._entry_fake = None

    def __enter__(self):
        self._entry_fake = detect_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagation.depth or detect_fake_mode() is not self._entry_fake:
            return out
        if func.namespace == "_c10d_functional":
            base = func._opname.replace("_coalesced", "")
            if base in _COLLECTIVES:
                group = [a for a in list(args) + list(kwargs.values())
                         if isinstance(a, str)][-1]
                RL.count_collective(
                    self.coll, _COLLECTIVES[base],
                    self.group_axis.get(group, group),
                    sum(_nbytes(t) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)))
            return out
        if func.is_view:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        seen = set()
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.bytes += _nbytes(t)
        return out


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


@contextlib.contextmanager
def _microbatch_marks(probe, marks: list):
    """Append the probe's counts at the start of every microbatch's
    value_and_grad and at the optimizer update."""
    from repro_torch.train import optimizer as OPT
    vag, upd = TL.value_and_grad, OPT.apply_updates

    def mark():
        marks.append((probe.flops, probe.bytes,
                      {a: dict(o) for a, o in probe.coll.items()}))

    def vag_marked(*a, **k):
        mark()
        return vag(*a, **k)

    def upd_marked(*a, **k):
        mark()
        return upd(*a, **k)
    TL.value_and_grad, OPT.apply_updates = vag_marked, upd_marked
    try:
        yield
    finally:
        TL.value_and_grad, OPT.apply_updates = vag, upd


def _trace(fn, args, in_sh, out_sh, mesh, extra_microbatches: int = 0
           ) -> Dict:
    """Run fn on the placed args (inside the caller's fake mode) under the
    probe and the memory tracker; the outputs are placed as out_sh.

    A train step traced with 2 microbatches stands for one with
    2 + `extra_microbatches`: every microbatch is the same program on
    other rows, and the second already holds the gradient accumulators,
    so the loop's peak is the traced one and each extra microbatch adds
    the second's counts (its value_and_grad and accumulation)."""
    placed = SH.distribute(mesh, args, in_sh)
    arg_locals = _local_leaves(placed)
    mt = _rank_mem_tracker()
    mt.track_external(*arg_locals)
    probe = _CellProbe(mesh)
    marks: list = []
    with _marking_propagation(), use_mesh(mesh), mt, probe, \
            _microbatch_marks(probe, marks):
        out = fn(*placed)
        out = SH.distribute(mesh, out, out_sh)
    if extra_microbatches:
        (f1, b1, c1), (f2, b2, c2) = marks[1], marks[2]
        probe.flops += extra_microbatches * (f2 - f1)
        probe.bytes += extra_microbatches * (b2 - b1)
        for axis, ops in c2.items():
            for op, nb in ops.items():
                unit = nb - c1.get(axis, {}).get(op, 0)
                probe.coll.setdefault(axis, {})
                probe.coll[axis][op] = (probe.coll[axis].get(op, 0)
                                        + extra_microbatches * unit)
    peak = max(snap["Total"] for snap in
               mt.get_tracker_snapshot("peak").values())
    params = placed[0].params if hasattr(placed[0], "params") else placed[0]
    arg_bytes = sum(_nbytes(t) for t in arg_locals)
    out_bytes = sum(_nbytes(t) for t in _local_leaves(out))
    return {"flops": float(probe.flops),
            "bytes accessed": float(probe.bytes),
            "collectives": probe.coll,
            "param_bytes": sum(_nbytes(t) for t in _local_leaves(params)),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": max(0, peak - arg_bytes),
                       "alias_bytes": 0, "peak_bytes": peak,
                       "peak_per_device_gib": round(peak / 2**30, 3)}}


# ---------------------------------------------------------------------------
# the paper's own workload as a dry-run cell: batched HADES comparisons
# sharded over the mesh on the batch axis (each ciphertext's ring stays
# on its card)
# ---------------------------------------------------------------------------

HADES_SHAPES = {"cmp_64k": 65536, "cmp_256k": 262144, "cmp_1m": 1048576,
                # int32 at-rest ciphertexts (residues are < 2^31; widened
                # to int64 for the kernel) -- halves the stored bytes
                "cmp_256k_c32": 262144}


def _hades_lanes(params, b: int, compact: bool, gen) -> list:
    """Four [b, K, n] uniform residue stacks (a0, a1, b0, b1)."""
    from repro_torch.core.sampling import uniform_poly
    out = [uniform_poly(params, gen, (b,)) for _ in range(4)]
    return [t.to(torch.int32) for t in out] if compact else out


def _hades_program(ks, lanes, compact: bool) -> torch.Tensor:
    """The per-device program: compare over the device's lanes."""
    from repro_torch.core import compare as HC
    from repro_torch.core.encrypt import Ciphertext
    if compact:
        lanes = [t.to(torch.int64) for t in lanes]
    a0, a1, b0, b1 = lanes
    return HC.compare(ks, Ciphertext(a0, a1), Ciphertext(b0, b1))


def run_hades_cell(shape: str, multi_pod: bool, execute: bool = False,
                   ks=None, seed: int = 0) -> Dict:
    """The hades-cmp cell: analytic terms per device; with `execute`, the
    per-device program run once on the card (keys: `ks`, else a
    paper-bfv gadget keygen from `seed`)."""
    from repro_torch.core.params import make_params
    from repro_torch.parallel.constrain import AbstractMesh

    name = mesh_name(multi_pod)
    mesh = (AbstractMesh(M.MULTI_POD_SHAPE, ("pod", "data", "model"))
            if multi_pod else
            AbstractMesh(M.PRODUCTION_SHAPE, ("data", "model")))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    chips = mesh.size()
    params = make_params("paper-bfv", mode="gadget")
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    E = K * D
    B = HADES_SHAPES[shape]
    compact = shape.endswith("_c32")
    b_dev = B // (sizes.get("pod", 1) * sizes["data"])
    t0 = time.time()
    # "useful" op count: (E fwd NTTs + 1 inv NTT) x K towers of
    # (n/2 log n) butterflies (~2 int-ops each) + E*K*n pointwise MACs,
    # per comparison, per device (the reference's)
    log_n = n.bit_length() - 1
    useful = b_dev * K * ((E + 1) * (n // 2) * log_n * 2 + E * n * 2)
    # the gadget Eval kernel's work: the byte-split digit products on the
    # int8 tensor cores (D rounded up to whole 4-byte words, 8 byte
    # columns, 2 ops a multiply-add), the lanes' subtraction mod q and
    # digit split (2 + D int32 ops a coefficient) on the INT32 lanes
    words = -(-D // 4)
    d4 = 4 * (1 << (words - 1).bit_length())
    tc_ops = b_dev * K * n * d4 * 8 * 2
    int_ops = b_dev * K * n * (2 + D)
    flops = float(tc_ops + int_ops)
    # fused-kernel HBM floor: 4 ct components in + CEK + residues out
    ct_bytes = 4 if compact else 8
    floor = b_dev * 4 * K * n * ct_bytes + E * K * n * 8 + b_dev * K * 8
    # what the port's path moves: the widening (int32 read, int64
    # written, read again) where the lanes are compact, then the kernel
    widen = b_dev * 4 * K * n * (4 + 8) if compact else 0
    upper = (widen + b_dev * 4 * K * n * 8 + E * K * n * 8
             + b_dev * K * 8)
    terms = {
        "compute_s": tc_ops / M.INT8_TC_OPS_PER_S
        + int_ops / M.INT32_MACS_PER_S,
        "memory_s": floor / chips_hbm(),
        "memory_upper_s": upper / chips_hbm(),
        "collective_s": 0.0,
    }
    dominant = max(
        {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        key=lambda k: terms[k]).replace("_s", "")
    step = max(terms.values())
    arg_bytes = b_dev * 4 * K * n * ct_bytes + E * K * n * 8
    temp_bytes = (b_dev * 4 * K * n * 8 if compact else 0) + b_dev * K * 8
    out_bytes = b_dev * 4
    rec = {
        "arch": "hades-cmp", "shape": shape, "mesh": name,
        "status": "ok", "chips": chips, "microbatches": 1,
        "b_dev": b_dev, "cost_compile_s": 0.0,
        "memfit_compile_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": temp_bytes, "alias_bytes": 0,
            "peak_bytes": arg_bytes + temp_bytes,
            "peak_per_device_gib": round((arg_bytes + temp_bytes)
                                         / 2**30, 3),
        },
        "cost": {"flops": flops, "bytes_accessed": float(upper)},
        "collectives": {},
        "collectives_by_axis": {},
        "roofline": {
            **terms,
            "dominant": dominant,
            "model_flops_per_dev": useful,
            "useful_ratio": round(useful / max(flops, 1.0), 4),
            "roofline_fraction": round(
                (flops / M.INT32_MACS_PER_S) / step, 6),
            "step_time_s": step,
        },
        "estimate": "analytic (row-local: no collective)",
    }
    if execute:
        rec["execute"] = _execute_hades(params, b_dev, compact, ks, seed)
    return rec


def _execute_hades(params, b_dev: int, compact: bool, ks, seed: int
                   ) -> Dict:
    """The per-device program once on the card: wall, peak memory and
    the gadget Eval's launches."""
    from repro_torch.core.keys import keygen
    from repro_torch.core.sampling import make_generator
    from repro_torch.kernels import _build
    if ks is None:
        if not torch.cuda.is_available():
            raise RuntimeError("--execute runs the per-device program on a "
                               "CUDA device; none is available")
        ks = keygen(params, seed, device=torch.device("cuda", 0))
    dev = ks.device
    gen = make_generator(seed + 1, dev)
    # warm-up: the kernel library and the key's byte form, on 16 lanes
    _hades_program(ks, _hades_lanes(params, 16, compact, gen), compact)
    torch.cuda.synchronize()
    lanes = _hades_lanes(params, b_dev, compact, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _build.LAUNCHES["eval_coeff0_gadget"]
    t0 = time.perf_counter()
    out = _hades_program(ks, lanes, compact)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _build.LAUNCHES["eval_coeff0_gadget"] - before
    ok = (tuple(out.shape) == (b_dev,)
          and bool(((out >= -1) & (out <= 1)).all()))
    return {"lanes": b_dev, "wall_s": wall, "peak_mem_bytes": peak,
            "peak_above_start_bytes": peak - base,
            "launches": {"eval_coeff0_gadget": launches},
            "device": torch.cuda.get_device_name(0), "output_ok": ok}


def chips_hbm() -> float:
    return M.HBM_BW


def _fake_mode():
    """The process's one FakeTensorMode (DTensor caches tensors made under
    it, which another mode would not take)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    global _FAKE
    if _FAKE is None:
        _FAKE = FakeTensorMode()
    return _FAKE


def run_cell(arch: str, shape: str, multi_pod: bool,
             execute: bool = False) -> Dict:
    """One cell's record (an LM cell sets up the fake process group,
    `fake_world`)."""
    if arch == "hades-cmp":
        return run_hades_cell(shape, multi_pod, execute=execute)
    from repro_torch.parallel.constrain import set_batch_axes
    cfg = configs.get_config(arch)
    ok, why = cell_supported(cfg, shape)
    name = mesh_name(multi_pod)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": name,
                "status": "skip", "reason": why}
    meta = SHAPES[shape]
    fake_world()
    mesh = _production_mesh(multi_pod)
    chips = mesh.size()
    plan = trace_plan(cfg, shape, multi_pod)
    regathers0 = _Regather.regathers
    t0 = time.time()
    try:
        for attempt in range(2):
            try:
                mb = _auto_microbatches(cfg, shape, mesh)
                traced_mb = min(mb, 2)
                tcfg = TL.TrainConfig(microbatches=traced_mb)
                with _fake_mode(), _slstm_steps_traced():
                    fn, args, in_sh, out_sh = build_cell(
                        cfg, shape, plan["mesh"], tcfg,
                        layout=plan["layout"],
                        global_batch=plan["global_batch"] * traced_mb // mb)
                    cost = _trace(fn, args, in_sh, out_sh, plan["mesh"],
                                  extra_microbatches=mb - traced_mb)
                break
            except Exception:
                if attempt == 1:
                    raise
                # retry with sanitize-moves enabled
                _ALLOW_MOVE["v"] = True
    finally:
        set_batch_axes(None)
        _ALLOW_MOVE["v"] = False
    t_trace = time.time() - t0
    regathers = _Regather.regathers - regathers0
    if plan["pod_allreduce"]:
        RL.count_collective(cost["collectives"], "all-reduce", "pod",
                            cost["param_bytes"])
    cost["flops"] += _slstm_correction(cfg, shape, mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    terms = RL.make_terms(cfg, arch, shape, name, chips, meta["kind"],
                          meta["seq_len"], meta["global_batch"], cost,
                          cost["collectives"], data_shards=data_shards)
    return {
        "arch": arch, "shape": shape, "mesh": name, "status": "ok",
        "chips": chips,
        "microbatches": mb,
        "microbatches_traced": traced_mb,
        "cost_compile_s": 0.0,
        "memfit_compile_s": round(t_trace, 2),
        "memory": cost["memory"],
        "cost": {"flops": float(cost["flops"]),
                 "bytes_accessed": float(cost["bytes accessed"])},
        "collectives": terms.coll_by_op,
        "collectives_by_axis": cost["collectives"],
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "memory_upper_s": terms.memory_upper_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops_per_dev": terms.model_flops_per_dev,
            "useful_ratio": round(terms.useful_ratio, 4),
            "roofline_fraction": round(terms.roofline_fraction, 6),
            "step_time_s": terms.step_time_s,
        },
        "estimate": "traced per-rank program (FakeTensorMode, fake "
                    f"process group of {WORLD})",
        "trace_mesh": dict(zip(plan["mesh"].mesh_dim_names,
                               plan["mesh"].shape)),
        "regathers": regathers,
    }


def all_cells():
    for arch in configs.ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + list(HADES_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--execute", action="store_true",
                    help="hades-cmp: run the per-device program on the card")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{configs.canon(arch)}_{shape}_{mesh_name(mp)}"
            try:
                rec = run_cell(arch, shape, mp, execute=args.execute)
            except Exception as e:  # a failing cell is a bug in the system
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                       "status": "error", "error": repr(e),
                       "trace": traceback.format_exc()[-2000:]}
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"[ok]   {tag:55s} mem/dev="
                      f"{rec['memory']['peak_per_device_gib']:7.2f}GiB "
                      f"compute={r['compute_s']:.3e}s "
                      f"memory={r['memory_s']:.3e}s "
                      f"coll={r['collective_s']:.3e}s dom={r['dominant']} "
                      f"trace={rec['memfit_compile_s']}s", flush=True)
            elif rec["status"] == "skip":
                print(f"[skip] {tag:55s} {rec['reason'][:60]}", flush=True)
            else:
                print(f"[FAIL] {tag:55s} {rec['error'][:120]}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
