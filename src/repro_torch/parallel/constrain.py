"""Activation sharding anchors (MaxText-style), on a torch DeviceMesh.

The port of `repro.parallel.constrain`.  A tensor spread over several
cards is a `DTensor` on a `DeviceMesh`; left to its own devices, DTensor's
sharding propagation picks each op's layout by the cost of its
redistribution, which can resolve the FSDP weight sharding against
batch-sharded activations by gathering the batch.  Pinning the activation
layout at block boundaries keeps the intended one: gather weights, keep
activations batch-sharded.

The ambient mesh is a context the caller sets (`with use_mesh(mesh):`),
playing the part of the reference's `thread_resources`.  `shard(x,
*dims)` returns `x` itself outside a mesh, on a one-rank mesh, and for a
tensor that is not a `DTensor`, so model code runs unchanged on one card.
"batch" expands to ("pod", "data") on multi-pod meshes.

A spec `P` is a tuple with one entry per tensor dimension: a mesh-axis
name, a tuple of names (the dimension split over several axes, major
first), or None.  A dimension split over two mesh axes, as ("pod",
"data"), maps to `Shard(d)` on both mesh dimensions: DTensor splits it
over the mesh dimensions in mesh order, which is the reference's
major-to-minor order as long as the tuple lists the axes in mesh order
(`placements` checks that).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional


class P(tuple):
    """PartitionSpec: one entry per dimension (axis name, tuple of names,
    or None).  As `jax.sharding.PartitionSpec`, a one-name tuple reads as
    the name and an empty tuple as None, so specs compare equal to the
    reference's read as tuples."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes without devices (the counterpart of
    `jax.sharding.AbstractMesh`): what the spec rules read of a mesh."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)

    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or AbstractMesh)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# the ambient meshes, innermost last (process-wide, not per thread: the
# autograd engine recomputes checkpointed layers on its own threads)
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the ambient mesh of `shard` (and of the MoE's expert
    parallel path) inside the block.  On a mesh of several ranks, ops on
    DTensors also go through `_Regather`, and a plain tensor meeting a
    DTensor (a position range, a mask) counts as replicated."""
    _MESHES.append(mesh)
    try:
        if mesh is not None and mesh.size() > 1:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication(), _Regather():
                yield mesh
        else:
            yield mesh
    finally:
        _MESHES.pop()


@contextlib.contextmanager
def mesh_modes():
    """`use_mesh`'s op modes again where they are missing: a torch
    function mode is off while its handler runs, so a checkpointed
    layer recomputed inside `torch.autograd.grad` runs without them."""
    import torch
    if not on_mesh() or any(
            getattr(m, "regather", False)
            for m in torch.overrides._get_current_function_mode_stack()):
        yield
        return
    with _Regather():
        yield


def _strided(tree) -> bool:
    """A DTensor in `tree` split in strides (a merge of two sharded or an
    unevenly sharded dimension), which later ops often cannot take."""
    from torch.utils._pytree import tree_leaves
    return any(type(p).__name__ == "_StridedShard"
               for t in tree_leaves(tree)
               for p in getattr(t, "placements", ()))


# elementwise functions DTensor has no sharding strategy for: run on each
# rank's shard (`_pointwise_local`)
_LOCAL_POINTWISE = frozenset({"log_sigmoid", "logsigmoid"})


def _pointwise_local(func, x, *args, **kwargs):
    """An elementwise `func` of DTensor x on each rank's shard (a partial
    sum is reduced first: the function is not linear)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if isinstance(p, Partial) else p
          for p in x.placements]
    return local_map(lambda t: func(t, *args, **kwargs),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


class _Regather:
    """A DTensor op whose sharding DTensor cannot propagate on its
    operands' layouts (a view splitting or merging a sharded dimension
    unevenly, e.g. 15 heads x 64 sharded 8 ways; an op without a
    strategy for them) is run again with the operands' non-leading
    dimensions gathered (then, failing that, every dimension), as GSPMD
    reshards around such an op; so is a view whose result would come out
    split in strides.  In-place ops and autograd are not retried; an
    elementwise function DTensor has no strategy for runs on each shard
    (`_LOCAL_POINTWISE`).  `regathers` counts the retries."""

    regathers = 0

    def __new__(cls):
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._pytree import tree_leaves, tree_map

        def gathered(x, keep_leading: bool):
            from torch.distributed.tensor import DTensor, Replicate, Shard
            if not isinstance(x, DTensor):
                return x
            pl = tuple(p if isinstance(p, Shard) and p.dim == 0
                       and keep_leading else Replicate()
                       for p in x.placements)
            return x.redistribute(x.device_mesh, pl)

        autograd = frozenset({torch.autograd.grad, torch.Tensor.backward,
                              torch.autograd.backward})
        views = frozenset({torch.Tensor.reshape, torch.Tensor.view,
                           torch.reshape, torch.Tensor.flatten,
                           torch.flatten, torch.Tensor.unflatten})

        class Mode(TorchFunctionMode):
            regather = True

            def __torch_function__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                if func in autograd or not any(
                        hasattr(t, "placements")
                        for t in tree_leaves((args, kwargs))):
                    return func(*args, **kwargs)
                try:
                    out = func(*args, **kwargs)
                    if func not in views or not _strided(out):
                        return out
                except (RuntimeError, NotImplementedError):
                    name = getattr(func, "__name__", "")
                    if name in _LOCAL_POINTWISE:
                        return _pointwise_local(func, args[0], *args[1:],
                                                **kwargs)
                    if name.endswith("_"):
                        raise
                for keep_leading in (True, False):
                    a2, k2 = tree_map(
                        lambda x: gathered(x, keep_leading), (args, kwargs))
                    try:
                        out = func(*a2, **k2)
                        if _strided(out) and keep_leading:
                            continue
                    except (RuntimeError, NotImplementedError):
                        if not keep_leading:
                            raise
                        continue
                    _Regather.regathers += 1
                    return out
        return Mode()


def _ambient_mesh():
    return _MESHES[-1] if _MESHES else None


def on_mesh() -> bool:
    """Inside `use_mesh` of a mesh of several ranks."""
    mesh = _ambient_mesh()
    return mesh is not None and mesh.size() > 1


# Per-cell layout override (§Perf iteration A2): small models re-purpose
# the `model` axis for data parallelism -- set by launch/dryrun.py (and any
# caller that knows the arch scale) before tracing.
_BATCH_AXES_OVERRIDE = {"axes": None}


def set_batch_axes(axes):
    """axes: tuple of mesh axis names to use as the batch dim, or None for
    the default (pod, data)."""
    _BATCH_AXES_OVERRIDE["axes"] = axes


def get_batch_axes(mesh):
    names = tuple(mesh.mesh_dim_names)
    if _BATCH_AXES_OVERRIDE["axes"] is not None:
        return tuple(a for a in _BATCH_AXES_OVERRIDE["axes"] if a in names)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def resolve(mesh, dims, shape) -> P:
    """The spec `shard(x, *dims)` pins for a tensor of `shape`: "batch"
    -> the batch axes, "model" -> the model axis unless it carries the
    batch, an axis dropped where the dimension is smaller than it."""
    sizes = mesh_axes(mesh)
    batch = get_batch_axes(mesh) or None
    model_taken = batch is not None and "model" in batch

    def one(d, size):
        if d == "batch":
            a = batch
        elif d == "model":
            # if the model axis is carrying batch (small-model DP layout),
            # tensor dims must not claim it
            a = "model" if ("model" in sizes and not model_taken) else None
        else:
            a = d
        if a is None:
            return None
        # uneven shards are acceptable when size >= axis (waste <= 1
        # shard), catastrophic when size < axis (kv=1 on 16 idles 15/16)
        return a if size >= _axis_size(sizes, a) else None

    return P(*[one(d, s) for d, s in zip(dims, shape)])


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dimension) of a spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} not in mesh order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def even(mesh, spec, shape) -> P:
    """`spec` without the axes that do not divide their dimension evenly.
    GSPMD pads an uneven shard; DTensor keeps it uneven, and its
    collectives on such shards are not reliable (a gloo all-gather of
    2- and 1-head shards fails), so the port leaves such a dimension
    whole."""
    sizes = mesh_axes(mesh)
    return P(*[e if e is None or n % _axis_size(sizes, e) == 0 else None
               for e, n in zip(tuple(spec), shape)])


def shard(x, *dims: Optional[str]):
    """Constrain x: dims are per-axis entries; "batch" -> pod+data axes,
    "model" -> model axis, None -> unsharded.  Redistributes a DTensor
    on the ambient mesh to the `resolve`d spec (`even` shards only);
    anything else passes through."""
    mesh = _ambient_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(mesh, even(mesh, resolve(mesh, dims, x.shape),
                                 x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gather_weights(tree):
    """FSDP's per-layer all-gather: every DTensor leaf of a parameter tree
    gathered over the mesh axes other than `model` (tensor- and
    expert-parallel shards stay), so a layer's matmuls keep the batch
    sharded and move weights, not activations; the backward of the
    gather reduce-scatters the gradients.  Identity outside a mesh of
    several ranks."""
    mesh = _ambient_mesh()
    if mesh is None or mesh.size() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    if not hasattr(tree, "placements"):
        return tree
    from torch.distributed.tensor import Replicate
    pl = tuple(p if n == "model" else Replicate()
               for n, p in zip(mesh.mesh_dim_names, tree.placements))
    if pl == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, pl)
