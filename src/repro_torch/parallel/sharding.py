"""Name-based sharding rules (t5x-style): parameter-tree paths -> P.

The port of `repro.parallel.sharding`, with the reference's rules and
leaf paths (the port's trees carry the reference's names).  A spec `P`
(`parallel.constrain.P`) is a tuple of mesh-axis names per dimension;
`to_shardings` turns it into DTensor placements on a `DeviceMesh`.

Strategy:
  * TP: attention heads / FFN hidden / experts / vocab on the `model` axis.
  * FSDP/ZeRO-3: the contracting (d_model/ff-in) dim of every large matrix
    on the `data` axis -- params AND Adam moments are fully sharded; each
    layer gathers its weights and reduce-scatters its gradients.
  * `pod` composes with `data` for the batch; params are not sharded over
    `pod` (weight gathers stay inside a pod; only grad reduction crosses).
  * Stacked layer groups carry a leading group axis -> rules key on
    trailing dims.

Small / state-like leaves (norm scales, biases, RG-LRU gates, routers)
replicate -- sharding them buys nothing and costs collectives.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import numpy as np
import torch

from repro_torch.parallel.constrain import (P, _axis_size, mesh_axes,
                                            placements)

PyTree = Any

# (regex on "/"-joined path, spec for the LAST ndim dims of the leaf)
_PARAM_RULES = [
    # embeddings: vocab on model; d replicated (gather stays cheap)
    (r"(^|/)unembed$",             P(None, "model")),
    (r"(^|/)embed$",               P("model", None)),
    # attention (leading group axis handled by padding below)
    (r"attn/w(q|k|v)$",            P("data", "model")),
    (r"attn/wo$",                  P("model", "data")),
    (r"cross/w(q|k|v)$",           P("data", "model")),
    (r"cross/wo$",                 P("model", "data")),
    # MLA
    (r"attn/wq_down$",             P("data", None)),
    (r"attn/wq_up$",               P(None, "model")),
    (r"attn/wkv_down$",            P("data", None)),
    (r"attn/w(k|v)_up$",           P(None, "model")),
    # dense FFN
    (r"ffn/w(i|g)$",               P("data", "model")),
    (r"ffn/wo$",                   P("model", "data")),
    (r"shared/w(i|g)$",            P("data", "model")),
    (r"shared/wo$",                P("model", "data")),
    # MoE: experts on model (EP), contracting dim on data (FSDP)
    (r"moe/experts_w(i|g)$",       P("model", "data", None)),
    (r"moe/experts_wo$",           P("model", None, "data")),
    (r"moe/router$",               P("data", None)),
    # RG-LRU
    (r"rec/w_(gate|in)$",          P("data", "model")),
    (r"rec/w_out$",                P("model", "data")),
    (r"rec/conv_k$",               P(None, "model")),
    (r"rec/(lam|gate_a|gate_x|bias_a|bias_x)$", P("model")),
    # xLSTM (small models: replicate weights, shard batch only)
    (r"cell/.*$",                  None),
    # norms / everything else: replicate
    (r".*$",                       None),
]


def _spec_for(path: str, ndim: int) -> P:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if spec is None:
                return P()
            pad = ndim - len(spec)
            assert pad >= 0, f"{path}: rule {spec} too long for ndim {ndim}"
            return P(*([None] * pad + list(spec)))
    return P()


def _is_named_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree: PyTree, *rest: PyTree,
                       is_leaf=None, prefix: tuple = ()) -> PyTree:
    """fn(path, leaf, *leaves of `rest`) over a tree of dicts, named
    tuples and tuples (None is an empty subtree; a spec P is a leaf);
    `path` is the tuple of keys, field names and indices, as the
    reference's key paths."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      is_leaf=is_leaf, prefix=prefix + (k,))
                for k, v in tree.items()}
    if _is_named_tuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(getattr(r, f) for r in rest),
                               is_leaf=is_leaf, prefix=prefix + (f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, tuple) and not _is_spec(tree):
        return tuple(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               is_leaf=is_leaf, prefix=prefix + (i,))
            for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def param_specs(params: PyTree) -> PyTree:
    """P tree matching `params`."""
    return tree_map_with_path(
        lambda path, x: _spec_for("/".join(map(str, path)), x.ndim), params)


def to_shardings(mesh, specs: PyTree) -> PyTree:
    """The DTensor placements (one per mesh dimension) of every spec."""
    return tree_map_with_path(lambda _, s: placements(mesh, s), specs,
                              is_leaf=_is_spec)


def param_shardings(mesh, params: PyTree) -> PyTree:
    return to_shardings(mesh, param_specs(params))


def batch_axes(mesh):
    """The composite batch axis -- ('pod','data') by default; small-model
    cells override via constrain.set_batch_axes (DP-over-model layout)."""
    from repro_torch.parallel.constrain import get_batch_axes
    return get_batch_axes(mesh)


def choose_layout(mesh, param_count: int, global_batch: int,
                  small_model_threshold: int = 1_000_000_000):
    """Pick batch axes for a cell.  Models small enough to replicate
    (params + f32 Adam moments < ~10 GiB/card) re-purpose the model axis
    for DP when the batch divides -- a 360M model on 256 cards wants
    DP=256, not TP=8.  Returns (batch_axes, replicate_params)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    if param_count <= small_model_threshold:
        candidates = [("pod", "data", "model"), ("data", "model"),
                      ("pod", "data"), ("data",)]
        for cand in candidates:
            axes = tuple(a for a in cand if a in names)
            if not axes or set(axes) != set(cand) & set(names):
                continue
            size = math.prod(sizes[a] for a in axes)
            if global_batch % size == 0 and "model" in axes:
                return axes, True
    return tuple(a for a in ("pod", "data") if a in names), False


def replicated_param_specs(params: PyTree) -> PyTree:
    return tree_map_with_path(lambda _, x: P(), params)


def data_specs(mesh, batch: PyTree) -> PyTree:
    """Shard every batch leaf on its leading (batch) dim."""
    b = batch_axes(mesh)
    return tree_map_with_path(
        lambda _, x: P(*((b,) + (None,) * (x.ndim - 1))), batch)


def cache_specs(mesh, cache: PyTree) -> PyTree:
    """Decode-cache sharding: leaves are [G, B, T, ...] -- B on batch axes,
    T (dim 2, when it is the long context axis) on `model`.  State-like
    leaves [G, B, ...] shard B only.  `pos` scalar replicates."""
    b = batch_axes(mesh)

    def spec(path, x):
        name = "/".join(map(str, path))
        if name.endswith("pos"):
            return P()
        if x.ndim >= 4 and re.search(r"(k|v|ckv|krope|ck|cv)$", name):
            # [G, B, T, ...]: shard T on model ONLY for genuinely long axes;
            # ring buffers (W = window) and encoder K/V stay local.
            t = x.shape[2]
            t_spec = "model" if t >= 8192 else None
            return P(*((None, b, t_spec) + (None,) * (x.ndim - 3)))
        if x.ndim >= 2:
            return P(*((None, b) + (None,) * (x.ndim - 2)))
        return P()

    return tree_map_with_path(spec, cache)


def sanitize_specs(mesh, specs: PyTree, shapes: PyTree,
                   allow_move: bool = True) -> PyTree:
    """Drop axes that don't divide their dim (DTensor shards unevenly,
    but the reference's pjit in_shardings demand exact divisibility, and
    the layouts follow it); if a dropped axis can move to a sibling dim
    that divides and is unsharded, move it there (e.g. minicpm3's vocab
    73448 % 16 != 0 -> shard d_model instead).  allow_move=False disables
    the move (launch/dryrun.py retries with it)."""
    sizes = mesh_axes(mesh)

    def fix(_, spec, x):
        shape = tuple(x.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        dropped = []
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is not None and dim % _axis_size(sizes, e) != 0:
                dropped.append(e)
                entries[i] = None
        if allow_move:
            for e in dropped:
                for i, (cur, dim) in enumerate(zip(entries, shape)):
                    if cur is None and dim % _axis_size(sizes, e) == 0 \
                            and dim >= _axis_size(sizes, e) \
                            and e not in entries:
                        entries[i] = e
                        break
        return P(*entries)

    return tree_map_with_path(fix, specs, shapes, is_leaf=_is_spec)


def distribute(mesh, tree: PyTree, specs: PyTree) -> PyTree:
    """Every leaf of `tree` placed on `mesh` by its spec: a tensor as a
    DTensor (each rank holds the same full leaf and keeps its shard), a
    DTensor redistributed; a None spec leaves its subtree as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(_, spec, x):
        if spec is None:
            return x
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements(mesh, spec))
        return distribute_tensor(x, mesh, placements(mesh, spec))
    return tree_map_with_path(place, specs, tree,
                              is_leaf=lambda s: s is None or _is_spec(s))


# ---------------------------------------------------------------------------
# a sharded table's [S, ...] stacks on a one-process shard mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeadingSharding:
    """The split of an array's LEADING dim over the `axis` of a shard mesh
    (`launch.mesh.ShardMesh`): position j holds rows [j·S/d, (j+1)·S/d)
    on `mesh.devices[j]` (the repro.db sharded-table layout, where
    ciphertext stacks are [S, ...])."""
    mesh: Any
    ndim: int
    axis: str = "shard"

    @property
    def spec(self) -> P:
        """The reference's PartitionSpec of this split."""
        return P(self.axis, *([None] * (self.ndim - 1)))

    def slices(self, rows: int) -> list:
        """[(device, slice of the leading dim)] per mesh position."""
        d = self.mesh.shape[self.axis]
        if rows % d:
            raise ValueError(f"{rows} rows do not split over {d} positions")
        per = rows // d
        return [(dev, slice(j * per, (j + 1) * per))
                for j, dev in enumerate(self.mesh.devices)]


def leading_sharding(mesh, ndim: int, axis: str = "shard"
                     ) -> LeadingSharding:
    """The split of an ndim-dim array's leading dim over `axis`."""
    return LeadingSharding(mesh, ndim, axis)


class ShardStack:
    """A [S, ...] tensor held as d slabs of [S/d, ...], slab j on mesh
    position j's device: a sharded table's column stack placed on a shard
    mesh (`shard_leading`).  Shard s is row s mod S/d of slab s // (S/d).
    One slab is the whole stack on one device (an unplaced table).

    Readers bring rows to one device (`shard`, `rows`, `full`); the
    per-device work (the fused scan's `kernels.ops.shard_eval_values`,
    the join's `db.shard.join.sharded_pair_eval`) reads the slabs where
    they lie."""

    def __init__(self, slabs):
        self.slabs = tuple(slabs)
        if not self.slabs:
            raise ValueError("a shard stack needs at least one slab")
        first = self.slabs[0]
        for x in self.slabs[1:]:
            if x.shape != first.shape or x.dtype != first.dtype:
                raise ValueError(
                    f"ragged slabs: {[tuple(x.shape) for x in self.slabs]}")

    @classmethod
    def of(cls, x) -> "ShardStack":
        """`x` as a stack: itself, or a tensor as one slab."""
        return x if isinstance(x, ShardStack) else cls((x,))

    # -- geometry -------------------------------------------------------

    @property
    def num_slabs(self) -> int:
        return len(self.slabs)

    @property
    def per_slab(self) -> int:
        """Shards a slab holds (S/d)."""
        return int(self.slabs[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        """The logical [S, ...] shape."""
        first = self.slabs[0].shape
        return torch.Size((first[0] * len(self.slabs),) + tuple(first[1:]))

    @property
    def ndim(self) -> int:
        return len(self.slabs[0].shape)

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs[0].dtype

    @property
    def device(self) -> torch.device:
        """The home device: slab 0's."""
        return self.slabs[0].device

    @property
    def devices(self) -> tuple:
        """Each slab's device, in position order."""
        return tuple(x.device for x in self.slabs)

    @property
    def nbytes(self) -> int:
        return sum(x.nbytes for x in self.slabs)

    def locate(self, s: int) -> tuple:
        """Shard s -> (slab, row of the slab)."""
        return divmod(int(s), self.per_slab)

    # -- reads ----------------------------------------------------------

    def shard(self, s: int, device=None) -> torch.Tensor:
        """Shard s's [...] block on `device` (home by default; a view
        when it lies there)."""
        j, i = self.locate(s)
        return self.slabs[j][i].to(device or self.device)

    def full(self, device=None) -> torch.Tensor:
        """The logical [S, ...] tensor on `device` (home by default): the
        slab itself when there is one and it lies there."""
        device = torch.device(device or self.device)
        if len(self.slabs) == 1:
            return self.slabs[0].to(device)
        return torch.cat([x.to(device) for x in self.slabs])

    def rows(self, shards, slots, device=None) -> torch.Tensor:
        """Rows at the (shard, slot) pairs, in their order, on `device`
        (home by default): [m, ...] from the slabs' [S/d, N, ...]."""
        device = torch.device(device or self.device)
        shards = np.asarray(shards, np.int64)
        slots = np.asarray(slots, np.int64)
        j, i = np.divmod(shards, self.per_slab)
        used = np.unique(j)

        def take(slab, sel):
            x = self.slabs[slab]
            t = lambda a: torch.as_tensor(a, device=x.device)  # noqa: E731
            return x[t(i[sel]), t(slots[sel])].to(device)
        if used.size <= 1:
            return take(int(used[0]) if used.size else 0, slice(None))
        out = torch.empty((shards.size,) + tuple(self.slabs[0].shape[2:]),
                          dtype=self.dtype, device=device)
        for slab in used:
            sel = np.nonzero(j == slab)[0]
            out[torch.as_tensor(sel, device=device)] = take(int(slab), sel)
        return out

    def map(self, fn) -> "ShardStack":
        """fn applied to every slab where it lies."""
        return ShardStack(fn(x) for x in self.slabs)

    @staticmethod
    def stack(stacks, dim: int) -> "ShardStack":
        """Stacks of one placement stacked slab by slab along `dim` (>= 1;
        one stack is a view with a new dim of size 1)."""
        if len(stacks) == 1:
            return stacks[0].map(lambda x: x.unsqueeze(dim))
        return ShardStack(torch.stack(slabs, dim=dim)
                          for slabs in zip(*(s.slabs for s in stacks)))

    def __array__(self, dtype=None, copy=None):
        out = self.full("cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardStack({tuple(self.shape)}, {self.dtype}, "
                f"slabs={len(self.slabs)}, devices="
                f"{[str(d) for d in self.devices]})")


def _place_leading(x, sharding: LeadingSharding) -> ShardStack:
    """One [S, ...] tensor as slabs on their devices.  When every
    position is x's device the slabs are views (no copy); otherwise a
    slab staying on x's device is a copy, so x itself can be freed.  A
    stack already placed so is returned as it is."""
    if isinstance(x, ShardStack):
        if x.devices == tuple(sharding.mesh.devices):
            return x
        x = x.full()
    parts = sharding.slices(int(x.shape[0]))
    here = all(dev == x.device for dev, _ in parts)
    slabs = []
    for dev, rows in parts:
        piece = x[rows]
        if dev != x.device:
            piece = piece.to(dev)
        elif not here:
            piece = piece.clone()
        slabs.append(piece)
    return ShardStack(slabs)


def shard_leading(mesh, tree: PyTree, axis: str = "shard") -> PyTree:
    """Every tensor leaf of `tree` with its leading dim split over
    `axis`: a `ShardStack` of per-position slabs on their devices.

    Used by `db.shard.ShardSpec.place` to pin a sharded table's column
    stacks to the mesh at ingest, so each later Eval launch runs on the
    card that holds its rows."""
    def place(_, x):
        if isinstance(x, (torch.Tensor, ShardStack)):
            return _place_leading(x, leading_sharding(mesh, x.ndim, axis))
        return x
    return tree_map_with_path(place, tree,
                              is_leaf=lambda x: isinstance(x, ShardStack))
