"""Config-driven model assembly for every family: dense (GQA, MLA), MoE,
hybrid (RG-LRU with local attention), xLSTM, the whisper
encoder-decoder and the llava patch prefix.

The port of `repro.models.transformer`.  The layer stack is grouped by
the config's block pattern (e.g. recurrentgemma's ("rglru", "rglru",
"local")); the parameter tree keeps the reference's names and its
stacked-groups layout: every per-layer leaf is stacked [num_groups,
...], and the stack loops over the groups where the reference scans
them (`lax.scan`).  `params_from_numpy` carries a reference tree
across, leaf for leaf.  `forward` runs without autograd; `loss_fn` runs
the same stack with it, recomputing each group in the backward pass
when `cfg.remat` is set (the reference's `jax.checkpoint` per group).

Batch dict keys:
  tokens  [B, S] integer      — always present (decoder tokens for enc-dec)
  patches [B, P, d]           — vlm frontend stub (replaces first P embeds)
  frames  [B, F, d]           — audio frontend stub (encoder input)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.ring import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.parallel.constrain import (gather_weights, mesh_modes,
                                            on_mesh, shard)

Tree = Dict[str, Any]

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Tree:
    d = cfg.d_model
    pdt = L.torch_dtype(cfg.param_dtype)
    p: Tree = {"ln1": L.rmsnorm_init(d, pdt, gen.device)}
    if kind in ("attn", "local"):
        p["attn"] = (L.mla_init(gen, cfg) if cfg.attention == "mla"
                     else L.gqa_init(gen, cfg))
        p["ln2"] = L.rmsnorm_init(d, pdt, gen.device)
        if cfg.num_experts:
            p["moe"] = MOE.moe_init(gen, cfg)
        else:
            p["ffn"] = L.swiglu_init(gen, cfg)
        if cfg.is_encoder_decoder:
            p["ln_cross"] = L.rmsnorm_init(d, pdt, gen.device)
            p["cross"] = L.gqa_init(gen, cfg)
    elif kind == "rglru":
        p["rec"] = RG.rglru_init(gen, cfg)
        p["ln2"] = L.rmsnorm_init(d, pdt, gen.device)
        p["ffn"] = L.swiglu_init(gen, cfg)
    elif kind == "mlstm":
        p["cell"] = X.mlstm_init(gen, cfg)
    elif kind == "slstm":
        p["cell"] = X.slstm_init(gen, cfg)
    else:
        raise ValueError(kind)
    return p


def stack_trees(trees) -> Tree:
    """Stack a list of same-shaped trees leaf by leaf on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stacked(n: int, draw: Callable[[], Tree]) -> Tree:
    """stack_trees([draw() for _ in range(n)]), written into preallocated
    [n, ...] leaves one draw at a time, so no more than one draw's
    leaves exist beside the stack (a full-width model fills most of the
    card)."""
    tree = draw()
    out = map_params(lambda a: torch.empty((n, *a.shape), dtype=a.dtype,
                                           device=a.device), tree)
    for i in range(n):
        if i:
            tree = draw()
        _copy_into(out, tree, i)
        tree = None
    return out


def _copy_into(out: Tree, tree: Tree, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(out[k], v, i)
        else:
            out[k][i].copy_(v)


def _groups_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    """Params for one group (all pattern positions), stacked over groups."""
    return _stacked(cfg.num_groups, lambda: {
        f"b{i}": _block_init(gen, cfg, kind)
        for i, kind in enumerate(cfg.pattern)})


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: `encoder_layers` global attention
    blocks without cross attention, as the reference builds it."""
    return dataclasses.replace(cfg, is_encoder_decoder=False,
                               num_layers=cfg.encoder_layers,
                               block_pattern=("attn",))


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Tree:
    """A random parameter tree drawn from `gen` (on the generator's
    device), then moved to `device` (default: CUDA, as every entry point;
    pass "cpu" for the host).  Leaves in cfg.param_dtype, but the MoE
    router and the RG-LRU gates, which `moe_init` and `rglru_init` keep in
    float32 as the reference does (so do the xLSTM gates and the sLSTM's
    recurrent weights)."""
    check_supported(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    pdt = L.torch_dtype(cfg.param_dtype)
    params: Tree = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen,
                              dtype=torch.float32, device=gen.device)
                  * (1.0 / math.sqrt(d))).to(pdt),
        "groups": _groups_init(gen, cfg),
        "final_norm": L.rmsnorm_init(d, pdt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, d, cfg.vocab_size, pdt)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "groups": _groups_init(gen, encoder_config(cfg)),
            "final_norm": L.rmsnorm_init(d, pdt, gen.device),
        }
    return map_params(lambda x: x.to(device), params)


def map_params(fn, tree: Tree, *rest: Tree) -> Tree:
    """Apply `fn` to every leaf of a parameter tree (with the same leaf
    of each tree of `rest`, which share its structure)."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def named_leaves(tree, prefix: tuple = ()):
    """(key path, leaf) of every leaf of a tree of dicts and named tuples,
    in JAX's flatten order: dict keys sorted, named-tuple fields in
    order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items for leaf in named_leaves(v, prefix + (k,))]


def params_from_numpy(cfg: ModelConfig, tree: Tree, *, device=None) -> Tree:
    """Carry a reference parameter tree (numpy leaves, [G, ...] stacked)
    into the port's layout on `device`: a leaf the reference keeps in
    float32 (the MoE router, the RG-LRU gates) stays float32, every other
    leaf takes cfg.param_dtype.  bfloat16 leaves pass through float32,
    which is exact."""
    check_supported(cfg)
    device = resolve_device(device)
    pdt = L.torch_dtype(cfg.param_dtype)
    return map_params(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            device=device,
            dtype=torch.float32 if np.asarray(a).dtype == np.float32
            else pdt), tree)


def group_params(groups: Tree, g: int) -> Tree:
    """Group g's slice of the stacked per-layer leaves."""
    return map_params(lambda a: a[g], groups)


def iter_groups(cfg: ModelConfig, groups: Tree) -> Iterator[Tree]:
    for g in range(cfg.num_groups):
        yield group_params(groups, g)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(cfg: ModelConfig, kind: str, p: Tree, x: torch.Tensor,
                 enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    window = cfg.window if kind == "local" else 0
    if kind in ("attn", "local"):
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        if cfg.attention == "mla":
            x = x + L.mla_apply(p["attn"], cfg, h)
        else:
            causal = not (cfg.is_encoder_decoder and enc_out is None)
            x = x + L.gqa_apply(p["attn"], cfg, h, window=window,
                                causal=causal)
        if cfg.is_encoder_decoder and enc_out is not None:
            h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
            x = x + L.gqa_apply(p["cross"], cfg, h, causal=False,
                                kv_x=enc_out, use_rope=False)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if cfg.num_experts:
            x = x + MOE.moe_apply(p["moe"], cfg, h)
        else:
            x = x + L.swiglu_apply(p["ffn"], h)
    elif kind == "rglru":
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + RG.block_apply(p["rec"], cfg, h)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu_apply(p["ffn"], h)
    elif kind == "mlstm":
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + X.mlstm_block_apply(p["cell"], cfg, h)
    elif kind == "slstm":
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + X.slstm_block_apply(p["cell"], cfg, h)
    else:
        raise ValueError(kind)
    return x


def _run_stack(cfg: ModelConfig, groups: Tree, x: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None,
               pattern: Optional[tuple] = None) -> torch.Tensor:
    pattern = pattern or cfg.pattern

    def group(x, gp, enc_out):
        with mesh_modes():
            gp = gather_weights(gp)
            x = shard(x, "batch", None, None)
            for i, kind in enumerate(pattern):
                x = _block_apply(cfg, kind, gp[f"b{i}"], x, enc_out)
            return shard(x, "batch", None, None)

    remat = cfg.remat and torch.is_grad_enabled()
    for gp in iter_groups(cfg, groups):
        x = (checkpoint(group, x, gp, enc_out, use_reentrant=False)
             if remat else group(x, gp, enc_out))
    return x


def _encode(cfg: ModelConfig, params: Tree,
            frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings.

    As in the reference, the encoder's blocks run with its config's
    `is_encoder_decoder=False`, so their self-attention is causal (the
    reference's comment calls it bidirectional; ROADMAP.md records it)."""
    enc_cfg = encoder_config(cfg)
    x = frames.to(L.torch_dtype(cfg.dtype))
    x = _run_stack(enc_cfg, params["encoder"]["groups"], x, enc_out=None,
                   pattern=("attn",))
    return L.rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Token embeddings in cfg.dtype.  On a mesh of several ranks the
    table is gathered whole and looked up through `embedding`: DTensor
    shards neither an index's backward nor, on every torch, a lookup in a
    vocab-sharded table."""
    if on_mesh():
        w = params["embed"]
        if hasattr(w, "placements"):
            from torch.distributed.tensor import Replicate
            w = w.redistribute(w.device_mesh,
                               [Replicate()] * w.device_mesh.ndim)
        return torch.nn.functional.embedding(
            tokens.long(), w).to(L.torch_dtype(cfg.dtype))
    return params["embed"][tokens.long()].to(L.torch_dtype(cfg.dtype))


def embed_inputs(cfg: ModelConfig, params: Tree,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings, the first P replaced by `patches` where the
    config has that frontend."""
    x = shard(embed(cfg, params, batch["tokens"]), "batch", None, None)
    if cfg.frontend == "patches" and "patches" in batch:
        P = batch["patches"].shape[1]
        x = torch.cat([batch["patches"].to(x.dtype), x[:, P:]], dim=1)
    return x


def unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    """Final norm already applied: x @ unembed in cfg.dtype."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(L.torch_dtype(cfg.dtype))


def _logits(cfg: ModelConfig, params: Tree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    enc_out = (_encode(cfg, params, batch["frames"])
               if cfg.is_encoder_decoder else None)
    x = _run_stack(cfg, params["groups"], x, enc_out=enc_out)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return shard(unembed(cfg, params, x), "batch", None, "model")


@torch.no_grad()
def forward(cfg: ModelConfig, params: Tree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> logits [B, S, V]."""
    return _logits(cfg, params, batch)


def loss_fn(cfg: ModelConfig, params: Tree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy (f32 logsumexp), differentiable in the
    params.  Under the patch frontend the first cfg.num_patches target
    positions carry no target; as in the reference, that mask is one
    row [1, S - 1], so the sum of the masked losses is divided by the
    targets of one sequence, not of the batch."""
    logits = _logits(cfg, params, batch).float()[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    if on_mesh():
        # each rank picks from its own vocab shard (a gather's backward
        # would make a zero gradient of the global shape on every rank)
        ids = torch.arange(logits.shape[-1], device=logits.device)
        picked = torch.where(targets[..., None] == ids, logits, 0.0).sum(-1)
    else:
        picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    mask = torch.ones(targets.shape, device=logits.device)
    if cfg.frontend == "patches":
        pos = torch.arange(targets.shape[1], device=logits.device)
        mask = torch.where(pos[None, :] < cfg.num_patches, 0.0, 1.0)
    ce = (lse - picked) * mask
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1.0)
