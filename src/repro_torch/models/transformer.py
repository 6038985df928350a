"""Config-driven model assembly: the dense GQA family.

The port of `repro.models.transformer` for `family == "dense"` with GQA
attention (`config.check_supported` raises, naming the ROADMAP.md item,
for every other family).  The parameter tree keeps the reference's names
and its stacked-groups layout: every per-layer leaf is stacked
[num_groups, ...], and the stack loops over the groups where the
reference scans them (`lax.scan`).  `params_from_numpy` carries a
reference tree across, leaf for leaf.

Batch dict keys: tokens [B, S] integer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.core.ring import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    pdt = L.torch_dtype(cfg.param_dtype)
    return {"ln1": L.rmsnorm_init(d, pdt, gen.device),
            "attn": L.gqa_init(gen, cfg),
            "ln2": L.rmsnorm_init(d, pdt, gen.device),
            "ffn": L.swiglu_init(gen, cfg)}


def stack_trees(trees) -> Tree:
    """Stack a list of same-shaped trees leaf by leaf on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Tree:
    """A random parameter tree drawn from `gen` (on the generator's
    device), then moved to `device` (default: CUDA, as every entry point;
    pass "cpu" for the host).  Leaves in cfg.param_dtype."""
    check_supported(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    pdt = L.torch_dtype(cfg.param_dtype)
    params: Tree = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen,
                              dtype=torch.float32, device=gen.device)
                  * (1.0 / math.sqrt(d))).to(pdt),
        "groups": stack_trees([
            {f"b{i}": _block_init(gen, cfg) for i in range(cfg.group_size)}
            for _ in range(cfg.num_groups)]),
        "final_norm": L.rmsnorm_init(d, pdt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, d, cfg.vocab_size, pdt)
    return map_params(lambda x: x.to(device), params)


def map_params(fn, tree: Tree) -> Tree:
    """Apply `fn` to every leaf of a parameter tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: Tree, *, device=None) -> Tree:
    """Carry a reference parameter tree (numpy leaves, [G, ...] stacked)
    into the port's layout on `device`, leaves in cfg.param_dtype.
    bfloat16 leaves pass through float32, which is exact."""
    check_supported(cfg)
    device = resolve_device(device)
    pdt = L.torch_dtype(cfg.param_dtype)
    return map_params(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=pdt), tree)


def group_params(groups: Tree, g: int) -> Tree:
    """Group g's slice of the stacked per-layer leaves."""
    return map_params(lambda a: a[g], groups)


def iter_groups(cfg: ModelConfig, groups: Tree) -> Iterator[Tree]:
    for g in range(cfg.num_groups):
        yield group_params(groups, g)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(cfg: ModelConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + L.gqa_apply(p["attn"], cfg, h)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.swiglu_apply(p["ffn"], h)


def embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["embed"][tokens.long()].to(L.torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    """Final norm already applied: x @ unembed in cfg.dtype."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(L.torch_dtype(cfg.dtype))


@torch.no_grad()
def forward(cfg: ModelConfig, params: Tree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> logits [B, S, V]."""
    check_supported(cfg)
    x = embed(cfg, params, batch["tokens"])
    for gp in iter_groups(cfg, params["groups"]):
        for i in range(cfg.group_size):
            x = _block_apply(cfg, gp[f"b{i}"], x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(cfg, params, x)

