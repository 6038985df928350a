"""AdamW + cosine schedule + global-norm clipping, from scratch.

The port of `repro.train.optimizer`.  The optimizer state mirrors the
parameter tree (moments in float32, the step an int32 scalar); every
update returns new trees and leaves its inputs as they were.  Weight
decay applies to leaves of ndim >= 2, counted on the stacked leaf, as in
the reference (so a stacked norm scale [G, d] decays too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.transformer import map_params, named_leaves

Tree = Any


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Tree             # first moment (f32)
    nu: Tree             # second moment (f32)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * peak (float32)."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_state(params: Tree) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, device=p.device)
    device = named_leaves(params)[0][1].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=map_params(zeros, params),
                     nu=map_params(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32), the leaves
    summed in the reference's order (sorted keys)."""
    total = None
    for _, g in named_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(cfg: OptimizerConfig, params: Tree, grads: Tree,
                  state: AdamState) -> Tuple[Tree, AdamState, Dict]:
    """One AdamW step (with clipping). Returns (params, state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    out = map_params(upd, params, grads, state.mu, state.nu)
    new_params, mu, nu = (map_params(lambda t, i=i: t[i], out)
                          for i in range(3))
    return (new_params, AdamState(step=step, mu=mu, nu=nu),
            {"lr": lr, "grad_norm": gnorm})
