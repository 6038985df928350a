"""Train-step factory: loss + grad + AdamW, with optional microbatching
(gradient accumulation) and gradient compression.

The port of `repro.train.train_lib`.  Autograd gives the gradients of
`transformer.loss_fn`; with microbatches, the losses and the gradients
(in float32) are summed over the microbatches in order, then scaled by
1/mb, as the reference's `lax.scan` does.  A batch-sharded DTensor batch
(a mesh of several ranks) is cut into microbatches within each rank's
own rows, so no row moves between ranks.  A step returns a new
`TrainState` and leaves the one it was given as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import compress as GC
from repro_torch.train import optimizer as OPT

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: OPT.AdamState
    # residuals live in the state only when compression is on
    compressor: Optional[GC.CompressorState]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OPT.OptimizerConfig = OPT.OptimizerConfig()
    microbatches: int = 1          # grad accumulation steps per update
    compress_grads: bool = False


def init_state(cfg: ModelConfig, tcfg: TrainConfig, gen: torch.Generator,
               *, device=None) -> TrainState:
    """Fresh parameters drawn from `gen` (`transformer.init_params`, on
    `device`: CUDA unless the caller passes another), zero moments."""
    params = T.init_params(cfg, gen, device=device)
    comp = GC.init_state(params) if tcfg.compress_grads else None
    return TrainState(params=params, opt=OPT.init_state(params),
                      compressor=comp)


def value_and_grad(cfg: ModelConfig, params: Tree,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                            Tree]:
    """loss_fn and its gradient in every parameter (each in its
    parameter's dtype; zeros where a parameter does not reach the
    loss)."""
    live = T.map_params(lambda p: p.detach().requires_grad_(True), params)
    flat = [p for _, p in T.named_leaves(live)]
    with torch.enable_grad():
        loss = T.loss_fn(cfg, live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grad_of = {id(p): g for p, g in zip(flat, grads)}
    return loss.detach(), T.map_params(
        lambda p: (torch.zeros_like(p) if grad_of[id(p)] is None
                   else _placed_as(grad_of[id(p)], p)), live)


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient (a partial sum over the batch's ranks) reduced
    once into its parameter's placement; any other tensor as it is."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(
            p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatches(x: torch.Tensor, mb: int) -> list:
    """The mb microbatches of x: consecutive row blocks (the reference's
    reshape [mb, rows / mb, ...]); for a DTensor, blocks of each rank's
    local rows, placed as x is."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        local = x.to_local()
        parts = local.reshape(mb, local.shape[0] // mb, *local.shape[1:])
        return [DTensor.from_local(parts[i], x.device_mesh, x.placements,
                                   run_check=False) for i in range(mb)]
    parts = x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
    return [parts[i] for i in range(mb)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:

    def accumulate(params, batch):
        if tcfg.microbatches == 1:
            return value_and_grad(cfg, params, batch)
        mb = tcfg.microbatches
        for k, x in batch.items():
            if x.shape[0] % mb:
                raise ValueError(f"batch {k}: {x.shape[0]} rows % "
                                 f"microbatches {mb} != 0")
        parts = {k: _microbatches(x, mb) for k, x in batch.items()}
        micro = [{k: v[i] for k, v in parts.items()} for i in range(mb)]
        loss_acc = 0.0
        g_acc = T.map_params(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for b in micro:
            loss, g = value_and_grad(cfg, params, b)
            loss_acc = loss_acc + loss
            g_acc = T.map_params(lambda a, g_: a + g_.float(), g_acc, g)
        inv = 1.0 / mb
        return loss_acc * inv, T.map_params(lambda g: g * inv, g_acc)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        loss, grads = accumulate(state.params, batch)
        comp_state = state.compressor
        if tcfg.compress_grads:
            vals, scales, comp_state = GC.compress(comp_state, grads)
            grads = GC.decompress(vals, scales)
        params, opt, metrics = OPT.apply_updates(
            tcfg.opt, state.params, grads, state.opt)
        metrics = {"loss": loss, **metrics}
        return TrainState(params=params, opt=opt,
                          compressor=comp_state), metrics

    return train_step
