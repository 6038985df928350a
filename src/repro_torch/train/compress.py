"""Gradient compression for the data-parallel all-reduce: int8 error
feedback.

The port of `repro.train.compress`.  Per-leaf symmetric int8
quantization with a residual carried across steps (error feedback keeps
the compressor unbiased in the long run).  `torch.round`, like
`jnp.round`, rounds half to even, so the int8 values equal the
reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.transformer import map_params

Tree = Any


class CompressorState(NamedTuple):
    residual: Tree     # f32, same structure as grads


def init_state(grads_like: Tree) -> CompressorState:
    return CompressorState(residual=map_params(
        lambda g: torch.zeros(g.shape, device=g.device), grads_like))


def compress(state: CompressorState, grads: Tree
             ) -> Tuple[Tree, Tree, CompressorState]:
    """-> (int8 values, f32 scales, new state). Quantizes g + residual."""
    def q(g, r):
        gf = g.float() + r
        scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return q8, scale, gf - q8.float() * scale

    out = map_params(q, grads, state.residual)
    vals, scales, resid = (map_params(lambda t, i=i: t[i], out)
                           for i in range(3))
    return vals, scales, CompressorState(residual=resid)


def decompress(vals: Tree, scales: Tree) -> Tree:
    return map_params(lambda v, s: v.float() * s, vals, scales)
