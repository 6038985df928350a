"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Block = (gelu gate branch) * (causal conv1d -> RG-LRU) -> out projection.
RG-LRU per channel:

    r_t = sigmoid(x_t * w_a + b_a)              recurrence gate
    i_t = sigmoid(x_t * w_x + b_x)              input gate
    a_t = exp(-c * softplus(Lambda) * r_t)      c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of `repro.models.rglru`.  Prefill and forward run the
recurrence as a log-depth scan; decode is the single-step recurrence
with O(1) state.  The reference's `jax.nn.gelu` is the tanh
approximation, so the gate uses `approximate="tanh"`.  One activation
anchor the reference lacks pins the block's output to the batch layout
(the identity without a mesh of several ranks): on a mesh, DTensor's
backward otherwise meets the scan's gradient in a strided layout it
cannot take.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.constrain import shard

_C = 8.0


class RecurrentState(NamedTuple):
    conv: torch.Tensor   # [B, conv_width-1, w] trailing inputs
    h: torch.Tensor      # [B, w] RG-LRU hidden (float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    pdt = L.torch_dtype(cfg.param_dtype)
    dev = gen.device
    # Lambda init so a ~ U(0.9, 0.999)^c at r=1 (griffin appendix)
    u = torch.rand((w,), generator=gen, dtype=torch.float32,
                   device=dev) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))  # softplus^-1(-log u)
    zeros = lambda: torch.zeros((w,), dtype=torch.float32, device=dev)
    return {
        "w_gate": L.dense_init(gen, d, w, pdt),
        "w_in": L.dense_init(gen, d, w, pdt),
        "w_out": L.dense_init(gen, w, d, pdt),
        "conv_k": (torch.randn((cfg.conv_width, w), generator=gen,
                               dtype=torch.float32, device=dev)
                   / math.sqrt(cfg.conv_width)).to(pdt),
        "lam": lam,                                  # f32
        "gate_a": zeros(), "gate_x": zeros(),
        "bias_a": zeros(), "bias_x": zeros(),
    }


def _gates(params: dict, u: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: [..., w] f32 -> (a, gated input) both f32."""
    r = torch.sigmoid(u * params["gate_a"] + params["bias_a"])
    i = torch.sigmoid(u * params["gate_x"] + params["bias_x"])
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x
    # itself above 20, where the two differ by < 2e-9 (below a float32
    # ulp of 20).  lam lies in (-6.9, -2.2) from its init anyway.
    lam = params["lam"]
    decay = _C * torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-decay * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)
    return a, gated


def _conv_causal(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Per-channel causal conv, width cfg.conv_width. x: [B, S, w]."""
    kern = params["conv_k"].to(x.dtype)
    out = x * kern[-1]
    for i in range(1, cfg.conv_width):
        shifted = torch.nn.functional.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * kern[-1 - i]
    return out


def rglru_scan(params: dict, u: torch.Tensor) -> torch.Tensor:
    """RG-LRU over a full sequence. u: [B, S, w] -> [B, S, w].

    h_t = a_t h_{t-1} + b_t as an inclusive scan of (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), in log2(S) doubling steps
    (Hillis-Steele).  The reference's `lax.associative_scan` combines in
    another order, so the two agree to float32 rounding, not bit for
    bit."""
    a, b = _gates(params, u.float())
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b.to(u.dtype)


def rglru_step(params: dict, u_t: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. u_t: [B, w], h: [B, w] f32."""
    a, b = _gates(params, u_t.float())
    h_new = a * h + b
    return h_new.to(u_t.dtype), h_new


def block_apply(params: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """Full-sequence recurrent block. x: [B, S, d]."""
    dt = x.dtype
    gate = gelu(x @ params["w_gate"].to(dt))
    u = _conv_causal(params, x @ params["w_in"].to(dt), cfg)
    h = rglru_scan(params, u)
    return shard((gate * h) @ params["w_out"].to(dt), "batch", None, None)


def block_step(params: dict, cfg: ModelConfig, x_t: torch.Tensor,
               state: RecurrentState
               ) -> Tuple[torch.Tensor, RecurrentState]:
    """One-token decode. x_t: [B, d]."""
    dt = x_t.dtype
    gate = gelu(x_t @ params["w_gate"].to(dt))
    u_t = x_t @ params["w_in"].to(dt)                          # [B, w]
    # conv over (state.conv ++ u_t)
    kern = params["conv_k"].to(dt)
    hist = torch.cat([state.conv, u_t[:, None, :]], dim=1)
    u_conv = torch.einsum("btw,tw->bw", hist, kern)
    out_h, h_new = rglru_step(params, u_conv, state.h)
    y = (gate * out_h) @ params["w_out"].to(dt)
    return y, RecurrentState(conv=hist[:, 1:], h=h_new)


def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device=None) -> RecurrentState:
    w = cfg.lru_width or cfg.d_model
    return RecurrentState(
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device))
