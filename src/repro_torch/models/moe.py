"""Mixture-of-Experts layer: shared + routed experts, top-k routing,
capacity-bounded einsum dispatch (GShard/MaxText style).

The port of `repro.models.moe` on one card: `moe_apply` is the
reference's single-device `_moe_apply_global`.  Its expert-parallel
`_moe_apply_ep` (a `shard_map` over a mesh) waits for multi-GPU
placement (ROADMAP.md queue 1, items 13b/17h).

Covers both MoE configs:
  * deepseek-moe-16b: 2 shared + 64 routed, top-6, fine-grained d_ff=1408
  * qwen3-moe-30b-a3b: 128 routed, top-8, d_ff=768, no shared experts
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    pdt = L.torch_dtype(cfg.param_dtype)
    scale = 1.0 / math.sqrt(d)

    def normal(shape, s, dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=gen.device) * s).to(dtype)
    params = {
        "router": normal((d, E), scale, torch.float32),  # router stays f32
        "experts_wi": normal((E, d, ff), scale, pdt),
        "experts_wg": normal((E, d, ff), scale, pdt),
        "experts_wo": normal((E, ff, d), 1.0 / math.sqrt(ff), pdt),
    }
    if cfg.num_shared_experts:
        params["shared"] = L.swiglu_init(
            gen, cfg, d_ff=ff * cfg.num_shared_experts)
    return params


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    k, E = cfg.experts_per_token, cfg.num_experts
    c = int(num_tokens * k * cfg.capacity_factor / E) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing. xf: [T, d] -> (expert_idx [T,k] int32, gates [T,k] f32).

    DeepSeek-style: softmax over all experts, renormalized over the top-k.
    The top k come from a stable descending sort, so equal probabilities
    rank the lower expert id first, as `jax.lax.top_k` does
    (`torch.topk` promises no order among ties)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)         # [T, E]
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return idx.to(torch.int32), gates


def _dispatch(idx: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each routing slot's place in its expert's buffer: (pos [T,k],
    keep [T,k], slot [T,k]).  Positions count one routing slot at a time
    (slot-major, then token order), as the reference does; a slot past
    capacity C is dropped (keep False) and sent to the sentinel row
    E*C."""
    T, k = idx.shape
    pos = torch.zeros((T, k), dtype=torch.int64, device=idx.device)
    counts = torch.zeros((E,), dtype=torch.int64, device=idx.device)
    for j in range(k):
        oh = torch.nn.functional.one_hot(idx[:, j].long(), E)  # [T, E]
        pos_j = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
        pos[:, j] = torch.gather(pos_j, 1, idx[:, j, None].long())[:, 0]
        counts = counts + oh.sum(0)
    keep = pos < C
    slot = torch.where(keep, idx.long() * C + pos,
                       torch.full_like(pos, E * C))            # drop sentinel
    return pos, keep, slot


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d] (the reference's single-device path)."""
    return _moe_apply_global(params, cfg, x)


def _moe_apply_global(params: dict, cfg: ModelConfig,
                      x: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    T = B * S
    k, E = cfg.experts_per_token, cfg.num_experts
    C = _capacity(cfg, T)
    dt = x.dtype
    xf = x.reshape(T, d)

    idx, gates = route(cfg, params["router"], xf)              # [T,k]
    _, keep, slot = _dispatch(idx, E, C)

    # dispatch into [E*C, d]; dropped slots land on one extra row that is
    # cut off (the reference's scatter with mode="drop")
    src = xf[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device)
    buf.index_copy_(0, slot.reshape(-1), src)
    buf = buf[:E * C].reshape(E, C, d)

    # expert SwiGLU, batched over E
    h = (torch.nn.functional.silu(
        torch.einsum("ecd,edf->ecf", buf, params["experts_wg"].to(dt)))
         * torch.einsum("ecd,edf->ecf", buf, params["experts_wi"].to(dt)))
    out_flat = torch.einsum("ecf,efd->ecd", h,
                            params["experts_wo"].to(dt)).reshape(E * C, d)

    # combine: gather each token's k slots, weight by gates
    gathered = out_flat[torch.clamp(slot, max=E * C - 1).reshape(-1)
                        ].reshape(T, k, d)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=x.device))
    combined = torch.sum(gathered * gates[..., None].to(dt), dim=1)

    if cfg.num_shared_experts:
        combined = combined + L.swiglu_apply(params["shared"], xf)
    return combined.reshape(B, S, d)


def load_balance_loss(cfg: ModelConfig, router: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction * prob per expert)."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1).float() @ router, dim=-1)
    idx = torch.argmax(probs, dim=-1)          # first maximum, as jnp
    frac = torch.nn.functional.one_hot(idx, cfg.num_experts).float().mean(0)
    return cfg.num_experts * torch.sum(frac * probs.mean(0))
