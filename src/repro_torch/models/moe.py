"""Mixture-of-Experts layer: shared + routed experts, top-k routing,
capacity-bounded einsum dispatch (GShard/MaxText style).

The port of `repro.models.moe`.  On one card (or a one-rank mesh)
`moe_apply` runs `_moe_apply_global`; on a mesh whose `model` axis divides
the experts it runs the expert-parallel `_moe_apply_ep`: a body of plain
tensor ops on each rank's shards (`local_map`), then one all-reduce of
the combined output over `model`.

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
from repro_torch.parallel.constrain import (_ambient_mesh, mesh_axes,
                                            placements, shard)


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
    """x: [B, S, d] -> [B, S, d].

    Takes the expert-parallel path on a mesh whose `model` axis (wider
    than 1) divides the experts: the global-scatter path below would
    make the tokens' buffers move across the mesh.  Both are
    differentiable and agree (tested)."""
    mesh = _ambient_mesh()
    if mesh is not None:
        sizes = mesh_axes(mesh)
        if ("model" in sizes and cfg.num_experts % sizes["model"] == 0
                and sizes["model"] > 1):
            return _moe_apply_ep(params, cfg, x, mesh)
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
    buf = shard(buf[:E * C].reshape(E, C, d), "model", None, None)

    # expert SwiGLU, batched over E
    h = (torch.nn.functional.silu(
        torch.einsum("ecd,edf->ecf", buf, params["experts_wg"].to(dt)))
         * torch.einsum("ecd,edf->ecf", buf, params["experts_wi"].to(dt)))
    h = shard(h, "model", None, None)
    out_slots = shard(torch.einsum("ecf,efd->ecd", h,
                                   params["experts_wo"].to(dt)),
                      "model", None, None)
    out_flat = out_slots.reshape(E * C, d)

    # combine: gather each token's k slots, weight by gates
    gathered = out_flat[torch.clamp(slot, max=E * C - 1).reshape(-1)
                        ].reshape(T, k, d)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=x.device))
    combined = torch.sum(gathered * gates[..., None].to(dt), dim=1)

    if cfg.num_shared_experts:
        combined = combined + L.swiglu_apply(params["shared"], xf)
    return combined.reshape(B, S, d)


def _moe_ep_body(cfg: ModelConfig, x_loc: torch.Tensor,
                 router: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                 wo: torch.Tensor, rank: int) -> torch.Tensor:
    """One model rank's share of the expert-parallel MoE: x_loc [T_loc, d]
    (the rank's batch rows; every model rank holds the same ones), the
    full router, and the rank's experts wi/wg [E_loc, d, ff], wo [E_loc,
    ff, d], experts rank*E_loc .. (rank+1)*E_loc - 1.  Returns the
    rank's partial output [T_loc, d]; the sum over the model ranks is
    the routed experts' output.

    Every expert shard already holds every token of its batch rows, so
    dispatch is a local select/scatter into [E_loc, C, d] and the one
    collective is the caller's all-reduce of the partials."""
    T_loc, d = x_loc.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    E_loc = wi.shape[0]
    dt = x_loc.dtype
    C = _capacity(cfg, T_loc)
    idx, gates = route(cfg, router, x_loc)                   # [T_loc, k]
    # position-in-expert over the GLOBAL expert ids (local tokens)
    pos, _, _ = _dispatch(idx, E, C)
    owned = torch.div(idx.long(), E_loc, rounding_mode="floor") == rank
    keep = (pos < C) & owned
    slot = torch.where(keep, (idx.long() % E_loc) * C + pos,
                       torch.full_like(pos, E_loc * C))
    src = x_loc[:, None, :].expand(T_loc, k, d).reshape(T_loc * k, d)
    buf = torch.zeros((E_loc * C + 1, d), dtype=dt, device=x_loc.device)
    buf.index_copy_(0, slot.reshape(-1), src)
    buf = buf[:E_loc * C].reshape(E_loc, C, d)
    h = (torch.nn.functional.silu(
        torch.einsum("ecd,edf->ecf", buf, wg.to(dt)))
         * torch.einsum("ecd,edf->ecf", buf, wi.to(dt)))
    out_slots = torch.einsum("ecf,efd->ecd", h,
                             wo.to(dt)).reshape(E_loc * C, d)
    gathered = out_slots[torch.clamp(slot, max=E_loc * C - 1).reshape(-1)
                         ].reshape(T_loc, k, d)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=x_loc.device))
    return torch.sum(gathered * gates[..., None].to(dt), dim=1)


def _moe_apply_ep(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  mesh) -> torch.Tensor:
    """Expert-parallel MoE on a mesh (x a DTensor, batch-sharded).

    `local_map` hands each rank its batch rows, the router whole and its
    experts (gathered over `data`, split over `model`); `_moe_ep_body`
    runs on those local tensors, its output is a partial sum over
    `model`, and one all-reduce over `model` completes it (2*T*d bytes
    on the wire, the Megatron-EP minimum)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.parallel.sharding import batch_axes

    B, S, d = x.shape
    b_axes = batch_axes(mesh)
    rank = mesh.get_local_rank("model")
    xf = x.reshape(B * S, d)
    tok = placements(mesh, (b_axes, None))
    out_pl = tuple(Partial() if n == "model" else p
                   for n, p in zip(mesh.mesh_dim_names, tok))
    expert = placements(mesh, ("model", None, None))
    rep = placements(mesh, ())
    body = local_map(
        lambda x_loc, router, wi, wg, wo: _moe_ep_body(
            cfg, x_loc, router, wi, wg, wo, rank),
        out_placements=list(out_pl),
        in_placements=(tok, rep, expert, expert, expert),
        device_mesh=mesh, redistribute_inputs=True)
    out = body(xf, params["router"], params["experts_wi"],
               params["experts_wg"], params["experts_wo"])
    # the one necessary EP collective: the partials' sum over `model`
    out = out.redistribute(mesh, tok)
    if cfg.num_shared_experts:
        out = out + L.swiglu_apply(params["shared"], xf)
    return out.reshape(B, S, d)


def load_balance_loss(cfg: ModelConfig, router: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction * prob per expert)."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1).float() @ router, dim=-1)
    idx = torch.argmax(probs, dim=-1)          # first maximum, as jnp
    frac = torch.nn.functional.one_hot(idx, cfg.num_experts).float().mean(0)
    return cfg.num_experts * torch.sum(frac * probs.mean(0))
