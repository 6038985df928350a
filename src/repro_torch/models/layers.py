"""Shared neural layers: init, RMSNorm, RoPE, chunked (flash-style)
attention, GQA/MQA and MLA attention blocks, SwiGLU FFN.

The port of `repro.models.layers`, as functions on
tensors over plain dict parameter trees with the reference's names (so a
reference tree carries across leaf for leaf, `transformer.params_from_numpy`).
The math mirrors the reference step for step: params in cfg.param_dtype,
matmuls in cfg.dtype, softmax and norms in float32, the same query
chunking and masks, and the same activation anchors
(`parallel.constrain.shard`, the identity outside a mesh of more than one
rank).  No Pallas kernel lies on this path, so attention stays plain
PyTorch ops (no fused attention: the reference has none).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.constrain import (_ambient_mesh, even, mesh_axes,
                                            placements, resolve, shard)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    return getattr(torch, name)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """[d_in, d_out] normal weights scaled by 1/sqrt(d_in), drawn in
    float32 from `gen` on its device, then cast."""
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, hd], positions broadcastable to [..., S]; rotates the
    last dim pairwise (angles in float32)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    positions = torch.atleast_1d(positions)
    angles = positions[..., None].float() * freqs            # [..., S, half]
    angles = angles[..., None, :]                               # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash-style attention (O(S * chunk) transient)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, chunk: int = 256,
                    t_valid: Optional[int] = None) -> torch.Tensor:
    """Query-chunked attention.

    q: [B, S, H, dk], k: [B, T, H, dk], v: [B, T, H, dv] (GQA callers
    repeat KV heads to H first, `repeat_kv`).  Returns [B, S, H, dv].
    Each chunk of `chunk` queries scores against every key (masked, not
    skipped) in float32, as the reference does.

    On a mesh of several ranks (DTensor operands) each rank attends its
    own batch rows and, when there are at least as many heads as the
    `model` axis is wide (`head_par`) and they divide evenly, its own
    heads: the layout the reference's anchors pin, run on the local
    shards (`local_map`).
    Fewer heads replicate (sharding the KV axis instead makes every
    chunk reduce [qc, T]-sized partials over `model`)."""
    H = q.shape[2]
    mesh = _ambient_mesh()
    model_sz = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    head_par = H >= model_sz
    attend = functools.partial(_attend, causal=causal, window=window,
                               q_offset=q_offset, chunk=chunk,
                               t_valid=t_valid)
    if mesh is not None and mesh.size() > 1 and hasattr(q, "placements"):
        from torch.distributed.tensor.experimental import local_map
        pl = placements(mesh, even(mesh, resolve(
            mesh, ("batch", None, "model" if head_par else None, None),
            q.shape), q.shape))
        return local_map(attend, out_placements=list(pl),
                         in_placements=(pl, pl, pl), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v)
    return attend(q, k, v)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, q_offset: int, chunk: int,
            t_valid: Optional[int]) -> torch.Tensor:
    """`flash_attention` on plain (local) tensors."""
    B, S, H, dk = q.shape
    T = k.shape[1]
    t_valid = T if t_valid is None else t_valid
    qc = min(chunk, S)
    nq = -(-S // qc)
    pad = nq * qc - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    kf, vf = k.float(), v.float()
    j_pos = torch.arange(T, device=q.device)
    inv = 1.0 / math.sqrt(dk)
    outs = []
    for ci in range(nq):
        i_pos = q_offset + ci * qc + torch.arange(qc, device=q.device)
        s = torch.einsum("bshd,bthd->bhst",
                         q[:, ci * qc:(ci + 1) * qc].float() * inv, kf)
        mask = j_pos[None, :] < t_valid
        if causal:
            mask = mask & (j_pos[None, :] <= i_pos[:, None])
        if window:
            mask = mask & (j_pos[None, :] > i_pos[:, None] - window)
        s = torch.where(mask[None, None], s, -torch.inf)
        # every query row has >= 1 valid key in all our uses (causal
        # includes self), so the softmax is NaN-free
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", p, vf))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out[:, :S].to(q.dtype)                       # [B,S,H,dv]


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, KV, hd] -> [B, T, KV*groups, hd] (GQA expansion)."""
    if groups == 1:
        return x
    B, T, KV, hd = x.shape
    x = x[:, :, :, None, :].expand(B, T, KV, groups, hd)
    return x.reshape(B, T, KV * groups, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     t_valid: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-position attention against a cache.

    q: [B, 1, KV, G, hd], k/v: [B, T, KV, hd]; t_valid: current length [B]
    or scalar (a tensor).  Full-row softmax (T scores per query)."""
    hd = q.shape[-1]
    T = k.shape[1]
    s = torch.einsum("bskgh,btkh->bkgst", q.float(),
                     k.float()) / math.sqrt(hd)
    j = torch.arange(T, device=q.device)
    tv = torch.as_tensor(t_valid, device=q.device)
    tv = tv[:, None] if tv.ndim == 1 else tv.reshape(1, 1)
    mask = j[None, :] < tv                                   # [B or 1, T]
    if window:
        mask = mask & (j[None, :] >= tv - window)
    s = torch.where(mask[:, None, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pdt = _pdt(cfg)
    return {
        "wq": dense_init(gen, d, H * hd, pdt),
        "wk": dense_init(gen, d, KV * hd, pdt),
        "wv": dense_init(gen, d, KV * hd, pdt),
        "wo": dense_init(gen, H * hd, d, pdt),
    }


def gqa_project_kv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    KV, hd = cfg.num_kv_heads, cfg.hd
    dt = _dt(cfg)
    k = (x @ params["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, KV, hd)
    return rope(k, positions, cfg.rope_theta), v


def gqa_project_q(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q = shard((x @ params["wq"].to(_dt(cfg))).reshape(B, S, H, hd),
              "batch", None, "model", None)
    return rope(q, positions, cfg.rope_theta)


def gqa_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              window: int = 0, causal: bool = True,
              kv_x: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Self- (or cross-, via kv_x) attention over a full sequence."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = _dt(cfg)
    src = x if kv_x is None else kv_x
    T = src.shape[1]
    q = shard((x @ params["wq"].to(dt)).reshape(B, S, H, hd),
              "batch", None, "model", None)
    k = shard((src @ params["wk"].to(dt)).reshape(B, T, KV, hd),
              "batch", None, "model", None)
    v = shard((src @ params["wv"].to(dt)).reshape(B, T, KV, hd),
              "batch", None, "model", None)
    if use_rope:
        q = rope(q, torch.arange(S, device=x.device), cfg.rope_theta)
        k = rope(k, torch.arange(T, device=x.device), cfg.rope_theta)
    o = flash_attention(q, repeat_kv(k, H // KV), repeat_kv(v, H // KV),
                        causal=causal, window=window, chunk=cfg.attn_chunk)
    return shard(o.reshape(B, S, H * hd) @ params["wo"].to(dt),
                 "batch", None, None)


# ---------------------------------------------------------------------------
# MLA attention block (MiniCPM3 / DeepSeek-V2 latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    qr, kvr, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    pdt = _pdt(cfg)
    return {
        "wq_down": dense_init(gen, d, qr, pdt),
        "q_norm": rmsnorm_init(qr, pdt, gen.device),
        "wq_up": dense_init(gen, qr, H * (hd + rd), pdt),
        "wkv_down": dense_init(gen, d, kvr + rd, pdt),
        "kv_norm": rmsnorm_init(kvr, pdt, gen.device),
        "wk_up": dense_init(gen, kvr, H * hd, pdt),
        "wv_up": dense_init(gen, kvr, H * hd, pdt),
        "wo": dense_init(gen, H * hd, d, pdt),
    }


def mla_latent(params: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed KV: (c_kv [B,S,kvr], k_rope [B,S,rd]), the decode cache."""
    kvr = cfg.kv_lora_rank
    down = x @ params["wkv_down"].to(_dt(cfg))
    c_kv = rmsnorm(params["kv_norm"], down[..., :kvr], cfg.norm_eps)
    k_rope = rope(down[..., kvr:][..., None, :],      # unit head axis
                  positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_queries(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, hd, rd = cfg.num_heads, cfg.hd, cfg.qk_rope_head_dim
    dt = _dt(cfg)
    cq = rmsnorm(params["q_norm"], x @ params["wq_down"].to(dt),
                 cfg.norm_eps)
    q = (cq @ params["wq_up"].to(dt)).reshape(B, S, H, hd + rd)
    return q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)


def mla_apply(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """Full-sequence MLA (prefill, forward): expand the latents and run
    attention with KV = H on concat(nope, rope) dims (dk = hd + rd,
    dv = hd)."""
    B, S, _ = x.shape
    H, hd, rd = cfg.num_heads, cfg.hd, cfg.qk_rope_head_dim
    dt = _dt(cfg)
    pos = torch.arange(S, device=x.device)
    c_kv, k_rope = mla_latent(params, cfg, x, pos)
    q_nope, q_rope = mla_queries(params, cfg, x, pos)
    k_nope = shard((c_kv @ params["wk_up"].to(dt)).reshape(B, S, H, hd),
                   "batch", None, "model", None)
    v = shard((c_kv @ params["wv_up"].to(dt)).reshape(B, S, H, hd),
              "batch", None, "model", None)
    q = torch.cat([q_nope, q_rope], dim=-1)                  # [B,S,H,hd+rd]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)],
                  dim=-1)
    o = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return shard(o.reshape(B, S, H * hd) @ params["wo"].to(dt),
                 "batch", None, None)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, cfg: ModelConfig,
                d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    pdt = _pdt(cfg)
    return {
        "wi": dense_init(gen, d, ff, pdt),
        "wg": dense_init(gen, d, ff, pdt),
        "wo": dense_init(gen, ff, d, pdt),
    }


def swiglu_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = (torch.nn.functional.silu(x @ params["wg"].to(dt))
         * (x @ params["wi"].to(dt)))
    if h.ndim == 3:
        h = shard(h, "batch", None, "model")
    out = h @ params["wo"].to(dt)
    return shard(out, *(["batch"] + [None] * (out.ndim - 1)))
