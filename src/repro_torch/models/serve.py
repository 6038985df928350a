"""Serving path: attention KV caches, prefill, and single-token decode.

The port of `repro.models.serve` for the dense GQA family.  Cache layout
(every leaf carries a leading [G] = num_groups axis, so the decode step
loops over groups exactly as `transformer.forward` does):

  gqa   : k, v            [G, B, T, KV, hd]     (keys stored post-RoPE)

`pos` is a device tensor (int32 scalar), so a decode step needs no host
read of the position.  The local (ring-buffer), MLA, cross-attention and
recurrent caches wait for their families (ROADMAP.md item 17).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.ring import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig, check_supported

Tree = Dict


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, T_max: int, *,
               device=None) -> Tree:
    """Zero caches for a batch of B sequences of up to T_max positions."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = L.torch_dtype(cfg.dtype)
    shape = (cfg.num_groups, B, T_max, cfg.num_kv_heads, cfg.hd)
    blocks = {f"b{i}": {"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}
              for i in range(cfg.group_size)}
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "blocks": blocks}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _write_pos(buf: torch.Tensor, update: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """A copy of buf [B, T, ...] with update [B, 1, ...] at position pos
    along axis 1 (the reference's dynamic_update_slice)."""
    return buf.index_copy(1, pos.reshape(1).long(), update)


def _gqa_step(p: Tree, cfg: ModelConfig, x_t: torch.Tensor, cache: Tree,
              pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """x_t: [B, d] (already normed).  Returns attn output + updated cache."""
    B, _ = x_t.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x_t.dtype
    posb = pos[None]                                        # [1] -> bcast S=1
    q = L.rope((x_t @ p["wq"].to(dt)).reshape(B, 1, H, hd), posb,
               cfg.rope_theta)
    k_t = L.rope((x_t @ p["wk"].to(dt)).reshape(B, 1, KV, hd), posb,
                 cfg.rope_theta)
    v_t = (x_t @ p["wv"].to(dt)).reshape(B, 1, KV, hd)
    k = _write_pos(cache["k"], k_t, pos)
    v = _write_pos(cache["v"], v_t, pos)
    o = L.decode_attention(q.reshape(B, 1, KV, H // KV, hd), k, v,
                           t_valid=pos + 1)
    o = o.reshape(B, H * hd) @ p["wo"].to(dt)
    return o, {**cache, "k": k, "v": v}


def _block_step(cfg: ModelConfig, p: Tree, x_t: torch.Tensor, cache: Tree,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    h = L.rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    o, cache = _gqa_step(p["attn"], cfg, h, cache, pos)
    x_t = x_t + o
    h = L.rmsnorm(p["ln2"], x_t, cfg.norm_eps)
    return x_t + L.swiglu_apply(p["ffn"], h), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Tree, cache: Tree,
                token: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """One new token against the cache.  token: [B] integer -> logits
    [B, V] and the new cache (the given one is not modified)."""
    check_supported(cfg)
    pos = cache["pos"]
    x_t = TR.embed(cfg, params, token)
    outs = []
    for g, gp in enumerate(TR.iter_groups(cfg, params["groups"])):
        new_gc = {}
        for i in range(cfg.group_size):
            gc = TR.group_params(cache["blocks"][f"b{i}"], g)
            x_t, new_gc[f"b{i}"] = _block_step(cfg, gp[f"b{i}"], x_t, gc,
                                               pos)
        outs.append(new_gc)
    x_t = L.rmsnorm(params["final_norm"], x_t, cfg.norm_eps)
    logits = TR.unembed(cfg, params, x_t)
    return logits, {"pos": pos + 1, "blocks": TR.stack_trees(outs)}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                   T_max: int) -> Tuple[torch.Tensor, Tree]:
    """Full-sequence block application that also emits its decode cache."""
    B, S, _ = x.shape
    dt = x.dtype
    KV, hd, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    pos = torch.arange(S, device=x.device)
    k, v = L.gqa_project_kv(p["attn"], cfg, h, pos)
    q = L.gqa_project_q(p["attn"], cfg, h, pos)
    G = H // KV
    o = L.flash_attention(q, L.repeat_kv(k, G), L.repeat_kv(v, G),
                          causal=True, chunk=cfg.attn_chunk)
    x = x + o.reshape(B, S, H * hd) @ p["attn"]["wo"].to(dt)
    pad = (0, 0, 0, 0, 0, T_max - S)
    cache = {"k": torch.nn.functional.pad(k, pad),
             "v": torch.nn.functional.pad(v, pad)}
    h3 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.swiglu_apply(p["ffn"], h3), cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
            T_max: Optional[int] = None) -> Tuple[torch.Tensor, Tree]:
    """Process a prompt, returning (last-position logits [B, V], cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    _, S = tokens.shape
    T_max = T_max or S
    x = TR.embed(cfg, params, tokens)
    outs = []
    for gp in TR.iter_groups(cfg, params["groups"]):
        gc = {}
        for i in range(cfg.group_size):
            x, gc[f"b{i}"] = _block_prefill(cfg, gp[f"b{i}"], x, T_max)
        outs.append(gc)
    x = L.rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    logits = TR.unembed(cfg, params, x)
    return logits, {"pos": torch.tensor(S, dtype=torch.int32,
                                        device=tokens.device),
                    "blocks": TR.stack_trees(outs)}
