"""Serving path: KV/state caches, prefill, and single-token decode.

The port of `repro.models.serve`.  Cache layouts (every leaf carries a
leading [G] = num_groups axis, so the decode step loops over groups
exactly as `transformer.forward` does):

  gqa   : k, v            [G, B, T, KV, hd]     (keys stored post-RoPE)
  mla   : ckv             [G, B, T, kvr]        latent
          krope           [G, B, T, rd]
  local : k, v            [G, B, W, KV, hd]     ring buffer, W = window
  cross : ck, cv          [G, B, F, KV, hd]     whisper encoder K/V (static)
  rglru : conv [G,B,cw-1,w], h [G,B,w] (float32)
  mlstm : C [G,B,H,hd,hd], n [G,B,H,hd], m [G,B,H]   (float32)
  slstm : h/c/n/m         [G, B, w]                  (float32)

The stabilizers `m` start at -1e30.  `pos` is a device tensor (int32
scalar), so a decode step needs no host read of the position.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.ring import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as TR
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.parallel.constrain import gather_weights, on_mesh

Tree = Dict


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, B: int, T: int,
                 dt: torch.dtype) -> Dict[str, tuple]:
    """The (shape, dtype) of each of a block's cache leaves, and the
    fill value where it is not 0."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    if kind == "attn":
        if cfg.attention == "mla":
            c = {"ckv": ((B, T, cfg.kv_lora_rank), dt),
                 "krope": ((B, T, cfg.qk_rope_head_dim), dt)}
        else:
            c = {"k": ((B, T, KV, hd), dt), "v": ((B, T, KV, hd), dt)}
        if cfg.is_encoder_decoder:
            c["ck"] = ((B, cfg.encoder_seq, KV, hd), dt)
            c["cv"] = ((B, cfg.encoder_seq, KV, hd), dt)
        return c
    if kind == "local":
        W = cfg.window
        return {"k": ((B, W, KV, hd), dt), "v": ((B, W, KV, hd), dt)}
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"conv": ((B, cfg.conv_width - 1, w), dt),
                "h": ((B, w), torch.float32)}
    f32 = torch.float32
    if kind == "mlstm":
        H = cfg.num_heads
        hd = 2 * cfg.d_model // H
        return {"C": ((B, H, hd, hd), f32), "n": ((B, H, hd), f32),
                "m": ((B, H), f32, -1e30)}
    if kind == "slstm":
        w = cfg.d_model
        return {"h": ((B, w), f32), "c": ((B, w), f32), "n": ((B, w), f32),
                "m": ((B, w), f32, -1e30)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, B: int, T_max: int, *,
               device=None) -> Tree:
    """Zero caches for a batch of B sequences of up to T_max positions."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = L.torch_dtype(cfg.dtype)
    G = cfg.num_groups
    blocks = {
        f"b{i}": {name: torch.full((G, *shape), fill[0] if fill else 0,
                                   dtype=ldt, device=device)
                  for name, (shape, ldt, *fill) in
                  _block_cache(cfg, kind, B, T_max, dt).items()}
        for i, kind in enumerate(cfg.pattern)}
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "blocks": blocks}


# ---------------------------------------------------------------------------
# per-kind decode steps
# ---------------------------------------------------------------------------

def _write_pos(buf: torch.Tensor, update: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """A copy of buf [B, T, ...] with update [B, 1, ...] at position pos
    along axis 1 (the reference's dynamic_update_slice).  On a mesh of
    several ranks, a select against the position (DTensor shards no
    `index_copy` on every torch)."""
    if on_mesh():
        at = torch.arange(buf.shape[1], device=buf.device) == pos
        return torch.where(at.reshape((1, -1) + (1,) * (buf.dim() - 2)),
                           update, buf)
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


def _local_step(p: Tree, cfg: ModelConfig, x_t: torch.Tensor, cache: Tree,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """Ring-buffer sliding-window attention step (W slots)."""
    B, _ = x_t.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    W = cfg.window
    dt = x_t.dtype
    posb = pos[None]
    slot = torch.remainder(pos, W)
    q = L.rope((x_t @ p["wq"].to(dt)).reshape(B, 1, H, hd), posb,
               cfg.rope_theta)
    k_t = L.rope((x_t @ p["wk"].to(dt)).reshape(B, 1, KV, hd), posb,
                 cfg.rope_theta)
    v_t = (x_t @ p["wv"].to(dt)).reshape(B, 1, KV, hd)
    k = _write_pos(cache["k"], k_t, slot)
    v = _write_pos(cache["v"], v_t, slot)
    # slot j holds absolute position pos - ((slot - j) mod W); valid if >= 0
    j = torch.arange(W, device=x_t.device)
    mask = (pos - torch.remainder(slot - j, W)) >= 0          # [W]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                     k.float()) / math.sqrt(hd)
    s = torch.where(mask[None, None, None, None, :], s, -torch.inf)
    pw = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", pw, v.float())
    o = o.to(dt).reshape(B, H * hd) @ p["wo"].to(dt)
    return o, {**cache, "k": k, "v": v}


def _mla_step(p: Tree, cfg: ModelConfig, x_t: torch.Tensor, cache: Tree,
              pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """Latent-space MLA decode (never expands the KV cache)."""
    B, _ = x_t.shape
    H, hd, rd = cfg.num_heads, cfg.hd, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    dt = x_t.dtype
    posb = pos[None]
    c_kv_t, k_rope_t = L.mla_latent(p, cfg, x_t[:, None, :], posb)
    q_nope, q_rope = L.mla_queries(p, cfg, x_t[:, None, :], posb)
    ckv = _write_pos(cache["ckv"], c_kv_t, pos)
    krope = _write_pos(cache["krope"], k_rope_t, pos)
    # absorb wk_up into the query (in cfg.dtype, as the reference):
    # q_lat[h] = q_nope[h] @ wk_up[:, h, :]^T
    wk_up = p["wk_up"].to(dt).reshape(kvr, H, hd)
    q_lat = torch.einsum("bhd,khd->bhk", q_nope[:, 0], wk_up)  # [B,H,kvr]
    s = (torch.einsum("bhk,btk->bht", q_lat.float(), ckv.float())
         + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(),
                        krope.float())) / math.sqrt(hd + rd)
    mask = torch.arange(ckv.shape[1], device=x_t.device) < pos + 1
    s = torch.where(mask[None, None, :], s, -torch.inf)
    pw = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bht,btk->bhk", pw, ckv.float())       # latent ctx
    wv_up = p["wv_up"].to(dt).reshape(kvr, H, hd)
    o = torch.einsum("bhk,khd->bhd", ctx.to(dt), wv_up)
    o = o.reshape(B, H * hd) @ p["wo"].to(dt)
    return o, {**cache, "ckv": ckv, "krope": krope}


def _cross_step(p: Tree, cfg: ModelConfig, x_t: torch.Tensor,
                cache: Tree) -> torch.Tensor:
    """Cross-attention against the cached encoder K/V."""
    B, _ = x_t.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x_t.dtype
    q = (x_t @ p["wq"].to(dt)).reshape(B, 1, KV, H // KV, hd)
    o = L.decode_attention(q, cache["ck"], cache["cv"],
                           t_valid=cache["ck"].shape[1])
    return o.reshape(B, H * hd) @ p["wo"].to(dt)


def _block_step(cfg: ModelConfig, kind: str, p: Tree, x_t: torch.Tensor,
                cache: Tree, pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    h = L.rmsnorm(p["ln1"], x_t, cfg.norm_eps)
    if kind in ("attn", "local"):
        if kind == "local":
            o, cache = _local_step(p["attn"], cfg, h, cache, pos)
        elif cfg.attention == "mla":
            o, cache = _mla_step(p["attn"], cfg, h, cache, pos)
        else:
            o, cache = _gqa_step(p["attn"], cfg, h, cache, pos)
        x_t = x_t + o
        if cfg.is_encoder_decoder:
            h = L.rmsnorm(p["ln_cross"], x_t, cfg.norm_eps)
            x_t = x_t + _cross_step(p["cross"], cfg, h, cache)
        h = L.rmsnorm(p["ln2"], x_t, cfg.norm_eps)
        if cfg.num_experts:
            x_t = x_t + MOE.moe_apply(p["moe"], cfg, h[:, None, :])[:, 0]
        else:
            x_t = x_t + L.swiglu_apply(p["ffn"], h)
    elif kind == "rglru":
        st = RG.RecurrentState(conv=cache["conv"], h=cache["h"])
        o, st = RG.block_step(p["rec"], cfg, h, st)
        cache = {"conv": st.conv, "h": st.h}
        x_t = x_t + o
        h = L.rmsnorm(p["ln2"], x_t, cfg.norm_eps)
        x_t = x_t + L.swiglu_apply(p["ffn"], h)
    elif kind == "mlstm":
        o, st = X.mlstm_block_step(p["cell"], cfg, h, X.MLstmState(**cache))
        x_t, cache = x_t + o, st._asdict()
    elif kind == "slstm":
        o, st = X.slstm_block_step(p["cell"], cfg, h, X.SLstmState(**cache))
        x_t, cache = x_t + o, st._asdict()
    else:
        raise ValueError(kind)
    return x_t, cache


# ---------------------------------------------------------------------------
# public: decode_step / prefill
# ---------------------------------------------------------------------------

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
        gp = gather_weights(gp)
        new_gc = {}
        for i, kind in enumerate(cfg.pattern):
            gc = TR.group_params(cache["blocks"][f"b{i}"], g)
            x_t, new_gc[f"b{i}"] = _block_step(cfg, kind, gp[f"b{i}"], x_t,
                                               gc, pos)
        outs.append(new_gc)
    x_t = L.rmsnorm(params["final_norm"], x_t, cfg.norm_eps)
    logits = TR.unembed(cfg, params, x_t)
    return logits, {"pos": pos + 1, "blocks": TR.stack_trees(outs)}


def _local_window(t: torch.Tensor, W: int) -> torch.Tensor:
    """The ring-buffer layout of the last W positions of t [B, S, ...]:
    slot j holds the position p with p % W == j (zeros where S < W)."""
    S = t.shape[1]
    if S >= W:
        # position S - W + i lands in slot (S - W + i) % W = (i + S) % W
        return torch.roll(t[:, S - W:], shifts=S % W, dims=1)
    pad = [0, 0] * (t.dim() - 2) + [0, W - S]
    return torch.nn.functional.pad(t, pad)


def _block_prefill(cfg: ModelConfig, kind: str, p: Tree, x: torch.Tensor,
                   T_max: int, enc_out: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Tree]:
    """Full-sequence block application that also emits its decode cache."""
    B, S, _ = x.shape
    dt = x.dtype
    KV, hd, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    pos = torch.arange(S, device=x.device)
    cache: Tree = {}
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        if cfg.attention == "mla":
            c_kv, k_rope = L.mla_latent(p["attn"], cfg, h, pos)
            pad = (0, 0, 0, T_max - S)
            cache["ckv"] = torch.nn.functional.pad(c_kv, pad)
            cache["krope"] = torch.nn.functional.pad(k_rope, pad)
            x = x + L.mla_apply(p["attn"], cfg, h)
        else:
            k, v = L.gqa_project_kv(p["attn"], cfg, h, pos)
            q = L.gqa_project_q(p["attn"], cfg, h, pos)
            G = H // KV
            o = L.flash_attention(q, L.repeat_kv(k, G), L.repeat_kv(v, G),
                                  causal=True, window=window,
                                  chunk=cfg.attn_chunk)
            x = x + o.reshape(B, S, H * hd) @ p["attn"]["wo"].to(dt)
            if kind == "local":
                cache["k"] = _local_window(k, cfg.window)
                cache["v"] = _local_window(v, cfg.window)
            else:
                pad = (0, 0, 0, 0, 0, T_max - S)
                cache["k"] = torch.nn.functional.pad(k, pad)
                cache["v"] = torch.nn.functional.pad(v, pad)
        if cfg.is_encoder_decoder:
            h2 = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
            x = x + L.gqa_apply(p["cross"], cfg, h2, causal=False,
                                kv_x=enc_out, use_rope=False)
            F = enc_out.shape[1]
            cache["ck"] = (enc_out @ p["cross"]["wk"].to(dt)).reshape(
                B, F, KV, hd)
            cache["cv"] = (enc_out @ p["cross"]["wv"].to(dt)).reshape(
                B, F, KV, hd)
        h3 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if cfg.num_experts:
            x = x + MOE.moe_apply(p["moe"], cfg, h3)
        else:
            x = x + L.swiglu_apply(p["ffn"], h3)
    elif kind == "rglru":
        rec = p["rec"]
        gate = RG.gelu(h @ rec["w_gate"].to(dt))
        u = h @ rec["w_in"].to(dt)
        hh = RG.rglru_scan(rec, RG._conv_causal(rec, u, cfg))
        x = x + (gate * hh) @ rec["w_out"].to(dt)
        cw = cfg.conv_width
        cache["conv"] = (u[:, S - (cw - 1):S] if S >= cw - 1 else
                         torch.nn.functional.pad(u, (0, 0, cw - 1 - S, 0)))
        cache["h"] = hh[:, -1].float()
        h4 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu_apply(p["ffn"], h4)
    elif kind in ("mlstm", "slstm"):
        prefill = (X.mlstm_block_prefill if kind == "mlstm"
                   else X.slstm_block_prefill)
        y, st = prefill(p["cell"], cfg, h)
        x = x + y
        cache = st._asdict()
    else:
        raise ValueError(kind)
    return x, cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
            T_max: Optional[int] = None) -> Tuple[torch.Tensor, Tree]:
    """Process a prompt, returning (last-position logits [B, V], cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    _, S = tokens.shape
    T_max = T_max or S
    x = TR.embed_inputs(cfg, params, batch)
    enc_out = (TR._encode(cfg, params, batch["frames"])
               if cfg.is_encoder_decoder else None)
    outs = []
    for gp in TR.iter_groups(cfg, params["groups"]):
        gp = gather_weights(gp)
        gc = {}
        for i, kind in enumerate(cfg.pattern):
            x, gc[f"b{i}"] = _block_prefill(cfg, kind, gp[f"b{i}"], x,
                                            T_max, enc_out)
        outs.append(gc)
    x = L.rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    logits = TR.unembed(cfg, params, x)
    return logits, {"pos": torch.tensor(S, dtype=torch.int32,
                                        device=tokens.device),
                    "blocks": TR.stack_trees(outs)}
