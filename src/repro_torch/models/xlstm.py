"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strict recurrence).

The port of `repro.models.xlstm`.  The mLSTM runs chunkwise-parallel for
the forward pass and prefill (within a chunk the stabilized quadratic
form, across chunks a carried (C, n, m) state); decode is the O(1)
recurrent step.  The sLSTM has hidden-to-hidden feedback (R @ h_{t-1})
and loops over time.  The reference wraps each mLSTM chunk in
`jax.checkpoint` to keep its backward residuals small; the port leaves
recomputation to the layer groups (`transformer._run_stack`, `cfg.remat`),
which gives the same values.  Stabilizer maxima use `torch.maximum` and
`torch.amax`, which, like JAX, split a tie's gradient evenly.  The
sLSTM's `jax.nn.gelu` is the tanh form.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLstmState(NamedTuple):
    C: torch.Tensor   # [B, H, hd, hd] matrix memory (f32)
    n: torch.Tensor   # [B, H, hd] normalizer
    m: torch.Tensor   # [B, H] stabilizer


def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = 2 * d                       # PF=2 up-projection (xLSTM paper)
    H = cfg.num_heads
    pdt = L.torch_dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "w_up": L.dense_init(gen, d, w, pdt),
        "w_gate": L.dense_init(gen, d, w, pdt),
        "wq": L.dense_init(gen, w, w, pdt),
        "wk": L.dense_init(gen, w, w, pdt),
        "wv": L.dense_init(gen, w, w, pdt),
        "w_if": L.dense_init(gen, w, 2 * H, torch.float32),
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           torch.full((H,), 3.0, device=dev)]),
        "norm": L.rmsnorm_init(w, pdt, dev),
        "w_down": L.dense_init(gen, w, d, pdt),
    }


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B, S, w] -> [B, H, S, w // H]."""
    B, S, w = x.shape
    return x.reshape(B, S, H, w // H).transpose(1, 2)


def _mlstm_qkvif(params: dict, cfg: ModelConfig, u: torch.Tensor):
    """u: [B, S, w] -> q,k,v [B,H,S,hd], i/f gate pre-acts [B,H,S]."""
    H = cfg.num_heads
    hd = u.shape[-1] // H
    dt = u.dtype
    q = _heads(u @ params["wq"].to(dt), H)
    k = _heads(u @ params["wk"].to(dt), H) / math.sqrt(hd)
    v = _heads(u @ params["wv"].to(dt), H)
    g = u.float() @ params["w_if"] + params["b_if"]               # [B,S,2H]
    i_pre = g[..., :H].transpose(1, 2)                            # [B,H,S]
    f_pre = g[..., H:].transpose(1, 2)
    return q, k, v, i_pre, f_pre


def _mlstm_chunk(carry, qq, kk, vv, ii, ff, tri):
    """One chunk of the chunkwise mLSTM: the chunk's hidden states
    [B,H,Lc,hd] and the state at its end."""
    C0, n0, m0 = carry
    Fc = torch.cumsum(ff, dim=-1)                                 # [B,H,Lc]
    A = m0[..., None] + Fc                                        # inter decay
    # intra log-weights W[t,j] = F_t - F_j + i_j   (j <= t)
    Wlog = Fc[..., :, None] - Fc[..., None, :] + ii[..., None, :]
    Wlog = torch.where(tri, Wlog, -torch.inf)
    m_t = torch.maximum(A, torch.amax(Wlog, dim=-1))              # [B,H,Lc]
    intra = torch.exp(Wlog - m_t[..., None])                      # [B,H,Lc,Lc]
    scores = torch.einsum("bhtd,bhjd->bhtj", qq, kk) * intra
    decay = torch.exp(A - m_t)
    h_num = (torch.einsum("bhtj,bhjd->bhtd", scores, vv)
             + decay[..., None] * torch.einsum("bhtd,bhde->bhte", qq, C0))
    n_t = (torch.sum(scores, dim=-1)
           + decay * torch.einsum("bhtd,bhd->bht", qq, n0))
    denom = torch.maximum(torch.abs(n_t), torch.exp(-m_t))
    h = h_num / denom[..., None]                                  # [B,H,Lc,hd]
    # state update to chunk end
    FL = Fc[..., -1:]                                             # [B,H,1]
    w_end = FL - Fc + ii                                          # [B,H,Lc]
    m1 = torch.maximum((m0[..., None] + FL)[..., 0],
                       torch.amax(w_end, dim=-1))                 # [B,H]
    upd = torch.exp(w_end - m1[..., None])                        # [B,H,Lc]
    carry_decay = torch.exp(m0 + FL[..., 0] - m1)
    C1 = (carry_decay[..., None, None] * C0
          + torch.einsum("bhj,bhjd,bhje->bhde", upd, kk, vv))
    n1 = (carry_decay[..., None] * n0
          + torch.einsum("bhj,bhjd->bhd", upd, kk))
    return (C1, n1, m1), h


def mlstm_chunkwise(params: dict, cfg: ModelConfig, u: torch.Tensor,
                    state: Optional[MLstmState] = None,
                    chunk: int = 256) -> Tuple[torch.Tensor, MLstmState]:
    """Chunkwise-parallel mLSTM. u: [B, S, w] -> ([B, S, w], final state)."""
    B, S, w = u.shape
    H = cfg.num_heads
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, cfg, u)
    logf = F.logsigmoid(f_pre)                                    # [B,H,S]

    Lc = min(chunk, S)
    S_orig = S
    pad = (-S) % Lc
    if pad:
        # padded steps contribute nothing: i = -1e30 (no write), logf = 0
        # (no decay), so the final state is exact.
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        i_pre = F.pad(i_pre, (0, pad), value=-1e30)
        logf = F.pad(logf, (0, pad))
        S = S + pad
    nc = S // Lc

    def chunks(x):
        return x.float().reshape(B, H, nc, Lc, *x.shape[3:]).unbind(2)

    if state is None:
        state = init_mlstm_state(cfg, B, w, device=u.device)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=u.device))
    carry = (state.C, state.n, state.m)
    hs = []
    for c_in in zip(*(chunks(x) for x in (q, k, v, i_pre, logf))):
        carry, h_c = _mlstm_chunk(carry, *c_in, tri)
        hs.append(h_c)
    h = torch.cat(hs, dim=2)                                      # [B,H,S,hd]
    h = h.transpose(1, 2).reshape(B, S, w).to(u.dtype)
    Cf, nf, mf = carry
    return h[:, :S_orig], MLstmState(C=Cf, n=nf, m=mf)


def mlstm_step(params: dict, cfg: ModelConfig, u_t: torch.Tensor,
               state: MLstmState) -> Tuple[torch.Tensor, MLstmState]:
    """One-token recurrent mLSTM. u_t: [B, w]."""
    B, w = u_t.shape
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, cfg, u_t[:, None, :])
    q, k, v = q[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float()
    i_pre, f_pre = i_pre[:, :, 0], f_pre[:, :, 0]                # [B,H]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state.m, i_pre)
    f_s = torch.exp(logf + state.m - m_new)[..., None]
    i_s = torch.exp(i_pre - m_new)[..., None]
    C = f_s[..., None] * state.C + i_s[..., None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f_s * state.n + i_s * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, w).to(u_t.dtype)
    return h, MLstmState(C=C, n=n, m=m_new)


def init_mlstm_state(cfg: ModelConfig, batch: int, w: int,
                     device=None) -> MLstmState:
    H = cfg.num_heads
    hd = w // H
    return MLstmState(
        C=torch.zeros((batch, H, hd, hd), device=device),
        n=torch.zeros((batch, H, hd), device=device),
        m=torch.full((batch, H), -1e30, device=device))


def mlstm_block_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, MLstmState]:
    """The block over a sequence and the state it ends in (the decode
    cache a prefill leaves)."""
    dt = x.dtype
    u = x @ params["w_up"].to(dt)
    gate = F.silu(x @ params["w_gate"].to(dt))
    h, state = mlstm_chunkwise(params, cfg, u, chunk=cfg.attn_chunk)
    h = L.rmsnorm(params["norm"], h, cfg.norm_eps)
    return (h * gate) @ params["w_down"].to(dt), state


def mlstm_block_apply(params: dict, cfg: ModelConfig,
                      x: torch.Tensor) -> torch.Tensor:
    return mlstm_block_prefill(params, cfg, x)[0]


def mlstm_block_step(params: dict, cfg: ModelConfig, x_t: torch.Tensor,
                     state: MLstmState) -> Tuple[torch.Tensor, MLstmState]:
    dt = x_t.dtype
    u = x_t @ params["w_up"].to(dt)
    gate = F.silu(x_t @ params["w_gate"].to(dt))
    h, new_state = mlstm_step(params, cfg, u, state)
    h = L.rmsnorm(params["norm"], h, cfg.norm_eps)
    return (h * gate) @ params["w_down"].to(dt), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLstmState(NamedTuple):
    h: torch.Tensor   # [B, w]
    c: torch.Tensor   # [B, w]
    n: torch.Tensor   # [B, w]
    m: torch.Tensor   # [B, w]


def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = d
    H = cfg.num_heads
    hd = w // H
    pdt = L.torch_dtype(cfg.param_dtype)
    dev = gen.device
    ffd = (int(w * 4 / 3) + 7) // 8 * 8
    zeros = torch.zeros((w,), device=dev)
    return {
        "w_x": L.dense_init(gen, d, 4 * w, pdt),
        # block-diagonal recurrent weights, one [hd, 4*hd] block per head
        "r_h": torch.randn((H, hd, 4 * hd), generator=gen, device=dev)
        / math.sqrt(hd),
        "bias": torch.cat([zeros, zeros, torch.full((w,), 3.0, device=dev),
                           zeros]),
        "norm": L.rmsnorm_init(w, pdt, dev),
        "w_up1": L.dense_init(gen, w, ffd, pdt),
        "w_up2": L.dense_init(gen, w, ffd, pdt),
        "w_down": L.dense_init(gen, ffd, d, pdt),
    }


def _slstm_cell(params: dict, H: int, xw_t: torch.Tensor,
                st: SLstmState) -> SLstmState:
    """xw_t: [B, 4w] precomputed input projection at step t (f32)."""
    B, w4 = xw_t.shape
    w = w4 // 4
    hb = st.h.reshape(B, H, w // H)
    rec = torch.einsum("bhd,hde->bhe", hb, params["r_h"]).reshape(B, w4)
    pre = xw_t + rec + params["bias"]
    z_pre, i_pre, f_pre, o_pre = torch.split(pre, w, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st.m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + st.m - m_new)
    c = f_s * st.c + i_s * z
    n = f_s * st.n + i_s
    h = o * c / torch.clamp(n, min=1e-6)
    return SLstmState(h=h, c=c, n=n, m=m_new)


def slstm_scan(params: dict, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[SLstmState] = None
               ) -> Tuple[torch.Tensor, SLstmState]:
    """x: [B, S, d] -> hidden sequence [B, S, w]. Strictly sequential."""
    B, S, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    xw = (x @ params["w_x"].to(x.dtype)).float()
    hs = []
    for t in range(S):
        state = _slstm_cell(params, cfg.num_heads, xw[:, t], state)
        hs.append(state.h)
    return torch.stack(hs, dim=1).to(x.dtype), state


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device=None) -> SLstmState:
    w = cfg.d_model
    z = torch.zeros((batch, w), device=device)
    return SLstmState(h=z, c=z, n=z,
                      m=torch.full((batch, w), -1e30, device=device))


def _slstm_ffn(params: dict, cfg: ModelConfig, h: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """The sLSTM block's gated up/down projection of its hidden."""
    h = L.rmsnorm(params["norm"], h, cfg.norm_eps)
    up = (h @ params["w_up1"].to(dt)) * F.gelu(
        h @ params["w_up2"].to(dt), approximate="tanh")
    return up @ params["w_down"].to(dt)


def slstm_block_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, SLstmState]:
    """The block over a sequence and the state it ends in (the decode
    cache a prefill leaves)."""
    h, state = slstm_scan(params, cfg, x)
    return _slstm_ffn(params, cfg, h, x.dtype), state


def slstm_block_apply(params: dict, cfg: ModelConfig,
                      x: torch.Tensor) -> torch.Tensor:
    return slstm_block_prefill(params, cfg, x)[0]


def slstm_block_step(params: dict, cfg: ModelConfig, x_t: torch.Tensor,
                     state: SLstmState) -> Tuple[torch.Tensor, SLstmState]:
    xw = (x_t @ params["w_x"].to(x_t.dtype)).float()
    new = _slstm_cell(params, cfg.num_heads, xw, state)
    return _slstm_ffn(params, cfg, new.h.to(x_t.dtype), x_t.dtype), new
