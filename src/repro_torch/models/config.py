"""Model configuration — one dataclass covers all ten assigned families.

A config fully determines parameter shapes, the block pattern, the serving
cache layout, and the analytic parameter counts.  A copy of
`repro.models.config` (field for field); the port runs only the dense
GQA family so far (`check_supported`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention ----------------------------------------------------------
    attention: str = "gqa"           # gqa | mla
    head_dim: Optional[int] = None   # default d_model // num_heads
    window: int = 0                  # sliding-window size (local attention)
    rope_theta: float = 10_000.0

    # MLA (multi-head latent attention, MiniCPM3/DeepSeek-V2 style) -------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 32

    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # hybrid / ssm ---------------------------------------------------------
    # block pattern, repeated to num_layers; entries: "attn", "local",
    # "rglru", "mlstm", "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    lru_width: int = 0               # RG-LRU recurrence width (0 = d_model)
    conv_width: int = 4              # temporal conv in recurrent blocks

    # encoder-decoder ------------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper frame count (stub frontend)

    # frontend stubs -------------------------------------------------------
    frontend: str = "none"           # none | patches | frames
    num_patches: int = 576           # llava anyres stub

    # numerics / runtime ---------------------------------------------------
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 256            # flash-attention kv-chunk size
    remat: bool = True
    scan_layers: bool = True

    # ----------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return tuple(self.block_pattern)

    @property
    def group_size(self) -> int:
        """Layers per scan step (len of block pattern)."""
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, \
            f"{self.name}: num_layers % pattern length != 0"
        return self.num_layers // self.group_size

    @property
    def sub_quadratic(self) -> bool:
        """True if serve memory/time per token is O(1) in context length —
        the long_500k eligibility rule (DESIGN.md §4.1)."""
        return all(b in ("rglru", "mlstm", "slstm", "local")
                   for b in self.pattern)

    # ---- analytic counts (roofline cross-checks) -------------------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        H, KV = self.num_heads, self.num_kv_heads
        n = 0
        # embeddings
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        def attn_params() -> int:
            if self.attention == "mla":
                qr, kvr, rd = self.q_lora_rank, self.kv_lora_rank, self.qk_rope_head_dim
                p = d * qr + qr * H * (hd + rd)        # q down/up (+rope dim)
                p += d * (kvr + rd)                     # kv down + shared rope
                p += kvr * H * (hd + hd)                # k_up, v_up
                p += H * hd * d                         # out
                return p
            return d * H * hd + 2 * d * KV * hd + H * hd * d
        def ffn_params() -> int:
            return 3 * d * self.d_ff                    # swiglu
        def moe_params() -> int:
            e_ff = self.d_ff
            p = self.num_experts * 3 * d * e_ff
            p += self.num_shared_experts * 3 * d * e_ff
            p += d * self.num_experts                   # router
            return p
        def rglru_params() -> int:
            w = self.lru_width or d
            return 2 * d * w + w * d + 3 * w + self.conv_width * w + 3 * d * self.d_ff
        def xlstm_params(kind: str) -> int:
            # qkv + gates + out + (up/down proj factor ~2.7x) rough but exact
            # numbers come from init shapes; used only for roofline sanity.
            return 4 * d * d + 3 * d + 2 * int(2.7 * d) * d
        per_block = {
            "attn": attn_params() + (moe_params() if self.num_experts else ffn_params()),
            "local": attn_params() + (moe_params() if self.num_experts else ffn_params()),
            "rglru": rglru_params(),
            "mlstm": xlstm_params("m"),
            "slstm": xlstm_params("s"),
        }
        for g in range(self.num_layers):
            n += per_block[self.pattern[g % self.group_size]]
        if self.is_encoder_decoder:
            # encoder layers: attn + ffn, plus decoder cross-attn already in
            # num_layers accounting? encoder counted separately:
            n += self.encoder_layers * (attn_params() + ffn_params())
            n += self.num_layers * attn_params()        # cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        e_ff = self.d_ff
        total = self.param_count()
        inactive = (self.num_experts - self.experts_per_token)
        return total - self.num_layers * inactive * 3 * d * e_ff


# families and attention kinds the port does not run yet, each with the
# ROADMAP.md item (queue 1, item 17) that ports it
_NOT_PORTED = {
    "moe": "17b (MoE)",
    "hybrid": "17c (RG-LRU, with 17a's local attention)",
    "ssm": "17d (xLSTM)",
    "audio": "17e (whisper frontend, with 17a's cross attention)",
    "vlm": "17e (llava frontend)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, unless `cfg`
    is a dense GQA model with only global attention blocks — the one
    family the port runs (never a wrong path for the others)."""
    item = _NOT_PORTED.get(cfg.family)
    if item is None and cfg.family != "dense":
        item = "17 (an unknown family)"
    if item is None and cfg.attention != "gqa":
        item = "17a (MLA attention)"
    if item is None and (set(cfg.pattern) != {"attn"} or cfg.window
                         or cfg.num_experts or cfg.is_encoder_decoder
                         or cfg.frontend != "none"):
        item = "17a (local, MLA and cross attention)"
    if item is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} "
            f"attention is not ported yet (ROADMAP.md item {item})")
