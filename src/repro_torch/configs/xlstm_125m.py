"""xlstm-125m [ssm]: 12L d=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks
(1:1 alternating; the blocks carry their own up/down projections, hence
d_ff=0).  RUNS long_500k: decode state is a constant-size matrix memory.
[arXiv:2405.04517; unverified]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", num_layers=2, d_model=32,
        num_heads=4, num_kv_heads=4, vocab_size=256,
        param_dtype="float32", dtype="float32", attn_chunk=8)
