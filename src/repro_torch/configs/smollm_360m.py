"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model; also the backbone of the end-to-end train
example (examples/train_lm.py uses reduced()).
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", num_layers=2, d_model=60,
        num_heads=3, num_kv_heads=1, d_ff=160, vocab_size=512,
        param_dtype="float32", dtype="float32", attn_chunk=16)


def train_100m() -> ModelConfig:
    """~100M-param variant for the end-to-end training driver."""
    return dataclasses.replace(
        CONFIG, name="smollm-100m", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=5, d_ff=1706, vocab_size=32000,
        param_dtype="float32", dtype="float32")
