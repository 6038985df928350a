"""recurrentgemma-9b [hybrid]: 38L... pattern note below. d=4096 16H (MQA
kv=1) d_ff=12288 vocab=256000. RG-LRU + local attention, 1:2 ratio.

The assigned 38 layers do not divide by the 3-layer (rglru, rglru, local)
Griffin pattern; we follow the paper's pattern exactly and round the depth
to 39 layers (13 groups) — noted in DESIGN.md §7.  Window = 2048 (paper).

This arch RUNS long_500k: decode state is O(window + lru_width), not O(S).
[arXiv:2402.19427; unverified]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=39, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=4096,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=512,
        window=16, lru_width=64, param_dtype="float32", dtype="float32",
        attn_chunk=16)
