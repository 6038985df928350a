"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Transformer backbone only; the anyres vision tower is a STUB — input specs
provide precomputed patch embeddings [B, 576, d] that replace the first 576
token positions (multimodal fusion stub, DESIGN.md §4).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    frontend="patches", num_patches=576,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-next-smoke", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=256,
        num_patches=4, param_dtype="float32", dtype="float32",
        attn_chunk=16)
