"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) d_ff=768(per expert)
vocab=151936, 128 routed experts top-8, no shared experts.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936,
    head_dim=128,
    num_experts=128, num_shared_experts=0, experts_per_token=8,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=512,
        head_dim=16, num_experts=8, num_shared_experts=0,
        # no-drop capacity so decode == forward exactly in smoke tests
        experts_per_token=2, capacity_factor=8.0,
        param_dtype="float32", dtype="float32", attn_chunk=16)
