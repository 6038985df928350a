"""deepseek-moe-16b [moe]: 28L d=2048 16H d_ff=1408(per expert)
vocab=102400, 2 shared + 64 routed experts top-6 (fine-grained).
[arXiv:2401.06066; hf]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    num_experts=64, num_shared_experts=2, experts_per_token=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=32, vocab_size=512,
        num_experts=8, num_shared_experts=1, experts_per_token=2,
        # no-drop capacity so decode == forward exactly in smoke tests
        capacity_factor=8.0,
        param_dtype="float32", dtype="float32", attn_chunk=16)
