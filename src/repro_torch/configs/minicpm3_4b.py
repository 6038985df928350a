"""minicpm3-4b [dense]: 62L d=2560 40H (GQA kv=40) d_ff=6400 vocab=73448.

Multi-head Latent Attention (MLA): KV is cached as a rank-256 latent + a
shared 32-dim rope key, shrinking decode cache ~20x vs full MHA.
[hf:openbmb/MiniCPM3-4B; hf]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attention="mla", head_dim=64,
    q_lora_rank=768, kv_lora_rank=256, qk_rope_head_dim=32,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        head_dim=16, q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
        param_dtype="float32", dtype="float32", attn_chunk=16)
