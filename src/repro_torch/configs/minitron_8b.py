"""minitron-8b [dense]: 32L d=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Width/depth-pruned Nemotron-4. The 256k vocab makes the unembed matmul and
embedding table the sharding-sensitive pieces (vocab on `model` axis).
[arXiv:2407.14679; hf]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minitron-smoke", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=512,
        param_dtype="float32", dtype="float32", attn_chunk=16)
