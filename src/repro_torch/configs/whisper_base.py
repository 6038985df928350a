"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865.

Encoder-decoder; the conv frontend is a STUB — input specs provide
precomputed frame embeddings [B, 1500, d] (post-conv mel frames).
Decode shapes exercise self- + cross-attention KV caches.
[arXiv:2212.04356; unverified]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=6, encoder_seq=1500,
    frontend="frames",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        encoder_layers=2, encoder_seq=16, param_dtype="float32",
        dtype="float32", attn_chunk=16)
