"""qwen1.5-0.5b [dense] — 24L d1024 16H (GQA kv=16) ff2816 vocab151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936,
    act="silu", gated_mlp=True, norm="rms", qkv_bias=True,
    rope=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
