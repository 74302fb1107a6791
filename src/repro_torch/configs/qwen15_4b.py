"""qwen1.5-4b [dense] — 40L d2560 20H (GQA kv=20) ff6912 vocab151936,
QKV bias, untied LM head. [hf:Qwen/Qwen1.5-4B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    act="silu", gated_mlp=True, norm="rms", qkv_bias=True,
    rope=True, rope_theta=1_000_000.0, tie_embeddings=False,
)
