"""starcoder2-3b [dense] — 30L d3072 24H (GQA kv=2) ff12288 vocab49152,
GQA + RoPE, LayerNorm + non-gated GELU MLP with biases. [arXiv:2402.19173]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152,
    act="gelu_tanh", gated_mlp=False, norm="layer", norm_eps=1e-5,
    qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    rope=True, rope_theta=999999.4, tie_embeddings=True,
)
