"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) ff36864 vocab256000,
local+global alternating (4096 window), logit softcaps. [arXiv:2408.00118]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    act="gelu_tanh", gated_mlp=True, norm="rms", norm_eps=1e-6,
    rope=True, rope_theta=10000.0, tie_embeddings=True,
    embed_scale=True, post_norm=True,
    attn_softcap=50.0, final_softcap=30.0,
    attn_scale=0.0625,                    # 1/sqrt(query_pre_attn_scalar=256)
    sliding_window=4096, local_global_period=2,
)
