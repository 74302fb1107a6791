"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) ff5504 vocab32001,
parallel attention+mamba heads, ssm_state=16, 128 meta tokens, SWA 2048
with 3 global layers. [arXiv:2411.13676]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    act="silu", gated_mlp=True, norm="rms",
    rope=True, rope_theta=10000.0, tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    meta_tokens=128, sliding_window=2048, global_layers=(0, 15, 31),
    sub_quadratic=True,          # SWA + SSM state: runs long_500k
)
