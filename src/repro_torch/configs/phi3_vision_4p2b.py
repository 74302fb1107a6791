"""phi-3-vision-4.2b [vlm] — 32L d3072 32H (GQA kv=32) ff8192 vocab32064,
phi3-mini backbone + CLIP STUB (input_specs provides 256 pre-projected patch
embeddings). [hf:microsoft/Phi-3-vision-128k-instruct]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    act="silu", gated_mlp=True, norm="rms",
    rope=True, rope_theta=10000.0, tie_embeddings=False,
    n_patches=256,
    sub_quadratic=False,
)
