"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert-ff1536
vocab151936, 128 experts top-8, q/k-norm. [hf:Qwen/Qwen3-235B-A22B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=12288, d_ff_expert=1536, vocab_size=151936,
    act="silu", gated_mlp=True, norm="rms", qk_norm=True,
    rope=True, rope_theta=1_000_000.0, tie_embeddings=False,
    n_experts=128, top_k=8, norm_topk=True, router_type="softmax",
    optimizer="adafactor",
    sub_quadratic=False,
)
