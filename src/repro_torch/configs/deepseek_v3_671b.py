"""deepseek-v3-671b [moe] — 61L d7168 128H MLA, expert-ff2048 vocab129280,
1 shared + 256 routed top-8 (sigmoid router, aux-free), first 3 dense
(ff 18432), MTP. [arXiv:2412.19437]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, d_ff_expert=2048, vocab_size=129280,
    act="silu", gated_mlp=True, norm="rms",
    rope=True, rope_theta=10000.0, tie_embeddings=False,
    n_experts=256, top_k=8, n_shared_experts=1, first_k_dense=3,
    router_type="sigmoid", norm_topk=True,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp=True, mtp_weight=0.3,
    optimizer="adafactor",
    sub_quadratic=False,
)
