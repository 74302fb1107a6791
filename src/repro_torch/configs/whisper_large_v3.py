"""whisper-large-v3 [encdec] — encoder-decoder 32L+32L d1280 20H ff5120
vocab51866; the conv front end is a stub: the encoder takes frame
embeddings (``enc_x``, seq/4 frames). [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-large-v3", family="encdec",
    n_layers=64, enc_layers=32, dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    act="gelu", gated_mlp=False, norm="layer", norm_eps=1e-5,
    qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    rope=False, tie_embeddings=True,
    enc_len_ratio=4, max_pos_embed=32768,
    sub_quadratic=False,
)
