"""xlstm-1.3b [xlstm] — 48 blocks d2048 4H vocab50304, mLSTM + sLSTM
(1 sLSTM per 8 blocks — xLSTM[7:1]); block-diagonal q/k/v.
[arXiv:2405.04517]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    norm="rms", rope=False, tie_embeddings=False,
    slstm_every=8, mlstm_proj_factor=2.0, chunk_size=256,
    sub_quadratic=True,          # recurrent state: runs long_500k
)
