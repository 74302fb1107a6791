"""ModelConfig for the port: the fields the dense decoder family reads
(port of ``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.layers import MacConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pad_to(x: int, m: int) -> int:
    return x if m <= 1 else ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "tiny"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None
    d_ff: int = 512
    vocab_size: int = 1024
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rms"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False
    post_norm: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0
    global_layers: Tuple[int, ...] = ()
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024
    # kept for parity of fields with the reference: its flash gate never
    # opens on the model path, so the port's attention ignores it too
    # (see nn/attention.py); kernels.ops.flash_mha is the kernel's entry
    flash_attention: bool = False
    # paged decode attention: 'gather' = the gathered-page-view path (the
    # reference's 'xla'); 'kernel' = the fused page-walk op (the
    # reference's 'pallas'), which is the CUDA kernel on the card and its
    # plain PyTorch version on the CPU
    attention_backend: str = "gather"
    # max query tokens per slot routed through the fused paged op
    paged_fused_max_sq: int = 1
    # paged KV-cache storage: 'bf16' = dense pages in compute_dtype;
    # 'int8'/'int4' store pages quantized with per-token per-kv-head f32
    # scale rows in side pools, dequantized inside the paged-attention
    # page loop (quant.kvcache.kv_pool_layout validates it)
    kv_cache_dtype: str = "bf16"
    pad_heads_to: int = 1
    vocab_pad_to: int = 1
    mac: MacConfig = dataclasses.field(default_factory=MacConfig)

    @property
    def head_dim_r(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_heads_p(self) -> int:
        return _pad_to(self.n_heads, self.pad_heads_to)

    @property
    def n_kv_p(self) -> int:
        return _pad_to(self.n_kv_heads, self.pad_heads_to)

    @property
    def vocab_p(self) -> int:
        return _pad_to(self.vocab_size, self.vocab_pad_to)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def layer_windows(self):
        """Per-layer sliding windows (None entries = global)."""
        out = []
        for i in range(self.n_layers):
            if self.local_global_period:
                out.append(self.sliding_window
                           if i % self.local_global_period == 0 else None)
            elif self.global_layers:
                out.append(None if i in self.global_layers
                           else self.sliding_window)
            else:
                out.append(self.sliding_window)
        return out

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the dense-family part of
        the reference's ``reduced``)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            attn_chunk=64,
            global_layers=tuple(g for g in self.global_layers if g < 2),
            param_dtype="float32", compute_dtype="float32",
            pad_heads_to=1, vocab_pad_to=1)
