"""ModelConfig for the port: the fields the dense, MoE/MLA, vlm, hybrid
and xlstm decoder families, the encdec family, the serving engines and
the trainer read, and the input-shape cells (port of
``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.layers import MacConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pad_to(x: int, m: int) -> int:
    return x if m <= 1 else ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524288, 1, "decode"),
}


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
    # moe: routed experts (softmax or DeepSeek's sigmoid router), shared
    # experts, a dense prefix of ``first_k_dense`` layers
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    router_type: str = "softmax"
    norm_topk: bool = True
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # mla: multi-head latent attention with decoupled RoPE; multi-token
    # prediction (a training-only head)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False
    mtp: bool = False
    mtp_weight: float = 0.3
    # ssm / hybrid (hymba): the selective scan's state, expansion and conv
    # width, and the learned meta tokens that lead every sequence
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    meta_tokens: int = 0
    # xlstm: one sLSTM block per ``slstm_every`` blocks (0: none), the
    # mLSTM's up-projection factor and its chunkwise-parallel chunk
    slstm_every: int = 0
    mlstm_proj_factor: float = 2.0
    chunk_size: int = 256
    # encdec (whisper): encoder and decoder depths, decoder tokens per
    # encoder frame, the decoder's learned position table
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len_ratio: int = 4
    max_pos_embed: int = 32768
    # vlm: patch embeddings that replace the prompt's leading positions
    n_patches: int = 0
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
    # training: per-layer activation checkpointing (torch.utils.checkpoint
    # where the reference wraps each layer in jax.checkpoint), the global
    # microbatch for gradient accumulation (0: off), the optimizer
    remat: bool = True
    pad_heads_to: int = 1
    vocab_pad_to: int = 1
    microbatch: int = 0
    mac: MacConfig = dataclasses.field(default_factory=MacConfig)
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    sub_quadratic: bool = False       # runs long_500k?

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
        """Per-layer sliding windows (None entries = global); an encdec
        arch's are its decoder's."""
        out = []
        for i in range(self.dec_layers or self.n_layers):
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
        """Tiny same-family config for CPU tests (the reference's
        ``reduced`` for the fields the port has)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            d_model=128,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256, d_ff_expert=64 if self.d_ff_expert else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=48 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            meta_tokens=min(self.meta_tokens, 8),
            n_patches=min(self.n_patches, 16),
            chunk_size=32, attn_chunk=64, max_pos_embed=2048,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            global_layers=tuple(g for g in self.global_layers if g < 2),
            param_dtype="float32", compute_dtype="float32",
            pad_heads_to=1, vocab_pad_to=1)

    def with_layers(self, n_layers: int) -> "ModelConfig":
        """The same widths, depth cut to ``n_layers`` (a port-only helper
        for the card, where a full-depth MoE model does not fit): a moe
        arch keeps at most ``n_layers - 1`` layers of its dense prefix,
        so one MoE layer stays; an encdec arch keeps ``n_layers`` encoder
        and ``n_layers`` decoder layers; an xlstm arch only a multiple of
        ``slstm_every``, where the reference's scanned and unrolled layer
        orders agree."""
        if self.family == "encdec":
            return dataclasses.replace(self, n_layers=2 * n_layers,
                                       enc_layers=n_layers,
                                       dec_layers=n_layers)
        if self.slstm_every and n_layers % self.slstm_every:
            raise ValueError(
                f"{self.arch}: {n_layers} layers is not a multiple of "
                f"slstm_every={self.slstm_every}; the reference's scanned "
                "and unrolled xLSTM layer orders part there")
        first = self.first_k_dense
        if self.n_experts:
            first = min(first, n_layers - 1)
        return dataclasses.replace(self, n_layers=n_layers,
                                   first_k_dense=first)

    def approx_params(self) -> float:
        """Rough parameter count (the reference's, for its dtype and
        optimizer policy)."""
        d, L = self.d_model, (self.n_layers or
                              self.enc_layers + self.dec_layers)
        hd = self.head_dim_r
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.use_mla:
            attn = d * self.q_lora_rank \
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim
                                                     + self.qk_rope_dim) \
                + d * (self.kv_lora_rank + self.qk_rope_dim) \
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim
                                                      + self.v_head_dim) \
                + self.n_heads * self.v_head_dim * d
        if self.n_experts:
            ff = 3 * d * self.d_ff_expert * (self.n_experts
                                             + self.n_shared_experts)
            ff_dense = 3 * d * self.d_ff if self.first_k_dense else 0
            total = (L - self.first_k_dense) * (attn + ff) \
                + self.first_k_dense * (attn + ff_dense)
        elif self.family == "xlstm":
            di = int(self.mlstm_proj_factor * d)
            total = L * (d * 2 * di + 3 * di * (di // max(self.n_heads, 1))
                         + di * d)
        else:
            total = L * (attn + (3 if self.gated_mlp else 2) * d * self.d_ff)
            if self.family == "hybrid":
                di = self.ssm_expand * d
                total += L * (2 * d * di + di * d)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return float(total)
