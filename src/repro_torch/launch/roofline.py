"""The H100's roofline: the least time the card could take for a piece of
work (the port's counterpart of ``repro/launch/roofline.py``, whose peaks
are a TPU's).

The peaks are NVIDIA's data-sheet figures for the H100 SXM part (dense
rates, no sparsity), the "NVIDIA H100 80GB HBM3, 700 W" card that
``PERF.md`` names; a card set below 700 W runs slower under load, so a
bound is stated with the card's power limit beside it:

  * HBM: 3.35e12 B/s, 80 GB;
  * bf16 (tensor cores): 989e12 FLOP/s;
  * tf32 (tensor cores): 495e12 FLOP/s;
  * f32 (outside the tensor cores): 67e12 FLOP/s.

``Roofline(bytes, ops, peak)`` is one call's bound: the larger of the
bytes it must move (each input read once, each output written once) over
the HBM rate, and its operations over the peak of their type.  The
per-kernel reckoners give the bytes and operations of the port's three
kernels as ``chip_smoke.py``'s kernels line and
``launch/kernel_bench.py`` count them; ``model_flops`` the operations of
a whole decode step, prefill or train step.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
CARD = "NVIDIA H100 80GB HBM3, 700 W (data sheet, SXM, dense)"


@dataclasses.dataclass(frozen=True)
class Roofline:
    """One call's bound from its bytes and operations."""
    bytes: float
    ops: float
    peak_ops: float = PEAK_BF16

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.ops / self.peak_ops * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"

    def as_dict(self) -> dict:
        return {"bytes": self.bytes, "ops": self.ops,
                "peak_ops": self.peak_ops, "bytes_ms": self.bytes_ms,
                "ops_ms": self.ops_ms, "bound_ms": self.bound_ms,
                "bound_by": self.bound_by}


def encoded_matmul(m: int, k: int, n: int, U: int) -> Roofline:
    """Kernel 1: x (m, k) int8 and Wt (U, k, n) bf16 and bias (n,) f32 in,
    (m, n) f32 out; 2·m·k·n·U bf16 tensor-core operations."""
    nbytes = m * k + U * k * n * 2 + n * 4 + m * n * 4
    return Roofline(nbytes, 2.0 * m * k * n * U, PEAK_BF16)


def paged_pages_read(lens, Sq: int, ps: int) -> int:
    """Pages a kernel-2 call reads per kv head: each row through the page
    holding position ``lens[b] + Sq - 1``."""
    return sum((ln + Sq - 1) // ps + 1 for ln in lens)


def paged_attn(B: int, Sq: int, Hq: int, Hkv: int, D: int, ps: int, lens,
               mode: str = "bf16") -> Roofline:
    """Kernel 2 over ``lens`` (B,): f32 q in and out, the K and V rows of
    the pages it reads with their f32 scale where the pools are quantized
    (``mode`` 'bf16' = dense pools of q's dtype, 'int8', 'int4'), the page
    ids and lens; 4·Sq·D f32 operations per (query head, cached token)
    read."""
    read = paged_pages_read(lens, Sq, ps)
    row = D * 4 if mode == "bf16" else (D // 2 + 4 if mode == "int4"
                                        else D + 4)
    nbytes = (2 * B * Sq * Hq * D * 4 + 2 * read * ps * Hkv * row
              + read * 4 + B * 4)
    return Roofline(nbytes, 4.0 * Sq * D * read * ps * Hq, PEAK_F32)


def flash_attention(B: int, S: int, H: int, D: int, itemsize: int
                    ) -> Roofline:
    """Kernel 3, causal, at Sq = Sk = S: q, k, v in and out once; 4·D
    operations per visible (query, key) pair, on the tensor cores: bf16
    (``itemsize`` 2) once, f32 (``itemsize`` 4) as three tf32 products
    (3xTF32)."""
    pairs = S * (S + 1) / 2
    ops = 4.0 * D * B * H * pairs
    if itemsize == 4:
        return Roofline(4 * B * H * S * D * 4, 3 * ops, PEAK_TF32)
    return Roofline(4 * B * H * S * D * itemsize, ops, PEAK_BF16)


def active_params(cfg) -> float:
    """Parameters a token runs through: every one, with a MoE layer's
    experts cut to the ``top_k`` routed and the shared ones."""
    n = cfg.approx_params()
    if not cfg.n_experts:
        return n
    ratio = (cfg.top_k + cfg.n_shared_experts) / max(
        cfg.n_experts + cfg.n_shared_experts, 1)
    moe_ffn = 3 * cfg.d_model * cfg.d_ff_expert * (
        cfg.n_experts + cfg.n_shared_experts)
    return n - (cfg.n_layers - cfg.first_k_dense) * moe_ffn * (1 - ratio)


def model_flops(cfg, kind: str, seq_len: int, batch: int) -> float:
    """Operations of one step of ``cfg`` (the reference's
    ``model_flops``): ``kind`` 'train' (6·N·tokens plus causal attention,
    forward and backward), 'prefill' (2·N·tokens plus causal attention)
    or 'decode' (one token per sequence against ``seq_len`` cached)."""
    n = active_params(cfg)
    L = cfg.n_layers or (cfg.enc_layers + cfg.dec_layers)
    attn = cfg.n_heads * cfg.head_dim_r * L
    if kind == "train":
        return 6.0 * n * seq_len * batch + \
            12.0 * batch * seq_len ** 2 * attn * 0.5
    if kind == "prefill":
        return 2.0 * n * seq_len * batch + \
            4.0 * batch * seq_len ** 2 * attn * 0.5
    f = 2.0 * n * batch
    if cfg.use_mla:
        f += L * (4.0 * batch * seq_len * cfg.n_heads
                  * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                  + 2.0 * batch * seq_len * cfg.kv_lora_rank * cfg.n_heads
                  * (cfg.qk_nope_dim + cfg.v_head_dim))
    elif cfg.family != "xlstm":
        s = min(seq_len, cfg.sliding_window or seq_len) \
            if cfg.family == "hybrid" else seq_len
        f += L * 4.0 * batch * s * cfg.n_heads * cfg.head_dim_r
    return f
