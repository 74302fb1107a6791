"""Input specs per (arch config × shape cell): the shapes and dtypes of
every model input of a train step, a prefill and a decode step, as plain
tuples (port of ``repro/models/registry.py``; no allocation)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{name: (shape tuple, torch dtype)} for the given shape cell.

    train   → tokens (B,S), labels (B,S) (+ enc_x for encdec, img for vlm)
    prefill → tokens (B,S) (+ enc_x / img)
    decode  → tokens (B,1)  (the cache is built separately)

    ``enc_x``: (B, S // enc_len_ratio, d_model) encoder frames."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        out = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    elif shape.kind == "prefill":
        out = {"tokens": ((B, S), i32)}
    else:
        out = {"tokens": ((B, 1), i32)}
    if shape.kind != "decode":
        if cfg.family == "encdec":
            out["enc_x"] = ((B, S // cfg.enc_len_ratio, cfg.d_model),
                            cfg.cdtype)
        if cfg.family == "vlm" and cfg.n_patches:
            out["img"] = ((B, cfg.n_patches, cfg.d_model), cfg.cdtype)
    return out


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """Is this (arch × shape) cell runnable?  Full-attention archs skip
    the 512k decode cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense decode cache is "
                       "quadratic-cost; no sub-quadratic variant in this "
                       "architecture (DESIGN.md §4)")
    return True, ""
