"""--arch registry: every arch of the reference (the dense, moe, vlm,
hybrid, xlstm and encdec families)."""
from __future__ import annotations

import importlib

_ARCHS = {
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hymba-1.5b": "hymba_1p5b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "xlstm-1.3b": "xlstm_1p3b",
    "whisper-large-v3": "whisper_large_v3",
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{list(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
