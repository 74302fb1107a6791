"""--arch registry: the reference's dense- and moe-family archs, the ones
the port serves (the other families wait, ROADMAP Queue A)."""
from __future__ import annotations

import importlib

_ARCHS = {
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{list(_ARCHS)} (ROADMAP: remaining archs)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
