"""--arch registry.  Only the dense archs the port serves are registered."""
from __future__ import annotations

import importlib

_ARCHS = {
    "qwen1.5-0.5b": "qwen15_05b",
}


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{list(_ARCHS)} (ROADMAP: remaining archs)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
