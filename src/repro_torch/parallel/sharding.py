"""Tensor-parallel roles of the linear layers (port of
``repro/parallel/sharding.py:138-160``).  The serving bundle's manifest
records each projection family's role; the sharding rules and the
sharded dispatch wait for tensor parallelism (ROADMAP)."""
from __future__ import annotations

LINEAR_ROLES: dict = {
    "wq": "column", "wk": "column", "wv": "column", "wkv": "column",
    "wqkv": "column", "wq_b": "column", "wk_b": "column", "wv_b": "column",
    "wi": "column", "wg": "column", "win": "column", "wup": "column",
    "w": "column",                        # lm_head / untied output head
    "wo": "row", "wout": "row",
}


def linear_role(name: str) -> str:
    """Tensor-parallel role of linear param ``name``: 'column', 'row' or
    'replicated'."""
    return LINEAR_ROLES.get(name, "replicated")
