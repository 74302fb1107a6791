"""Self-describing array trees: a nested dict of arrays as ONE npz with
``//``-joined path keys (port of ``repro/ckpt/checkpoint.py:74-112``, the
format of the serving bundles; numpy only).  Files written by either
package load in the other.

The port writes each leaf straight into the zip, one at a time, and a
leaf may be a list of equally shaped arrays, which is written as their
stack along a new first axis without building it: a full-width bundle's
stacked folded weights are gigabytes per leaf.  (Any sequence of arrays
counts as such a list, so a caller can copy each part to the host only
when it is written.)
"""
from __future__ import annotations

import collections.abc
import os
import zipfile

import numpy as np

_KEY_SEP = "//"


def _flatten(tree: dict) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                if _KEY_SEP in k:
                    raise ValueError(f"key {k!r} contains {_KEY_SEP!r}")
                walk(prefix + [k], v)
        else:
            flat[_KEY_SEP.join(prefix)] = node

    walk([], tree)
    return flat


def _write_stack(f, parts) -> None:
    """Write the list ``parts`` as one .npy array stacked along axis 0,
    converting and writing one part at a time."""
    first = np.asarray(parts[0])
    header = {"descr": np.lib.format.dtype_to_descr(first.dtype),
              "fortran_order": False,
              "shape": (len(parts),) + first.shape}
    np.lib.format.write_array_header_1_0(f, header)
    for i in range(len(parts)):
        a = first if i == 0 else np.asarray(parts[i])
        if a.shape != first.shape or a.dtype != first.dtype:
            raise ValueError(f"stacked part {i}: {a.dtype}{a.shape}, "
                             f"expected {first.dtype}{first.shape}")
        f.write(np.ascontiguousarray(a).tobytes())


def save_array_tree(path: str, tree: dict) -> str:
    """Save a nested dict of arrays as one npz with '//'-joined path keys.
    A sequence leaf is saved as the stack of its parts.  Writes tmp then
    renames, so a crash never leaves a torn file under ``path``."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in flat.items():
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    if isinstance(leaf, collections.abc.Sequence):
                        _write_stack(f, leaf)
                    else:
                        np.lib.format.write_array(f, np.asarray(leaf),
                                                  allow_pickle=False)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_array_tree(path: str) -> dict:
    """Inverse of ``save_array_tree``: npz → nested dict of numpy arrays."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = out
            parts = key.split(_KEY_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out
