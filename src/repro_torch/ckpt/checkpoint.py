"""Step checkpoints with an atomic commit and an async writer, and
self-describing array trees (port of ``repro/ckpt/checkpoint.py``).
Files written by either package load in the other.

Step checkpoints: ``<path>/step_XXXXXXXX/leaves.npz`` holds ``leaf_i``, the
state's leaves in ``jax.tree_util.tree_flatten`` order (``repro_torch.
tree``), beside ``treedef.json`` and a ``DONE`` marker; everything is
written under ``step_XXXXXXXX.tmp`` and renamed, so a crash mid-write
never corrupts the latest checkpoint.  ``async_save_checkpoint`` copies
the leaves to the host at once and writes them in a daemon thread.

Array trees: a nested dict of arrays as ONE npz with ``//``-joined path
keys (the format of the serving bundles; numpy only).

The port writes each leaf straight into the zip, one at a time, and a
leaf may be a list of equally shaped arrays, which is written as their
stack along a new first axis without building it: a full-width bundle's
stacked folded weights are gigabytes per leaf.  (Any sequence of arrays
counts as such a list, so a caller can copy each part to the host only
when it is written.)
"""
from __future__ import annotations

import collections.abc
import json
import os
import shutil
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

_KEY_SEP = "//"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, step: int, tree) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    leaves, _ = tree_flatten(tree)
    return _write(path, step, [_host(leaf) for leaf in leaves])


def _write(path, step, host_leaves) -> str:
    tmp = os.path.join(path, f"step_{step:08d}.tmp")
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
    with open(os.path.join(tmp, "treedef.json"), "w") as f:
        json.dump({"n_leaves": len(host_leaves), "step": step}, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def async_save_checkpoint(path: str, step: int, tree) -> threading.Thread:
    """Snapshot to host memory now, write in the background.  Join the
    returned thread to sync."""
    leaves, _ = tree_flatten(tree)
    host = [_host(leaf) for leaf in leaves]          # device→host snapshot
    t = threading.Thread(target=_write, args=(path, step, host),
                         daemon=True)
    t.start()
    return t


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path`` (a ``DONE`` marker, no
    ``.tmp``), or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(path, d, "DONE")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf takes the
    dtype and device of ``like_tree``'s leaf there (tensor leaves) or its
    dtype (array leaves)."""
    d = os.path.join(path, f"step_{step:08d}")
    like, spec = tree_flatten(like_tree)
    with np.load(os.path.join(d, "leaves.npz")) as data:
        if len(data.files) != len(like):
            raise ValueError(f"checkpoint {d} holds {len(data.files)} "
                             f"leaves, the state {len(like)}")
        loaded = [data[f"leaf_{i}"] for i in range(len(like))]
    out = []
    for a, ref in zip(loaded, like):
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(np.array(a, copy=True)).to(ref.dtype)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {tuple(t.shape)} where "
                                 f"the state has {tuple(ref.shape)}")
            out.append(t.to(ref.device))
        else:
            out.append(a.astype(np.asarray(ref).dtype))
    return tree_unflatten(spec, out)


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
