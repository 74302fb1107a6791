"""Nested containers of tensors (dicts, lists, tuples) flattened in the
order ``jax.tree_util.tree_flatten`` uses: dict entries by sorted key,
lists and tuples in order, ``None`` an empty subtree.  The optimizers'
state trees and the step checkpoints rely on this order: leaf ``i`` of a
checkpoint is leaf ``i`` of the reference's state."""
from __future__ import annotations


def tree_flatten(tree):
    """→ (leaves, spec); ``tree_unflatten(spec, leaves)`` rebuilds it."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v) for v in node])
        if node is None:
            return ("none", None, None)
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def tree_unflatten(spec, leaves):
    it = iter(leaves)

    def build(sp):
        kind, keys, kids = sp
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, kids)}
        return kind(build(s) for s in kids)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure)."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for ls, sp in others:
        if sp != spec:
            raise ValueError("tree_map: the trees' structures differ")
    return tree_unflatten(spec, [fn(*xs) for xs in
                                 zip(leaves, *(ls for ls, _ in others))])
