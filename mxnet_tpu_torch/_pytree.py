"""Nested containers of arrays ("trees") as the reference's ``jax.tree_util``
walks them: a dict's values in sorted-key order, a list's or tuple's in
order, ``None`` an empty subtree, anything else a leaf. The sentinel's
digest and the checkpoints flatten state in this order, so a tree's
leaves line up with the reference's."""
from __future__ import annotations

from typing import Any, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves"]


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(the leaves, a structure that :func:`tree_unflatten` rebuilds the
    tree from). The structure is plain Python data, so it pickles."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        out = [build(c) for c in node[1]]
        return out if kind == "list" else tuple(out)

    return build(structure)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]
