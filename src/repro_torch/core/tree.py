"""Pytrees in ``jax.tree``'s leaf order.

``torch.utils._pytree`` flattens a dict in insertion order and holds
``None`` as a leaf; ``jax.tree`` flattens a dict in sorted key order and
holds ``None`` as an empty subtree.  The training path (flat LM_GRAD and
ADAMW_STEP vectors, checkpoint leaf files, the optimizer's leaf lists)
must line its leaves up with the reference's, so it flattens through
these helpers: every dict is taken in sorted key order, lists, tuples and
named tuples in order, ``None`` has no leaf, and a type registered with
``torch.utils._pytree`` (``TrainState``) by its own flatten function.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch.utils._pytree as pytree

__all__ = ["tree_flatten", "tree_leaves", "tree_map", "tree_unflatten"]


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in ``jax.tree.flatten``'s order, spec for :func:`tree_unflatten`)."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return ("namedtuple", type(t), [walk(x) for x in t])
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), [walk(x) for x in t])
        node = pytree.SUPPORTED_NODES.get(type(t))
        if node is not None:
            children, ctx = node.flatten_fn(t)
            return ("node", node, ctx, [walk(c) for c in children])
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(spec: Any, leaves) -> Any:
    """The tree of ``spec`` over ``leaves`` (dicts in sorted key order)."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind == "namedtuple":
            return s[1](*(build(c) for c in s[2]))
        if kind == "seq":
            return s[1](build(c) for c in s[2])
        return s[1].unflatten_fn([build(c) for c in s[3]], s[2])

    return build(spec)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure),
    leaf by leaf in ``jax.tree`` order."""
    leaves, spec = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
