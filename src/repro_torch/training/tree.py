"""Nested dicts of tensors (the port's parameter and state trees)."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, into a tree of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: Iterable):
    """A tree of ``like``'s keys holding ``leaves`` in ``tree_leaves``'
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree, prefix: str = "") -> Dict[str, object]:
    """path -> leaf, paths joined with "/" ("blocks/attn/wq"), the
    reference checkpoint's keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
