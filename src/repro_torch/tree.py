"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters are plain nested dicts of tensors with the same keys as the
reference's trees, so leaves are addressed by the same ``a/b/c`` paths that
``repro/checkpoint/io.py`` writes.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` pairs in key order, paths joined with ``/``."""
    for k, sub in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(sub, dict):
            yield from tree_items(sub, path)
        else:
            yield path, sub


def tree_leaves(tree: Dict) -> List:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like: Dict, leaves: List) -> Dict:
    """Rebuild ``like``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
