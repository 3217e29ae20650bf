"""Nested-container maps for parameter trees.

Parameters, gradients and optimizer moments are plain nested dicts and lists
of tensors (the JAX package's pytree layout, ``{"pi": [{"w", "b"}, ...],
"vf": [...]}``), so one recursive map stands in for ``jax.tree_util``.
As there, dict keys are visited in sorted order, so leaf lists line up with
the reference's ``tree_leaves``.
"""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]
