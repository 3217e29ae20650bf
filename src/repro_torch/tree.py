"""Nested-container maps for parameter trees.

Parameters, gradients and optimizer moments are plain nested dicts and lists
of tensors (the JAX package's pytree layout, ``{"pi": [{"w", "b"}, ...],
"vf": [...]}``), so one recursive map stands in for ``jax.tree_util``.
As there, dict keys are visited in sorted order, so leaf lists line up with
the reference's ``tree_leaves``.  ``tree_map_with_path`` names each leaf by
its path as ``jax.tree_util.tree_flatten_with_path`` does (dict keys, list
and tuple indices, NamedTuple field names; ``None`` is an empty subtree),
which is what lets a checkpoint written by either package restore in the
other.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_map_with_path"]


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


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over every leaf, the structure kept (NamedTuples
    stay NamedTuples, ``None`` stays ``None``); ``path`` is the tuple of
    key strings ``jax.tree_util`` gives the same leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, t, path + (str(i),)) for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)
