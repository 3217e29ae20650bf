"""Chunked, remat-friendly time scans (PyTorch port of
``repro/models/scan_utils.py``).

A plain scan over T steps keeps, for the backward, every step's
intermediates: for an SSM layer that is O(T x state) memory.
``chunked_scan`` runs the steps a chunk at a time and, with ``remat``, runs
each chunk under ``torch.utils.checkpoint`` (non-reentrant), so the backward
keeps one carry per chunk and recomputes the chunk's steps.  Memory drops by
about ``chunk`` times at the cost of one more forward over the sequence.

``step(carry, x_t) -> (carry, y_t)`` takes and returns trees of tensors;
``xs`` is a tree whose leaves share a leading time axis, and the ``y_t`` are
stacked along a new leading axis, as ``lax.scan`` stacks them.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import hlo_cost as _cost
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["chunked_scan", "scan"]


def _unflatten(template: PyTree, leaves: list) -> PyTree:
    """``template``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def scan(
    step: Callable[[PyTree, PyTree], Tuple[PyTree, PyTree]], carry: PyTree, xs: PyTree
) -> Tuple[PyTree, PyTree]:
    """``lax.scan`` over the leading axis of ``xs``, a loop of ``step``.  The
    steps' inputs are ``unbind``'s slices, whose backward is one stack (an
    index a step would zero-fill a whole input's gradient each step)."""
    steps = [a.unbind(0) for a in tree_leaves(xs)]
    ys = []
    for t in range(len(steps[0])):
        carry, y = step(carry, _unflatten(xs, [s[t] for s in steps]))
        ys.append(y)
    return carry, tree_map(lambda *y: torch.stack(y), *ys)


def chunked_scan(
    step: Callable[[PyTree, PyTree], Tuple[PyTree, PyTree]],
    carry: PyTree,
    xs: PyTree,
    chunk: int = 128,
    remat: bool = True,
    prep: Optional[Callable[[PyTree], PyTree]] = None,
    post: Optional[Callable[[PyTree, PyTree], PyTree]] = None,
) -> Tuple[PyTree, PyTree]:
    """The reference's ``chunked_scan``: chunks of ``chunk`` steps, each
    under a checkpoint with ``remat``; the plain scan where ``chunk`` does
    not divide T, T <= chunk or chunk <= 1.  Two hooks, which the reference
    has no need of (XLA fuses a step's ops), let a caller do a step's
    elementwise work for a whole chunk at once, in a few launches instead of
    a few a step: ``prep(xs_chunk)`` gives the step's inputs, and
    ``post(ys_chunk, prepped)`` turns the stacked step outputs into the
    chunk's ys.  Both run inside the chunk's checkpoint, so what they make
    is one chunk's worth, and is recomputed in the backward."""
    prep = prep or (lambda x: x)

    def run(c: PyTree, x: PyTree) -> Tuple[PyTree, PyTree]:
        x = prep(x)
        c, ys = scan(step, c, x)
        return c, (post(ys, x) if post is not None else ys)

    T = tree_leaves(xs)[0].shape[0]
    if chunk <= 1 or T % chunk or T <= chunk:
        return run(carry, xs)
    carry_leaves = tree_leaves(carry)
    xs_leaves = tree_leaves(xs)
    n_carry = len(carry_leaves)
    ys_template = []

    def inner(*flat):
        # checkpoint() takes and returns tensors, so the trees go flat.
        c, ys = run(_unflatten(carry, flat[:n_carry]), _unflatten(xs, flat[n_carry:]))
        ys_template[:] = [ys]
        return (*tree_leaves(c), *tree_leaves(ys))

    remat = remat and torch.is_grad_enabled()
    walker = _cost.LOCAL.walker
    if walker is not None and not walker.execute:
        # Priced on fake tensors: every chunk computes the same shapes, so
        # the first runs and is priced once a chunk, its backward too.
        n = T // chunk
        args = (*carry_leaves, *(a[:chunk] for a in xs_leaves))
        out = walker.repeated(
            n, lambda *a: checkpoint(inner, *a, use_reentrant=False) if remat else inner(*a),
            *args)
        ys = [y.expand((n,) + tuple(y.shape)).reshape((T,) + tuple(y.shape[1:]))
              for y in out[n_carry:]]
        return _unflatten(carry, list(out[:n_carry])), _unflatten(ys_template[0], ys)
    chunks = []
    # split(), like unbind() in scan, has one cat for its backward.
    for xs_chunk in zip(*(a.split(chunk) for a in xs_leaves)):
        args = (*carry_leaves, *xs_chunk)
        out = checkpoint(inner, *args, use_reentrant=False) if remat else inner(*args)
        carry_leaves = list(out[:n_carry])
        chunks.append(out[n_carry:])
    ys = [torch.cat(parts) for parts in zip(*chunks)]
    return _unflatten(carry, carry_leaves), _unflatten(ys_template[0], ys)
