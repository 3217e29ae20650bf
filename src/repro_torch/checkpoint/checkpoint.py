"""Pytree checkpointing to .npz (PyTorch port of
``repro/checkpoint/checkpoint.py``).

Keys are '/'-joined tree paths, the same strings ``jax.tree_util`` gives
(``repro_torch.tree.tree_map_with_path``), so a file written by either
package restores in the other.  Tensors are moved to the host as they are
written, one at a time; a restore copies each array into its template
tensor, on that tensor's device and in its dtype.

Durability model follows the paper (§3): checkpoints are the only durable
state; all dataflow operator state is discardable and rebuilt on restart.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path

PyTree = Any

__all__ = ["save_pytree", "restore_pytree"]


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # npz has no bfloat16: widen, as the reference
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _leaves_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda path, leaf: out.append(("/".join(path), leaf)), tree)
    return out


def save_pytree(path: str, tree: PyTree) -> None:
    """Write ``tree`` to ``path`` as ``np.savez`` would, one leaf at a time:
    each tensor is copied to the host as it is written, so a model at full
    width never has a second copy of all its weights in host memory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez's naming
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in _leaves_with_paths(tree):
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(leaf), allow_pickle=False)


def restore_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (shape and dtype template).

    Each array is copied into its template tensor, as ``set_weights`` copies
    into a worker's own parameters: the tensor keeps its device, dtype and
    ``requires_grad`` (a learner that updates its parameters in place goes on
    with them), no second copy is allocated on the device, and no loaded
    array is bound that a caller still holds.  The returned tree holds the
    template's tensors; Python scalars (an optimizer's step) come back as
    their template's type, other leaves as the loaded arrays."""
    with np.load(path) as data:

        def load(pth, leaf):
            arr = data["/".join(pth)]
            if isinstance(leaf, torch.Tensor):
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{'/'.join(pth)}: checkpoint shape {arr.shape} != "
                                     f"template shape {tuple(leaf.shape)}")
                with torch.no_grad():
                    leaf.copy_(torch.from_numpy(arr))
                return leaf
            if isinstance(leaf, (bool, int, float)):
                return type(leaf)(arr)
            return arr

        return tree_map_with_path(load, like)
