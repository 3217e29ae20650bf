"""Carry parameter trees between the JAX package and the port as numpy.

Both packages keep the same trees, the policies' ``{"pi": [{"w": [din,
dout], "b": [dout]}, ...], "vf": [...]}`` and the models' nested dicts with
their blocks stacked along a leading ``num_blocks`` axis, so one numpy round
trip serves every parity test and checkpoint.  This module takes and returns numpy arrays and never
imports JAX; a caller holding JAX arrays converts them with ``np.asarray``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: Any) -> Any:
    """Numpy (or array-like) leaves -> CPU tensors of the same dtype (copies:
    the tensors never alias the caller's arrays).  ``RolloutWorker.
    set_weights`` takes such a tree, or the numpy tree itself, on any device."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def params_to_numpy(params: Any) -> Any:
    """Tensor leaves -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
