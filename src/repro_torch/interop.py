"""Carry parameter trees between the JAX package and the port as numpy.

Both packages keep the same trees, the policies' ``{"pi": [{"w": [din,
dout], "b": [dout]}, ...], "vf": [...]}`` and the models' nested dicts with
their blocks stacked along a leading ``num_blocks`` axis, so one numpy round
trip serves every parity test and checkpoint.  The serving policies' trees
carry across the same way: ``SSMStatePolicy``'s ``{"embed", "trunk", "pi",
"vf"}`` with the Mamba block's ``in_proj``, ``conv_w``, ``conv_b``,
``x_proj``, ``dt_bias``, ``dt_proj``, ``A_log``, ``D`` and ``out_proj`` under
``"trunk"`` (every ``w`` ``[din, dout]``, ``conv_w`` ``[d_conv, d_in]``,
``A_log`` ``[d_in, d_state]``), and ``TransformerPolicy``'s ``{"obs_proj",
"pos", "pi_head", "vf_head", "layer_<i>": {"norm1", "attn", "norm2",
"mlp"}}``.  The model zoo's trees carry across the same way: MLA's
``w_dkv`` and up-projections ``w_uk`` ``[lora, H, nope]`` and ``w_uv``
``[lora, H, v]``, a Mamba layer's ``A_log``, ``D`` and ``conv_w``, and the
audio model's codebook embeddings ``[K, V, d]`` and head ``[d, K * V]``, each
with the blocks' leading ``num_blocks`` axis where a block holds it.  This
module takes and returns numpy arrays and never imports JAX; a caller
holding JAX arrays converts them with ``np.asarray``.

bfloat16, the zoo's default dtype, has no numpy dtype of its own: a JAX
array converts to ``ml_dtypes``' ``bfloat16``, which ``torch.from_numpy``
does not take, and a bfloat16 tensor has no ``.numpy()``.  Such leaves are
recognised by the dtype's name and carried through their 16 bits
(``uint16``, ``Tensor.view(torch.bfloat16)``), bit for bit, so this module
needs no ``ml_dtypes`` either.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: Any) -> Any:
    """Numpy (or array-like) leaves -> CPU tensors of the same dtype (copies:
    the tensors never alias the caller's arrays); a bfloat16 leaf keeps its
    bits.  ``RolloutWorker.set_weights`` takes such a tree, or the numpy
    tree itself, on any device."""
    return tree_map(_tensor, tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def params_to_numpy(params: Any) -> Any:
    """Tensor leaves -> numpy arrays on the host.  A bfloat16 leaf comes back
    widened to float32, which is exact (as the reference's checkpoint keeps
    it): ``.astype(ml_dtypes.bfloat16)`` gives back its bits.  So
    ``params_from_numpy(params_to_numpy(t))`` widens a bfloat16 tree to
    float32; narrow it again before it reaches a bfloat16 model."""
    return tree_map(_array, params)
