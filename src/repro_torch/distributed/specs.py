"""Placement derivation for params / optimizer state / caches / batches
(PyTorch port of ``repro/distributed/specs.py``).

One rules table keyed by parameter leaf name (the last dict key in the tree
path).  Stacked block params (leading ``num_blocks`` dim) get a ``None``
prepended.  Specs resolve through ``AxisRules``, so the same derivation
serves the (data, model) and (pod, data, model) meshes.  Each leaf of the
returned trees is a ``Layout``: the reference's per-tensor-dim
``PartitionSpec`` and the DTensor placements it gives on the rules' mesh
(``Shard(d)`` / ``Replicate()`` per mesh dim); ``tree_shardings`` pairs
them with a mesh, ready for ``distribute_tensor``.

Sharding strategy: tensor parallel on 'model' (heads / d_ff / experts /
vocab), FSDP on 'data' for the d_model dim of weight matrices and
optimizer moments, batch on ('pod','data').
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import AxisRules, PartitionSpec, placements
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

PyTree = Any

__all__ = [
    "Layout",
    "NamedSharding",
    "param_specs",
    "cache_specs",
    "batch_specs",
    "opt_state_specs",
    "tree_shardings",
]

# logical dims per param name (base ndim, logical names)
_PARAM_RULES = {
    # attention / projections: [d_model, out] -> fsdp x tensor
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wr": ("fsdp", "heads"),
    "wg": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "w_dkv": ("fsdp", None),
    "w_uk": (None, "heads", None),
    "w_uv": (None, "heads", None),
    # MLP (2D dense / 3D per-expert)
    "up": ("fsdp", "d_ff"),
    "gate": ("fsdp", "d_ff"),
    "down": ("d_ff", "fsdp"),
    "shared_up": ("fsdp", "d_ff"),
    "shared_gate": ("fsdp", "d_ff"),
    "shared_down": ("d_ff", "fsdp"),
    "router": ("fsdp", None),
    # SSM: mamba
    "in_proj": ("fsdp", "d_ff"),
    "conv_w": (None, "d_ff"),
    "conv_b": ("d_ff",),
    "x_proj": ("d_ff", None),
    "dt_proj": (None, "d_ff"),
    "dt_bias": ("d_ff",),
    "A_log": ("d_ff", None),
    "D": ("d_ff",),
    "out_proj": ("d_ff", "fsdp"),
    # SSM: rwkv6
    "decay_w0": (None,),
    "decay_w1": ("fsdp", None),
    "decay_w2": (None, "fsdp"),
    "bonus_u": ("heads", None),
    "mix": (None, None),
    "ln_out": (None,),
    # embeddings / head / norms
    "lm_head": ("fsdp", "vocab"),
    "final_norm": (None,),
    "norm1": (None,),
    "norm2": (None,),
}

_MOE_3D = {"up": ("experts", "fsdp", None), "gate": ("experts", "fsdp", None),
           "down": ("experts", None, "fsdp")}

_CACHE_RULES = {
    "k": ("batch", "window", "kv_heads", None),
    "v": ("batch", "window", "kv_heads", None),
    "k_q": ("batch", "window", "kv_heads", None),
    "k_s": ("batch", "window", "kv_heads", None),
    "v_q": ("batch", "window", "kv_heads", None),
    "v_s": ("batch", "window", "kv_heads", None),
    "c": ("batch", "window", None),       # MLA latent cache
    "k_rope": ("batch", "window", None),
    "wkv": ("batch", "heads", None, None),
    "x_prev": ("batch", None),
    "h": ("batch", "d_ff", None),
    "conv": ("batch", None, "d_ff"),
    "pos": (),
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One leaf's layout: the per-tensor-dim ``spec`` and, on a mesh, its
    per-mesh-dim DTensor ``placements`` (empty without a mesh)."""

    spec: PartitionSpec
    placements: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it."""

    mesh: Any
    placements: Tuple[Any, ...]

    def distribute(self, tensor: Any) -> Any:
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, list(self.placements))


def _layout(rules: AxisRules, spec: PartitionSpec) -> Layout:
    return Layout(spec, placements(spec, rules.mesh) if rules.mesh is not None else ())


def _leaf_name(path: Tuple[str, ...]) -> str:
    for p in reversed(path):
        if not p.isdigit():
            return p
    return ""


def _is_stacked(path: Tuple[str, ...]) -> bool:
    return "blocks" in path


def _resolve(
    rules: AxisRules,
    logical: Sequence[Optional[str]],
    stacked: bool,
    shape: Optional[Sequence[int]] = None,
) -> Layout:
    if shape is not None and stacked:
        shape = shape[1:]
    spec = rules.resolve(list(logical), shape=shape)
    if stacked:
        spec = PartitionSpec(None, *spec)
    return _layout(rules, spec)


def param_specs(params_shape: PyTree, rules: AxisRules) -> PyTree:
    """``Layout`` tree matching a params (or shape) tree."""

    def spec_for(path, leaf):
        name = _leaf_name(path)
        stacked = _is_stacked(path)
        ndim = leaf.ndim - (1 if stacked else 0)
        if name == "embed":
            logical = ("vocab", "fsdp") if ndim == 2 else (None, "vocab", "fsdp")
        elif name in ("up", "gate", "down") and ndim == 3:
            logical = _MOE_3D[name]
        elif name in _PARAM_RULES:
            logical = _PARAM_RULES[name]
        else:
            logical = (None,) * ndim
        if len(logical) != ndim:
            raise ValueError(f"spec rank mismatch for {name}: {logical} vs ndim {ndim}")
        return _resolve(rules, logical, stacked, shape=tuple(leaf.shape))

    return tree_map_with_path(spec_for, params_shape)


def cache_specs(cache_shape: PyTree, rules: AxisRules) -> PyTree:
    def spec_for(path, leaf):
        name = _leaf_name(path)
        stacked = _is_stacked(path)
        ndim = leaf.ndim - (1 if stacked else 0)
        logical = _CACHE_RULES.get(name, (None,) * ndim)
        if len(logical) != ndim:
            logical = (None,) * ndim
        return _resolve(rules, logical, stacked, shape=tuple(leaf.shape))

    return tree_map_with_path(spec_for, cache_shape)


def batch_specs(batch_shape: PyTree, rules: AxisRules) -> PyTree:
    def spec_for(path, leaf):
        logical = ("batch",) + (None,) * (leaf.ndim - 1)
        return _layout(rules, rules.resolve(list(logical), shape=tuple(leaf.shape)))

    return tree_map_with_path(spec_for, batch_shape)


def _paths(tree: PyTree) -> list:
    return tree_leaves(tree_map_with_path(lambda path, _leaf: "/".join(path), tree))


def opt_state_specs(opt_state_shape: PyTree, pspecs: PyTree, rules: AxisRules) -> PyTree:
    """Optimizer state specs: moments mirror param specs; counters replicate.

    Works for ``AdamState``/``SgdState`` NamedTuples whose ``mu``/``nu``
    (``momentum``) fields share the param tree structure.
    """
    param_paths = _paths(pspecs)
    replicated = _layout(rules, PartitionSpec())

    def map_field(field_shape):
        if _paths(field_shape) == param_paths:
            return pspecs
        return tree_map(lambda _leaf: replicated, field_shape)

    if hasattr(opt_state_shape, "_fields"):  # NamedTuple
        return type(opt_state_shape)(
            *[
                map_field(getattr(opt_state_shape, f)) if getattr(opt_state_shape, f) is not None else None
                for f in opt_state_shape._fields
            ]
        )
    return tree_map(lambda _leaf: replicated, opt_state_shape)


def tree_shardings(mesh: Any, spec_tree: PyTree) -> PyTree:
    """Each ``Layout`` of ``spec_tree`` as a ``NamedSharding`` on ``mesh``."""
    return tree_map_with_path(
        lambda _path, layout: NamedSharding(mesh, placements(layout.spec, mesh)), spec_tree
    )
