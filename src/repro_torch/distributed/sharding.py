"""Logical-axis sharding: one rules table maps model dims to mesh axes
(PyTorch port of ``repro/distributed/sharding.py``).

Model code annotates tensors with *logical* axis names ("batch", "seq",
"heads", "d_ff", "experts", ...).  A rules table resolves logical names to
mesh axes (or None = replicated).  The same code therefore serves one card
(a (1, 1) mesh: every placement ``Replicate()``), a 16 x 16 mesh or a
2 x 16 x 16 mesh; only the rules and the mesh change.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (anything with
``mesh_dim_names`` and ``shape`` resolves).  ``resolve`` returns the
reference's per-tensor-dim ``PartitionSpec``; ``placements`` turns it into
the per-mesh-dim DTensor placements (``Shard(d)`` / ``Replicate()``) that
``distribute_tensor`` and ``redistribute`` take.

Default production rules (16 x 16 per pod):

    batch   -> ('pod', 'data')   # data parallel across pods and data axis
    fsdp    -> 'data'            # param/optimizer-state FSDP dim
    vocab   -> 'model'
    heads   -> 'model'           # tensor parallel attention
    kv_heads-> 'model'
    d_ff    -> 'model'           # tensor parallel MLP
    experts -> 'model'           # expert parallel MoE
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "axis_index",
    "P",
    "PartitionSpec",
    "axis_rules_context",
    "get_axis_rules",
    "logical_spec",
    "make_data_mesh",
    "make_mesh",
    "placements",
    "shard",
    "shard_map",
]

MeshAxes = Union[None, str, Tuple[str, ...]]


def _prod(it) -> int:
    out = 1
    for x in it:
        out *= x
    return out


class PartitionSpec:
    """Per-tensor-dim mesh axes: each entry is None (replicated), one mesh
    axis name, or a tuple of names (the dim split over several axes, major
    first), as ``jax.sharding.PartitionSpec``."""

    __slots__ = ("entries",)

    def __init__(self, *entries: MeshAxes):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> MeshAxes:
        return self.entries[i]

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PartitionSpec) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def _mesh_axes(mesh: Any) -> Optional[Dict[str, int]]:
    if mesh is None:
        return None
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class AxisRules:
    def __init__(self, rules: Dict[str, MeshAxes], mesh: Any = None):
        self.rules = dict(rules)
        self.mesh = mesh

    def resolve(
        self,
        logical: Sequence[Optional[str]],
        shape: Optional[Sequence[int]] = None,
    ) -> PartitionSpec:
        """Map a tuple of logical dim names to a PartitionSpec.

        Drops mesh axes that are not present in the bound mesh (so the same
        rules serve ('data','model') and ('pod','data','model') meshes), never
        uses a mesh axis twice in one spec, and — when ``shape`` is given —
        drops axes that do not divide the dim evenly (e.g. 40 heads on a
        16-way model axis): DTensor would pad an uneven shard.
        """
        mesh_axes = _mesh_axes(self.mesh)
        used: set = set()
        out = []
        for i, name in enumerate(logical):
            axes = self.rules.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            keep = []
            dim = shape[i] if shape is not None else None
            for a in axes:
                if mesh_axes is not None and a not in mesh_axes:
                    continue
                if a in used:
                    continue
                if dim is not None and mesh_axes is not None:
                    if dim % (mesh_axes[a] * _prod(mesh_axes[x] for x in keep)):
                        continue
                keep.append(a)
            used.update(keep)
            if not keep:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(tuple(keep))
        return PartitionSpec(*out)


DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "experts": "model",
    "seq": None,
    "d_model": None,
    "head_dim": None,
    "state": None,
    # Decode KV-cache context dim: sharded over 'model' (context parallelism)
    # so long caches fit regardless of kv-head divisibility.
    "window": "model",
}


def placements(spec: PartitionSpec, mesh: Any) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``.  A
    tensor dim split over several mesh axes shards on each of them, major
    axis first, as DTensor's default order of shards does.  A mesh dim of
    size 1 holds the whole tensor, so its placement is ``Replicate()`` (on
    one card every placement is)."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            by_axis[a] = d
    sizes = _mesh_axes(mesh)
    return tuple(
        Shard(by_axis[a]) if a in by_axis and sizes[a] > 1 else Replicate()
        for a in mesh.mesh_dim_names
    )


def axis_index(mesh: Any, axes: MeshAxes) -> Tuple[int, int]:
    """(this rank's index along ``axes``, major axis first, and their total
    size): which slice of a dim split over those mesh axes it holds."""
    names = (axes,) if isinstance(axes, str) else tuple(axes or ())
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, size = 0, 1
    for a in names:
        if a in sizes:
            index, size = index * sizes[a] + coord[a], size * sizes[a]
    return index, size


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: str) -> Any:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over ranks 0..N-1.

    Under a default process group of at least N ranks (the dry run's
    ``"fake"`` group, or a real one) it is a full mesh whose DTensors
    communicate.  Without one it can only be of size 1: a mesh that
    describes a single device (names and sizes for ``AxisRules``; every
    placement on it is ``Replicate()``), built without process groups."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = _prod(shape)
    ranks = torch.arange(n, dtype=torch.int).reshape(tuple(shape))
    if dist.is_available() and dist.is_initialized():
        return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))
    if n != 1:
        raise ValueError(
            f"a {tuple(shape)} mesh needs a process group of {n} ranks; none is initialised"
        )
    try:
        return DeviceMesh(
            device_type, ranks, mesh_dim_names=tuple(names), _init_backend=False, _rank=0
        )
    except TypeError:  # a torch whose DeviceMesh takes no ``_rank``
        return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names), _init_backend=False)


def _visible_devices(device_type: str) -> int:
    import torch.distributed as dist

    if device_type == "cuda":
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_data_mesh(num_devices: int = 0, device_type: str = "cuda") -> Any:
    """A 1-D ``('data',)`` mesh over the first ``num_devices`` devices.

    The mesh shape pure data parallelism wants (sharded learner groups,
    eval fan-out): one axis, batch dim sharded over it, everything else
    replicated.  ``num_devices <= 0`` takes every visible device (CUDA
    cards; for the CPU, the ranks of the default process group, or 1);
    asking for more than are visible raises rather than silently
    shrinking — callers that want clamp-with-warning semantics
    (``ShardedLearnerGroup``) decide that policy themselves.
    """
    visible = _visible_devices(device_type)
    n = num_devices if num_devices > 0 else visible
    if n > visible:
        raise ValueError(
            f"make_data_mesh({num_devices}): only {visible} {device_type} devices visible"
        )
    return make_mesh((n,), ("data",), device_type)


_ctx = threading.local()


def get_axis_rules() -> Optional[AxisRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def axis_rules_context(rules: AxisRules):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def logical_spec(*logical: Optional[str]) -> PartitionSpec:
    """Resolve logical names to a PartitionSpec under the active rules."""
    rules = get_axis_rules()
    if rules is None:
        return PartitionSpec(*([None] * len(logical)))
    return rules.resolve(logical)


class _Constrain(torch.autograd.Function):
    """A layout constraint on a value and on its gradient, as
    ``jax.lax.with_sharding_constraint``, whose transpose constrains the
    cotangent alike.  DTensor's own ``redistribute`` hands the gradient
    back in the input's layout instead: a partial sum then flows on
    through the backward, and the products it meets gather their weights
    rather than reduce it."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.target = mesh, target
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.target), None, None


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain an intermediate, and its gradient, to its logical sharding.

    No-op when no rules or mesh are active (one device), and for a plain
    tensor (one that no mesh distributes).  A ``DTensor`` is redistributed
    to the placements its logical names resolve to.
    """
    rules = get_axis_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = rules.resolve(logical, shape=x.shape)
    return _Constrain.apply(x, rules.mesh, placements(spec, rules.mesh))


def shard_map(
    fn: Any,
    in_axes: Sequence[Optional[Sequence[Optional[str]]]],
    out_axes: Any,
    *args: Any,
    partial: Sequence[str] = (),
    reduce_op: str = "sum",
) -> Any:
    """``fn(*args)`` on each rank's shards, the layout stated up front.

    ``in_axes`` names each argument's logical dims (None for a non-tensor
    or a replicated tensor); ``out_axes`` names the output's, or is a tuple
    of such names for a tuple of outputs.  Under active rules with a mesh,
    where an argument is a ``DTensor``, each argument is redistributed to
    its resolved layout and ``fn`` runs on the local shards (so every op in
    it works at the local shapes, as ``jax.experimental.shard_map`` does);
    an output dim is sharded where an input dim of the same name is, and
    the outputs are ``Partial`` over the mesh axes in ``partial`` (summed,
    or reduced by ``reduce_op``).
    A replicated argument's gradient is a partial sum over the mesh axes
    that split the work.  Without rules, a mesh or a ``DTensor`` argument it
    is ``fn(*args)``: one card and the CPU compute exactly that.

    The model states layouts this way where DTensor's sharding propagation
    has no rule for the ops (a batched product over dims that a reshape
    merged from two sharded dims, a size read from data) and where it would
    otherwise compute a replicated copy of work the reference shards.
    """
    rules = get_axis_rules()
    if rules is None or rules.mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = rules.mesh
    # A tensor the model made itself (a mask, positions) is replicated.
    args = tuple(
        DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
        for a in args
    )
    names: Dict[str, MeshAxes] = {}
    in_specs = []
    for a, axes in zip(args, in_axes):
        if not isinstance(a, torch.Tensor):
            in_specs.append(None)
            continue
        spec = rules.resolve(list(axes) if axes else [None] * a.dim(), shape=a.shape)
        for name, entry in zip(axes or (), spec):
            if name and entry is not None:
                names.setdefault(name, entry)
        in_specs.append(spec)
    split = {ax for spec in in_specs if spec is not None for entry in spec
             for ax in ((entry,) if isinstance(entry, str) else (entry or ()))}
    split = {ax for ax in split if dict(zip(mesh.mesh_dim_names, mesh.shape))[ax] > 1}

    def out_placements(axes: Sequence[Optional[str]]) -> List[Any]:
        # A list: local_map reads a tuple as one entry an output.
        spec = PartitionSpec(*(names.get(n) if n else None for n in axes))
        return [Partial(reduce_op) if ax in partial else p
                for ax, p in zip(mesh.mesh_dim_names, placements(spec, mesh))]

    in_pl, grad_pl = [], []
    for a, spec in zip(args, in_specs):
        if spec is None:
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(spec, mesh)
        in_pl.append(pl)
        grad_pl.append(tuple(Partial() if ax in split and not isinstance(p, Shard) else p
                             for ax, p in zip(mesh.mesh_dim_names, pl)))
    many = isinstance(out_axes, tuple) and out_axes and isinstance(out_axes[0], (tuple, list))
    out_pl = tuple(out_placements(o) for o in out_axes) if many else out_placements(out_axes)
    wrapped = local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                        in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                        redistribute_inputs=True)
    return wrapped(*args)

