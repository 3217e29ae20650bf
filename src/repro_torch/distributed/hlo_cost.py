"""The cost walker: FLOPs, bytes and collectives of the ops a step
dispatches (PyTorch port of ``repro/distributed/hlo_cost.py``).

The reference walks the optimized HLO of a compiled step.  The port has no
HLO: it runs the step once under ``FakeTensorMode`` (so no op runs on any
device, and the published widths cost no memory) inside a
``TorchDispatchMode`` that prices every aten op the step dispatches:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention; elementwise ops count none, as the reference's dot-only
    count);
  * bytes: each op's tensor inputs read once plus its outputs written
    once.  A view moves nothing, so a loop that reads one row of a stack a
    step charges row bytes, not the stack (the counterpart of the
    reference's slice-aware fusion parameters);
  * collectives: the result-buffer bytes of each functional collective
    (all-gather, all-reduce, reduce-scatter, all-to-all), by kind.

Each hand-written kernel that ``kernels/ops.py`` (or the threefry hash in
``kernels/threefry.py``) dispatches is priced as one op: the FLOPs and
bytes of the formula ``chip_smoke.py`` holds that kernel's bound to, on the
CPU and on the card alike.  Under the walker the wrapper launches nothing
and returns uninitialised outputs of the right shape; a kernel with a
backward charges the backward kernel's formula when autograd reaches it.
Outside the walker the wrappers pay one attribute check a call
(``LOCAL.walker``, thread-local).  A step whose control flow branches on its
data (the LM policy's prefill-or-decode choice) cannot run on fake
tensors; ``analyze_step(..., execute=True)`` prices it on a real run,
kernels launched, with the same formulas.  That mode prices forward work
only: a kernel whose backward autograd would run later, outside the
walker, makes it raise (a train step is priced on fake tensors).

A DTensor op is left to DTensor (the mode returns ``NotImplemented``, as
``CommDebugMode`` does), so the walker sees the local ops and collectives
of one device, rank 0's: the numbers are per device, as the reference's
per-device SPMD module is.  DTensor works out an op's output shape by
running the op once on fake tensors of the global shapes (its sharding
propagator, cached per op and input layout); the walker prices none of
those runs, which compute nothing on any rank.  A loop runs its body as
often as the step does, so there are no trip counts to recover, but for a
chunked time scan on fake tensors (``models/scan_utils.py``): every chunk
computes the same shapes, so its first chunk runs and is priced once a
chunk, backward included (``CostMode.repeated``), as the reference's
walker multiplies a loop body by its trip count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "KernelCharge", "CostMode", "analyze_step", "LOCAL", "KERNEL_COSTS"]

class _Local(threading.local):
    walker: Optional["CostMode"] = None


# The walker pricing a step on this thread, if any; the kernels' wrappers
# check ``LOCAL.walker`` once a call.  Thread-local: a rollout thread of the
# same process keeps running its kernels while the driver prices a step.
LOCAL = _Local()

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

# Ops that move no bytes: allocation without a write, aliasing, metadata.
_FREE = {
    "empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "_local_scalar_dense", "device", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "set_", "resize_", "_unsafe_view",
}


@dataclasses.dataclass
class KernelCharge:
    """One hand-written kernel launch as the walker priced it."""

    name: str
    flops: float
    bytes: float
    int_ops: float = 0.0
    key: Dict[str, Any] = dataclasses.field(default_factory=dict)  # the sizes priced


@dataclasses.dataclass
class OpCost:
    """A step's counted cost (per device)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    num_ops: int = 0
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)  # [count, flops, bytes]
    kernels: List[KernelCharge] = dataclasses.field(default_factory=list)

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.num_ops += 1
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


def _bytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


# ------------------------------------------------------------ kernel formulas
# Each takes the sizes one launch runs at (a plan's ``key``) and returns
# (flops, bytes, int_ops) of the forward launch, and of the backward's where
# the kernel has one: the counts ``chip_smoke.py`` computes its bounds from.
# ``es`` is the operands' element size in bytes, a key only where it is not
# 4 (the bf16 kernels: 2); statistics such as the flash forward's lse stay
# float32.
def visible_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(pos, sk - 1) if causal else sk - 1
        lo = max(pos - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def gae_cost(tb: int, b: int) -> Tuple:
    return 8 * tb, (5 * tb + b) * 4, 0


def vtrace_cost(tb: int, b: int) -> Tuple:
    return 20 * tb, (5 * tb + b) * 4 + 2 * tb * 4, 0


def surrogate_costs(b: int, a: int) -> Tuple[Tuple, Tuple]:
    row_in = 4 * 4 + 8  # four float [B] vectors and the int64 action
    fwd = (b * (6 * a + 20), b * (4 * a + row_in) + b * 5 * 4, 0)
    bwd = (b * (16 * a + 40), b * (4 * a + row_in + 2 * 4 + 4 * 4) + b * (4 * a + 4 * 4), 0)
    return fwd, bwd


def flash_costs(b: int, sq: int, sk: int, h: int, kv: int, d: int, causal: bool, window: int,
                q_offset: int, es: int = 4) -> Tuple[Tuple, Tuple]:
    pairs = visible_pairs(sq, sk, causal, window, q_offset)
    fwd = (4 * b * h * d * pairs, (2 * b * sq * h * d + 2 * b * sk * kv * d) * es + b * h * sq * 4, 0)
    bwd = (10 * b * h * d * pairs, (4 * b * sq * h * d + 4 * b * sk * kv * d) * es + b * h * sq * 4, 0)
    return fwd, bwd


def decode_cost(b: int, h: int, kv: int, d: int, w: int, n_valid: int, mask: int,
                es: int = 4) -> Tuple:
    return 4 * h * d * n_valid, (2 * b * h * d + 2 * n_valid * kv * d) * es + mask, 0


def rwkv6_costs(b: int, t: int, h: int, n: int, state: bool, chunk: int,
                es: int = 4) -> Tuple[Tuple, Tuple]:
    seq, st = b * t * h * n * es, b * h * n * n * 4  # u and the states stay fp32
    ck = b * h * -(-t // chunk) * n * n * 4
    s0 = st if state else 0
    fwd = (7 * b * t * h * n * n, 5 * seq + h * n * 4 + st + ck + s0, 0)
    bwd = (14 * b * t * h * n * n, 9 * seq + 2 * h * n * 4 + st + ck + s0, 0)
    return fwd, bwd


def gmm_cost(t: int, d: int, f: int, e: int, es: int = 4) -> Tuple:
    return 2 * t * d * f, es * (t * d + e * d * f + t * f), 0


THREEFRY_ALU_OPS = 41  # the bound's int32 ALU instructions a hash (chip_smoke.py)


def threefry_cost(lanes: int, n: int, xor: bool) -> Tuple:
    return 0, 16 * lanes + lanes * n * (8 if xor else 16), lanes * n * (THREEFRY_ALU_OPS + int(xor))


def fold_in_cost(lanes: int) -> Tuple:
    return 0, lanes * (16 + 8 + 16), lanes * THREEFRY_ALU_OPS


# ------------------------------------------------------------------ walker
def _placeholder(spec: Tuple) -> torch.Tensor:
    """An uninitialised tensor for ``spec = (like, shape, dtype, dim_map)``:
    on ``like``'s device, and, where ``like`` is a DTensor, on its mesh with
    its shardings carried over by ``dim_map`` (output dim of each input
    dim; dims left out are replicated)."""
    like, shape, dtype, dim_map = spec
    if _is_dtensor(like):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        placements = [
            Shard(dim_map[p.dim]) if isinstance(p, Shard) and p.dim in dim_map else Replicate()
            for p in like.placements
        ]
        full = torch.empty(shape, dtype=dtype, device=like.device)
        return distribute_tensor(full, like.device_mesh, placements)
    return torch.empty(shape, dtype=dtype, device=like.device)


class _Charged(torch.autograd.Function):
    """A kernel's outputs under the walker: placeholders forward, zero
    gradients backward, with the backward kernel's formula charged when
    autograd reaches it."""

    @staticmethod
    def forward(ctx, walker, name, bwd, out_specs, *inputs):
        ctx.walker, ctx.name, ctx.bwd = walker, name, bwd
        ctx.save_for_backward(*[x for x in inputs if isinstance(x, torch.Tensor)])
        outs = tuple(_placeholder(s) for s in out_specs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        bwd, key = ctx.bwd
        ctx.walker.charge(ctx.name + "_bwd", *bwd, key=key)
        with ctx.walker.suspended():
            g = [torch.zeros_like(x) for x in ctx.saved_tensors]
        return (None, None, None, None, *g)


class _ScaleBackward(torch.autograd.Function):
    """An identity whose backward multiplies (``on``) or divides the
    walker's pricing factor: placed on a loop body's outputs and on its
    inputs, it prices the body's backward, which autograd runs between the
    two, that many times."""

    @staticmethod
    def forward(ctx, walker, times, on, *xs):
        ctx.walker, ctx.times, ctx.on = walker, times, on
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        w = ctx.walker
        w._times = w._times * ctx.times if ctx.on else w._times // ctx.times
        return (None, None, None, *grads)


class CostMode(TorchDispatchMode):
    """Prices every op dispatched inside it into ``self.cost``."""

    def __init__(self, execute: bool = False):
        super().__init__()
        self.cost = OpCost()
        self.execute = execute
        self._suspend = 0
        self._times = 1  # each op priced this many times (``repeated``)

    # -------------------------------------------------------------- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_call(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._suspend:
            self._price(func, args, kwargs, out)
        return out

    def _price(self, func: Any, args: tuple, kwargs: dict, out: Any) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        name = packet.__name__
        if name in _FREE or getattr(func, "is_view", False):
            return
        out_bytes = sum(_bytes(t) for t in _tensors(out))
        kind = _COLLECTIVE_KINDS.get(name) if "c10d" in packet._qualified_op_name else None
        times = self._times
        if kind is not None:
            c = self.cost
            c.coll_bytes += out_bytes * times
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + out_bytes * times
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + times
            return
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        in_bytes = sum(_bytes(t) for t in _tensors((args, kwargs)))
        for _ in range(times):
            self.cost._add(name, float(flops), float(in_bytes + out_bytes))

    # ---------------------------------------------------------------- kernels
    @contextlib.contextmanager
    def suspended(self):
        """Ops dispatched inside are not priced (a kernel's own work)."""
        self._suspend += 1
        try:
            yield
        finally:
            self._suspend -= 1

    def charge(self, name: str, flops: float, nbytes: float, int_ops: float = 0,
               key: Optional[Dict[str, Any]] = None) -> None:
        for _ in range(self._times):
            self.cost.kernels.append(
                KernelCharge(name, float(flops), float(nbytes), float(int_ops), dict(key or {})))
            self.cost._add(name, float(flops), float(nbytes))

    def repeated(self, times: int, fn: Callable, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``fn(*args)`` (a tuple of tensors) run once and priced ``times``
        times, its backward too: one iteration of a loop whose iterations
        compute the same shapes, priced as the reference's walker prices a
        loop body times its trip count.  For fake tensors only, whose values
        nothing reads.  The backward is scaled where autograd reaches the
        inputs (``args``) from the outputs; a body whose inputs need no
        gradient has its backward priced once."""
        track = torch.is_grad_enabled() and any(a.requires_grad for a in args)
        if track:
            args = _ScaleBackward.apply(self, times, False, *args)
        with self._scaled(times):
            out = tuple(fn(*args))
        return _ScaleBackward.apply(self, times, True, *out) if track else out

    @contextlib.contextmanager
    def _scaled(self, times: int):
        before, self._times = self._times, self._times * times
        try:
            yield
        finally:
            self._times = before

    def kernel(self, name: str, *args: Any, **kwargs: Any) -> Any:
        """Kernel ``name`` on these inputs, charged at its formula
        (``KERNEL_COSTS``).  Its outputs are placeholders of the right shape
        (nothing computes them), or, when the walker executes, the
        kernel's own (its wrapper runs, unpriced inside)."""
        key, fwd, bwd, grad_inputs, out_specs = KERNEL_COSTS[name](*args, **kwargs)
        differentiable = bwd is not None and torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in grad_inputs
        )
        if self.execute and differentiable:
            raise NotImplementedError(
                f"the cost walker's execute mode cannot price {name}'s backward, which autograd "
                "runs after the walker; price a train step on fake tensors (execute=False)"
            )
        self.charge(name, *fwd, key=key)
        if self.execute:
            LOCAL.walker = None
            try:
                with self.suspended():
                    return _real_kernel(name)(*args, **kwargs)
            finally:
                LOCAL.walker = self
        with self.suspended():
            if differentiable:
                return _Charged.apply(self, name, (bwd, key), list(out_specs), *grad_inputs)
            outs = tuple(_placeholder(s) for s in out_specs)
            return outs if len(outs) > 1 else outs[0]

    def __enter__(self):
        _unpriced_shape_propagation()
        self._prev_walker = LOCAL.walker
        LOCAL.walker = self
        return super().__enter__()

    def __exit__(self, *exc):
        LOCAL.walker = self._prev_walker
        return super().__exit__(*exc)


_PROPAGATION_WRAPPED = False


def _unpriced_shape_propagation() -> None:
    """Wrap DTensor's global-shape meta propagation once so that a walker
    on the calling thread does not price it (it dispatches the op at the
    global shapes, under fake tensors, to read the output's shape)."""
    global _PROPAGATION_WRAPPED
    if _PROPAGATION_WRAPPED:
        return
    _PROPAGATION_WRAPPED = True
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:  # pragma: no cover - a torch without DTensor
        return
    original = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", None)
    if original is None:  # pragma: no cover - a torch that propagates elsewhere
        return

    def propagate(self, op_schema):
        walker = LOCAL.walker
        if walker is None:
            return original(self, op_schema)
        with walker.suspended():
            return original(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate


def _real_kernel(name: str) -> Callable:
    """The dispatch function that runs kernel ``name`` (CUDA kernel or plain
    version by the inputs' device)."""
    from repro_torch.kernels import ops, threefry

    if name == "ppo_surrogate":
        from repro_torch.kernels.surrogate import ppo_surrogate_cuda, ppo_surrogate_plain

        return lambda logits, *a, **kw: (
            ppo_surrogate_cuda if logits.is_cuda else ppo_surrogate_plain)(logits, *a, **kw)
    return {
        "gae": ops.fused_gae, "vtrace": ops.fused_vtrace, "flash_attention": ops.flash_attention,
        "decode_attention": ops.decode_attention, "rwkv6": ops.rwkv6, "moe_gmm": ops.moe_gmm,
        "moe_gmm_dx": ops.moe_gmm_dx, "moe_gmm_dw": ops.moe_gmm_dw,
        "threefry_counts": threefry.hash_counts, "threefry_fold_in": threefry.fold_in,
    }[name]


def _dtensor_type() -> Optional[type]:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover - a torch without distributed
        return None
    return DTensor


def _is_dtensor_call(types: Sequence[type]) -> bool:
    dt = _dtensor_type() if types else None
    return dt is not None and any(issubclass(t, dt) for t in types)


def _is_dtensor(x: Any) -> bool:
    dt = _dtensor_type()
    return dt is not None and isinstance(x, dt)


def _local(x: Any) -> Any:
    """A DTensor's shard on this rank (the walker prices one device)."""
    return x.to_local() if _is_dtensor(x) else x


# ------------------------------------------------- the kernels, under the walker
def _like(x: torch.Tensor, shape: Optional[Sequence[int]] = None, dtype: Any = None,
          dim_map: Optional[Dict[int, int]] = None) -> Tuple:
    """An output spec for ``_placeholder``: same shape, dtype and shardings
    as ``x`` unless told otherwise."""
    same = shape is None
    return (x, tuple(x.shape) if same else tuple(shape), dtype or x.dtype,
            {d: d for d in range(x.dim())} if same and dim_map is None else (dim_map or {}))


def _es(x: torch.Tensor) -> dict:
    """``{"es": element size}`` for operands that are not 4 bytes an element."""
    size = x.element_size()
    return {} if size == 4 else {"es": size}


# Each plan returns (key, forward cost, backward cost or None, the inputs
# a backward reaches, output specs).
def _plan_gae(rewards, values, dones, last_value, gamma=0.99, lam=0.95):
    key = dict(tb=_local(rewards).numel(), b=_local(last_value).numel())
    return key, gae_cost(**key), None, (), [_like(rewards), _like(rewards)]


def _plan_vtrace(behaviour_logp, target_logp, rewards, values, dones, last_value, **_kw):
    key = dict(tb=_local(rewards).numel(), b=_local(last_value).numel())
    return key, vtrace_cost(**key), None, (), [_like(rewards), _like(rewards)]


def _plan_surrogate(logits, values, actions, behaviour_logp, advantages, returns, clip_eps=0.2):
    b, a = _local(logits).shape
    key = dict(b=b, a=a)
    return (key, *surrogate_costs(**key), (logits, values), [_like(values)] * 4)


def _plan_flash(q, k, v, causal=True, window=0, q_offset=0):
    (b, sq, h, d), (sk, kv) = _local(q).shape, _local(k).shape[1:3]
    key = dict(b=b, sq=sq, sk=sk, h=h, kv=kv, d=d, causal=bool(causal), window=int(window),
               q_offset=int(q_offset), **_es(q))
    return (key, *flash_costs(**key), (q, k, v), [_like(q)])


def _plan_decode(q, k_cache, v_cache, valid):
    """The slots the mask marks valid, as ``chip_smoke.py`` counts them; on
    fake tensors, whose values are not known, every slot."""
    from torch._subclasses.fake_tensor import FakeTensor

    (b, _, h, d), (w, kv) = _local(q).shape, _local(k_cache).shape[1:3]
    mask = _local(valid)
    if isinstance(mask, FakeTensor):
        n_valid = b * w
    else:
        n_valid = int(mask.sum()) * (b if mask.dim() == 1 else 1)
    key = dict(b=b, h=h, kv=kv, d=d, w=w, n_valid=n_valid, mask=mask.numel(), **_es(q))
    return key, decode_cost(**key), None, (), [_like(q)]


def _plan_rwkv6(r, k, v, w, u, state=None, chunk=64):
    b, t, h, n = _local(r).shape
    key = dict(b=b, t=t, h=h, n=n, state=state is not None, chunk=int(chunk), **_es(r))
    bg, _, hg, ng = r.shape
    ins = (r, k, v, w, u) if state is None else (r, k, v, w, u, state)
    return (key, *rwkv6_costs(**key), ins,
            [_like(r), _like(r, (bg, hg, ng, ng), dim_map={0: 0, 2: 1, 3: 2})])


def _plan_gmm(x, w, group_sizes):
    (t, d), (e, _, f) = _local(x).shape, _local(w).shape
    key = dict(t=t, d=d, f=f, e=e, **_es(x))
    return key, gmm_cost(**key), None, (), [_like(x, (x.shape[0], w.shape[2]), dim_map={0: 0})]


def _plan_gmm_dx(dy, w, group_sizes):
    (t, f), (e, d, _) = _local(dy).shape, _local(w).shape
    key = dict(t=t, d=d, f=f, e=e, **_es(dy))
    return key, gmm_cost(**key), None, (), [_like(dy, (dy.shape[0], w.shape[1]), dim_map={0: 0})]


def _plan_gmm_dw(x, dy, group_sizes):
    (t, d), f, e = _local(x).shape, _local(dy).shape[1], group_sizes.shape[0]
    key = dict(t=t, d=d, f=f, e=e, **_es(x))
    shape = (group_sizes.shape[0], x.shape[1], dy.shape[1])
    return key, gmm_cost(**key), None, (), [_like(x, shape, dim_map={})]


def _plan_hash_counts(keys, n, xor):
    lead = tuple(keys.shape[:-1])
    key = dict(lanes=math.prod(lead), n=int(n), xor=bool(xor))
    shape = lead + ((int(n),) if xor else (int(n), 2))
    return key, threefry_cost(**key), None, (), [_like(keys, shape, torch.int64, {})]


def _plan_fold_in(keys, data):
    data_shape = tuple(data.shape) if isinstance(data, torch.Tensor) else ()
    lead = tuple(torch.broadcast_shapes(tuple(keys.shape[:-1]), data_shape))
    key = dict(lanes=math.prod(lead))
    return key, fold_in_cost(**key), None, (), [_like(keys, lead + (2,), torch.int64, {})]


KERNEL_COSTS: Dict[str, Callable] = {
    "gae": _plan_gae,
    "vtrace": _plan_vtrace,
    "ppo_surrogate": _plan_surrogate,
    "flash_attention": _plan_flash,
    "decode_attention": _plan_decode,
    "rwkv6": _plan_rwkv6,
    "moe_gmm": _plan_gmm,
    "moe_gmm_dx": _plan_gmm_dx,
    "moe_gmm_dw": _plan_gmm_dw,
    "threefry_counts": _plan_hash_counts,
    "threefry_fold_in": _plan_fold_in,
}


def analyze_step(fn: Callable, *args: Any, execute: bool = False,
                 **kwargs: Any) -> Tuple[OpCost, Any]:
    """(cost, output) of ``fn(*args, **kwargs)`` run on fake tensors (real
    tensor arguments are faked on entry; nothing runs on any device).

    ``execute=True`` runs it for real instead, kernels included, and prices
    the same ops: the way to price a forward step whose control flow
    depends on its data (a fake tensor has no values to branch on).  It
    raises ``NotImplementedError`` where a kernel's input requires grad,
    since the backward would run after the walker, unpriced."""
    if execute:
        with CostMode(execute=True) as mode:
            out = fn(*args, **kwargs)
        return mode.cost, out
    from repro_torch.launch.input_specs import fake_mode

    with fake_mode():
        with CostMode() as mode:
            out = fn(*args, **kwargs)
    return mode.cost, out
