"""Functional optimizers over parameter trees of tensors (PyTorch port).

Same surface as ``repro/optim/optimizers.py``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply`` adds the
updates.  Written by hand rather than on ``torch.optim`` so the numerics are
the reference's step for step: the learning rate is read at the
pre-increment step and the bias correction uses the post-increment step.

``apply_`` is the in-place form for a learner at full model width.  The
functional step holds old and new parameters, gradients, clipped gradients,
old and new moments and the updates at once: for a 2.9 B-parameter model in
float32 that is about 103 GB, more than one 80 GB card.  The reference
avoids the copies by donating the parameter and state buffers to its jitted
step (``repro/core/spmd.py``); ``apply_`` is the port's counterpart.  It
computes the global-norm clip scale first (one scalar), then walks the
leaves one at a time, updating the moments and the parameter in place with
the functional form's operations in its order (so the two agree bit for
bit), and drops each leaf's gradient once it is used.

The step counter lives on the host as a Python int, so a step never waits
for the device; the bias-correction scales are computed in float32 on the
host, as the reference computes them in float32 on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[int], float]
# In-place step: (parameter leaves, gradient leaves, state, clip scale or
# None) -> new state; see ``Optimizer.apply_``.
InPlace = Callable[[List[torch.Tensor], List[Optional[torch.Tensor]], PyTree, Any], PyTree]

__all__ = [
    "Optimizer",
    "AdamState",
    "SgdState",
    "adam",
    "adamw",
    "sgd",
    "chain_clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    inplace: Optional[InPlace] = None

    def apply(self, params: PyTree, grads: PyTree, state: PyTree) -> Tuple[PyTree, PyTree]:
        updates, state = self.update(grads, state, params)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        return params, state

    def apply_(self, params: PyTree, grads: List[Optional[torch.Tensor]], state: PyTree) -> PyTree:
        """Update ``params``' tensors and the state's moments in place and
        return the new state.  ``grads`` is a list of the gradients in
        ``tree_leaves(params)`` order; each entry is set to None once used,
        so the caller's list holds no gradient when the step ends."""
        with torch.no_grad():
            return self.inplace(tree_leaves(params), grads, state, None)


def _scaled(grads: List[Optional[torch.Tensor]], i: int, scale: Any) -> torch.Tensor:
    """Take gradient ``i`` out of the list, times the clip scale if any."""
    g, grads[i] = grads[i], None
    return g if scale is None else g * scale


# ------------------------------------------------------------------ schedules
# The reference computes schedules in float32 on the device from an int32
# step; these compute the same in numpy float32 on the host.
def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    f32 = np.float32

    def f(step: int) -> float:
        t = min(f32(step) / f32(total_steps), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t, dtype=np.float32))
        return float(f32(lr) * (f32(final_frac) + f32(1 - final_frac) * cos))

    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1))

    def f(step: int) -> float:
        if step < warmup:
            return float(np.float32(lr) * np.float32(step + 1) / np.float32(max(warmup, 1)))
        return cos(step - warmup)

    return f


def _as_schedule(lr: Any) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


class SgdState(NamedTuple):
    step: int
    momentum: PyTree  # None without momentum


def sgd(lr: Any, momentum: float = 0.0) -> Optimizer:
    """Plain or heavy-ball SGD; momentum buffers in fp32."""
    sched = _as_schedule(lr)

    def init(params: PyTree) -> SgdState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return SgdState(0, tree_map(zeros, params) if momentum else None)

    def update(grads: PyTree, state: SgdState, params: PyTree):
        lr_t = sched(state.step)
        if momentum:
            new_mom = tree_map(lambda m, g: momentum * m + g.float(), state.momentum, grads)
            return tree_map(lambda m: -lr_t * m, new_mom), SgdState(state.step + 1, new_mom)
        return tree_map(lambda g: -lr_t * g.float(), grads), SgdState(state.step + 1, None)

    def inplace(params, grads, state: SgdState, scale) -> SgdState:
        lr_t = sched(state.step)
        moms = tree_leaves(state.momentum) if momentum else [None] * len(params)
        for i, (p, m) in enumerate(zip(params, moms)):
            g = _scaled(grads, i, scale).float()
            if momentum:
                m.mul_(momentum).add_(g)
                g = m
            p.add_(-lr_t * g)
        return SgdState(state.step + 1, state.momentum)

    return Optimizer(init, update, inplace)


class AdamState(NamedTuple):
    step: int
    mu: PyTree
    nu: PyTree


def adam(
    lr: Any, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0
) -> Optimizer:
    """Adam / AdamW. Moments kept in fp32 regardless of param dtype."""
    sched = _as_schedule(lr)

    def init(params: PyTree) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    def update(grads: PyTree, state: AdamState, params: PyTree):
        step = state.step + 1
        lr_t = sched(state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        one, s = np.float32(1.0), np.float32(step)
        mu_hat_scale = float(one / (one - np.float32(b1) ** s))
        nu_hat_scale = float(one / (one - np.float32(b2) ** s))

        def _upd(m, v, p):
            u = -lr_t * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u

        updates = tree_map(_upd, mu, nu, params)
        return updates, AdamState(step, mu, nu)

    def inplace(params, grads, state: AdamState, scale) -> AdamState:
        step = state.step + 1
        lr_t = sched(state.step)
        one, s = np.float32(1.0), np.float32(step)
        mu_hat_scale = float(one / (one - np.float32(b1) ** s))
        nu_hat_scale = float(one / (one - np.float32(b2) ** s))
        for i, (p, m, v) in enumerate(zip(params, tree_leaves(state.mu), tree_leaves(state.nu))):
            g = _scaled(grads, i, scale).float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            u = -lr_t * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            p.add_(u)
        return AdamState(step, state.mu, state.nu)

    return Optimizer(init, update, inplace)


def adamw(lr: Any, weight_decay: float = 0.01, **kw: Any) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def _clip_scale(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def chain_clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping.  The scale
    stays a device scalar, so a step never waits for the device."""

    def update(grads: PyTree, state: PyTree, params: PyTree):
        scale = _clip_scale(tree_leaves(grads), max_norm)
        return opt.update(tree_map(lambda g: g * scale, grads), state, params)

    def inplace(params, grads, state, scale):
        if scale is not None:
            raise ValueError("chain_clip_by_global_norm: the wrapped optimizer is clipped already")
        return opt.inplace(params, grads, state, _clip_scale(grads, max_norm))

    return Optimizer(opt.init, update, inplace if opt.inplace is not None else None)
