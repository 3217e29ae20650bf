"""Functional optimizers over parameter trees of tensors (PyTorch port).

Same surface as ``repro/optim/optimizers.py``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply`` adds the
updates.  Written by hand rather than on ``torch.optim`` so the numerics are
the reference's step for step: the learning rate is read at the
pre-increment step and the bias correction uses the post-increment step.

The step counter lives on the host as a Python int, so a step never waits
for the device; the bias-correction scales are computed in float32 on the
host, as the reference computes them in float32 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

PyTree = Any
Schedule = Callable[[int], float]

__all__ = ["Optimizer", "AdamState", "adam", "constant_schedule"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]

    def apply(self, params: PyTree, grads: PyTree, state: PyTree) -> Tuple[PyTree, PyTree]:
        updates, state = self.update(grads, state, params)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        return params, state


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def _as_schedule(lr: Any) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


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

    return Optimizer(init, update)
