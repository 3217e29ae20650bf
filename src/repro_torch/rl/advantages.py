"""Generalized Advantage Estimation (PyTorch port of ``repro/rl/advantages.py``).

``gae`` is a plain reverse-time loop over time-major tensors: the plain
version of the hand-written GAE kernel (``repro_torch.kernels.advantages``)
and the path ``repro_torch.kernels.ops.fused_gae`` takes for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gae"]


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation; returns (advantages, value_targets).

    Time-major ``[T, ...]`` inputs, ``last_value`` ``[...]`` bootstraps the
    step after the last one.
    """
    dones_f = dones.to(rewards.dtype)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * (1.0 - dones_f) * next_values - values
    advantages = torch.empty_like(deltas)
    carry = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * (1.0 - dones_f[t]) * carry
        advantages[t] = carry
    return advantages, advantages + values
