"""Advantage estimators: discounted returns, GAE, V-trace (PyTorch port of
``repro/rl/advantages.py``).

Each is a plain reverse-time loop over time-major tensors.  ``gae`` and
``vtrace`` are the plain versions of the hand-written kernels
(``repro_torch.kernels.advantages``) and the paths
``repro_torch.kernels.ops.fused_gae`` / ``fused_vtrace`` take for CPU
tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["discounted_returns", "gae", "vtrace"]


def discounted_returns(
    rewards: torch.Tensor, dones: torch.Tensor, last_value: torch.Tensor, gamma: float
) -> torch.Tensor:
    """R_t = r_t + gamma * (1 - done_t) * R_{t+1};  time-major [T, ...]."""
    dones_f = dones.to(rewards.dtype)
    returns = torch.empty_like(rewards)
    carry = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * (1.0 - dones_f[t]) * carry
        returns[t] = carry
    return returns


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


def vtrace(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets (IMPALA, Espeholt et al. 2018).

    Returns (vs, pg_advantages); all inputs time-major [T, ...].  Built
    from differentiable operations (no in-place writes into a tensor that
    autograd saves), so a caller decides what is stop-gradient.
    """
    rhos = torch.exp(target_logp - behaviour_logp)
    clipped_rhos = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    dones_f = dones.to(rewards.dtype)
    discounts = gamma * (1.0 - dones_f)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(last_value)
    vs_minus_v = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v.append(acc)
    vs = torch.stack(vs_minus_v[::-1]) + values
    next_vs = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = clipped_rhos * (rewards + discounts * next_vs - values)
    return vs, pg_adv
