"""Batched environments on tensors (PyTorch port of ``repro/rl/env.py``).

The JAX package writes an environment for one instance and ``vmap``s it over
the worker's envs; here every function takes the batch as a leading dim:
state fields are ``[N]`` tensors, ``obs`` is ``[N, obs_dim]``, and randomness
comes from an explicit ``torch.Generator`` on the env's device.

    reset(num_envs, generator, device) -> state, obs
    step_raw(state, action)            -> state', obs', reward, terminated, truncated
    step(state, action, generator)     -> state', obs', reward, done   (auto-reset)
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

__all__ = ["Env", "CartPole", "CartPoleState"]


class Env:
    """Protocol: subclasses define obs_dim / num_actions / reset / step_raw.

    ``step_raw`` is the auto-reset-free half of ``step``: it returns the
    *true* successor state/obs plus a terminated/truncated split.  ``step``
    keeps the auto-resetting semantics on top of it: lanes that ended take a
    fresh ``reset`` state, drawn for every lane and selected where done.
    """

    obs_dim: int
    num_actions: int  # -1 for continuous
    action_dim: int = 0

    def reset(
        self, num_envs: int, generator: torch.Generator, device: Any
    ) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step_raw(self, state: Any, action: torch.Tensor):
        """(state, action) -> (state', obs', reward, terminated, truncated)."""
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator):
        """Auto-resetting step: (state', obs', reward, done)."""
        new, obs, reward, terminated, truncated = self.step_raw(state, action)
        done = terminated | truncated
        reset_st, reset_obs = self.reset(action.shape[0], generator, action.device)
        out = type(new)(*(torch.where(done, a, b) for a, b in zip(reset_st, new)))
        obs = torch.where(done[:, None], reset_obs, obs)
        return out, obs, reward, done


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32 step count


class CartPole(Env):
    """Classic control CartPole-v0 dynamics (the paper's benchmark env)."""

    obs_dim = 4
    num_actions = 2
    max_steps = 200

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def reset(
        self, num_envs: int, generator: torch.Generator, device: Any
    ) -> Tuple[CartPoleState, torch.Tensor]:
        vals = torch.rand((num_envs, 4), generator=generator, device=device) * 0.1 - 0.05
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        st = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], t)
        return st, self._obs(st)

    @staticmethod
    def _obs(st: CartPoleState) -> torch.Tensor:
        return torch.stack([st.x, st.x_dot, st.theta, st.theta_dot], dim=-1)

    def step_raw(self, st: CartPoleState, action: torch.Tensor):
        force = torch.where(action == 1, self.force_mag, -self.force_mag).to(st.x.dtype)
        costheta, sintheta = torch.cos(st.theta), torch.sin(st.theta)
        temp = (force + self.polemass_length * st.theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        new = CartPoleState(
            st.x + self.tau * st.x_dot,
            st.x_dot + self.tau * xacc,
            st.theta + self.tau * st.theta_dot,
            st.theta_dot + self.tau * thetaacc,
            st.t + 1,
        )
        terminated = (torch.abs(new.x) > self.x_threshold) | (
            torch.abs(new.theta) > self.theta_threshold
        )
        truncated = (new.t >= self.max_steps) & ~terminated
        reward = torch.ones_like(new.x)
        return new, self._obs(new), reward, terminated, truncated
