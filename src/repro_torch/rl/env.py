"""Batched environments on tensors (PyTorch port of ``repro/rl/env.py``).

The JAX package writes an environment for one instance and ``vmap``s it over
the worker's envs; here every function takes the batch as a leading dim:
state fields are ``[N]`` tensors, ``obs`` is ``[N, obs_dim]``, and randomness
comes from an explicit ``torch.Generator`` on the env's device.

    reset(num_envs, generator, device) -> state, obs
    step_raw(state, action)            -> state', obs', reward, terminated, truncated
    step(state, action, generator)     -> state', obs', reward, done   (auto-reset)

``VectorEnv`` wraps an env for the vectorized rollout engine: auto-reset,
the true pre-reset successor obs, the terminated/truncated split, and
per-lane episode accounting, with a checkpointable state.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["Env", "CartPole", "CartPoleState", "VectorEnv", "VectorEnvState", "VectorStep"]


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


# --------------------------------------------------------------- VectorEnv
class VectorEnvState(NamedTuple):
    """Everything the vectorized rollout engine carries between steps.

    ``rng`` is the generator the auto-resets draw from (the reference keeps
    one PRNG key per lane there); ``eps_count`` counts completed episodes per
    lane so fragment assembly can stamp globally unique episode ids.
    ``VectorEnv.state_to_numpy`` makes the whole state, generator included,
    a picklable checkpoint payload.
    """

    env_state: Any           # batched env state, leading dim N
    obs: torch.Tensor        # [N, obs_dim] current (post-reset) observations
    rng: torch.Generator     # auto-reset randomness
    ep_return: torch.Tensor  # [N] running episode returns
    ep_len: torch.Tensor     # [N] running episode lengths
    eps_count: torch.Tensor  # [N] int32 completed-episode counter per lane


class VectorStep(NamedTuple):
    """Per-step outputs of ``VectorEnv.step`` (all leading dim N)."""

    obs: torch.Tensor         # post-auto-reset obs (what the policy sees next)
    next_obs: torch.Tensor    # TRUE successor obs (pre-reset; bootstrap source)
    reward: torch.Tensor
    terminated: torch.Tensor  # bool: env death (zero bootstrap)
    truncated: torch.Tensor   # bool: horizon cut (bootstrap from next_obs value)
    done: torch.Tensor        # terminated | truncated (auto-reset happened)
    completed_return: torch.Tensor  # episode return where done, else 0
    eps_count: torch.Tensor   # int32 episode index each lane was in THIS step


class VectorEnv:
    """N synchronized lanes of a batched env with auto-reset semantics.

    Auto-reset is owned here (via ``env.step_raw``), so both the true
    successor obs (for bootstrap) and the post-reset obs (for the next
    action) are exposed.  Every step draws a reset for every lane from the
    state's generator and keeps it where the lane ended, so the generator
    advances the same way whichever lanes end.
    """

    def __init__(self, env: Env, num_envs: int):
        if num_envs < 1:
            raise ValueError(f"VectorEnv needs num_envs >= 1 (got {num_envs})")
        self.env = env
        self.num_envs = num_envs
        self.obs_dim = env.obs_dim
        self.num_actions = env.num_actions
        self.action_dim = getattr(env, "action_dim", 0)

    # ---------------------------------------------------------------- reset
    def reset(self, generator: torch.Generator) -> VectorEnvState:
        """Fresh lanes on the generator's device; the state keeps the
        generator for its auto-resets."""
        device = generator.device
        env_state, obs = self.env.reset(self.num_envs, generator, device)
        n = self.num_envs
        return VectorEnvState(
            env_state=env_state,
            obs=obs,
            rng=generator,
            ep_return=torch.zeros((n,), dtype=torch.float32, device=device),
            ep_len=torch.zeros((n,), dtype=torch.int32, device=device),
            eps_count=torch.zeros((n,), dtype=torch.int32, device=device),
        )

    # ----------------------------------------------------------------- step
    def step(self, state: VectorEnvState, actions: torch.Tensor) -> Tuple[VectorEnvState, VectorStep]:
        new_env, next_obs, reward, terminated, truncated = self.env.step_raw(state.env_state, actions)
        done = terminated | truncated
        reset_env, reset_obs = self.env.reset(self.num_envs, state.rng, state.obs.device)
        env_state = type(new_env)(
            *(
                torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(reset_env, new_env)
            )
        )
        obs = torch.where(done[:, None], reset_obs, next_obs)
        new_ret = state.ep_return + reward
        out = VectorStep(
            obs=obs,
            next_obs=next_obs,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            done=done,
            completed_return=torch.where(done, new_ret, 0.0),
            eps_count=state.eps_count,
        )
        new_state = VectorEnvState(
            env_state=env_state,
            obs=obs,
            rng=state.rng,
            ep_return=torch.where(done, 0.0, new_ret),
            ep_len=torch.where(done, 0, state.ep_len + 1),
            eps_count=state.eps_count + done.to(torch.int32),
        )
        return new_state, out

    # ----------------------------------------------------------- durability
    @staticmethod
    def state_to_numpy(state: VectorEnvState) -> VectorEnvState:
        """Device state -> picklable numpy state (checkpoint payload); the
        generator becomes its state bytes."""
        host = lambda x: x.detach().cpu().numpy()
        es = state.env_state
        return VectorEnvState(
            env_state=type(es)(*(host(x) for x in es)),
            obs=host(state.obs),
            rng=state.rng.get_state().numpy(),
            ep_return=host(state.ep_return),
            ep_len=host(state.ep_len),
            eps_count=host(state.eps_count),
        )

    @staticmethod
    def state_from_numpy(state: VectorEnvState, device: Any) -> VectorEnvState:
        device = torch.device(device)
        dev = lambda x: torch.as_tensor(np.asarray(x), device=device)
        rng = torch.Generator(device=device)
        rng.set_state(torch.as_tensor(np.asarray(state.rng, dtype=np.uint8)))
        es = state.env_state
        return VectorEnvState(
            env_state=type(es)(*(dev(x) for x in es)),
            obs=dev(state.obs),
            rng=rng,
            ep_return=dev(state.ep_return),
            ep_len=dev(state.ep_len),
            eps_count=dev(state.eps_count),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"VectorEnv({type(self.env).__name__}, num_envs={self.num_envs})"
