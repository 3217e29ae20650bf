"""Batched environments on tensors (PyTorch port of ``repro/rl/env.py``).

The JAX package writes an environment for one instance and ``vmap``s it over
the worker's envs; here every function takes the batch as a leading dim:
state fields are ``[N]`` tensors, ``obs`` is ``[N, obs_dim]``, and every
draw comes from per-lane threefry keys ``[N, 2]`` (``repro_torch.prng``), so
lane i draws what the reference's ``vmap``ped lane i draws, bit for bit:

    reset(keys)                       -> state, obs
    step_raw(state, action, keys)     -> state', obs', reward, terminated, truncated
    step(state, action, keys)         -> state', obs', reward, done   (auto-reset)

``VectorEnv`` wraps an env for the vectorized rollout engine: per-lane key
chains, auto-reset, the true pre-reset successor obs, the
terminated/truncated split, and per-lane episode accounting, with a
checkpointable state.  ``MultiAgentCartPole`` is one env of ``num_agents``
CartPole agents, each mapped to a policy id.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import prng

__all__ = [
    "Env",
    "CartPole",
    "CartPoleState",
    "MultiAgentCartPole",
    "Pendulum",
    "PendulumState",
    "StubEnv",
    "StubEnvState",
    "VectorEnv",
    "VectorEnvState",
    "VectorStep",
]


def _where_done(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where(done, a, b)`` with the ``[N]`` mask reshaped to the
    field's rank, so a field with trailing dims takes whole rows."""
    return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class Env:
    """Protocol: subclasses define obs_dim / num_actions / reset / step_raw.

    Every method takes one threefry key a lane, ``keys [N, 2]`` (int64
    holding uint32 words), on the env's device; the lane count is the keys'.
    ``step_raw`` is the auto-reset-free half of ``step``: it returns the
    *true* successor state/obs plus a terminated/truncated split.  ``step``
    keeps the legacy auto-resetting semantics on top of it: every lane draws
    a fresh ``reset`` from its own step key, as the reference's does, and
    lanes that ended take it.
    """

    obs_dim: int
    num_actions: int  # -1 for continuous
    action_dim: int = 0

    def reset(self, keys: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step_raw(self, state: Any, action: torch.Tensor, keys: torch.Tensor):
        """(state, action, keys) -> (state', obs', reward, terminated, truncated).

        No auto-reset: ``state'``/``obs'`` are the true successors even on
        episode end.  ``terminated`` is environment death (value bootstrap
        must be zero); ``truncated`` is an artificial horizon (bootstrap from
        the successor value is correct)."""
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor, keys: torch.Tensor):
        """Legacy auto-resetting step: (state', obs', reward, done)."""
        new, obs, reward, terminated, truncated = self.step_raw(state, action, keys)
        done = terminated | truncated
        reset_st, reset_obs = self.reset(keys)
        out = type(new)(*(_where_done(done, a, b) for a, b in zip(reset_st, new)))
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

    def reset(self, keys: torch.Tensor) -> Tuple[CartPoleState, torch.Tensor]:
        vals = prng.uniform(keys, (4,), -0.05, 0.05)  # [N, 4]
        t = torch.zeros(vals.shape[:1], dtype=torch.int32, device=vals.device)
        st = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], t)
        return st, self._obs(st)

    @staticmethod
    def _obs(st: CartPoleState) -> torch.Tensor:
        return torch.stack([st.x, st.x_dot, st.theta, st.theta_dot], dim=-1)

    def step_raw(self, st: CartPoleState, action: torch.Tensor, keys: torch.Tensor):
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


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32 step count


class Pendulum(Env):
    """Pendulum-v1 (continuous torque) for SAC-style continuous control;
    actions are ``[N, action_dim]`` floats in [-1, 1], scaled to the torque."""

    obs_dim = 3
    num_actions = -1
    action_dim = 1
    max_steps = 200
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def reset(self, keys: torch.Tensor) -> Tuple[PendulumState, torch.Tensor]:
        sub = prng.split(keys, 2)  # [N, 2, 2]
        theta = prng.uniform(sub[:, 0], (), -math.pi, math.pi)
        theta_dot = prng.uniform(sub[:, 1], (), -1.0, 1.0)
        t = torch.zeros(theta.shape, dtype=torch.int32, device=theta.device)
        st = PendulumState(theta, theta_dot, t)
        return st, self._obs(st)

    @staticmethod
    def _obs(st: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(st.theta), torch.sin(st.theta), st.theta_dot], dim=-1)

    def step_raw(self, st: PendulumState, action: torch.Tensor, keys: torch.Tensor):
        u = torch.clamp(
            action.reshape(st.theta.shape).to(st.theta.dtype) * self.max_torque,
            -self.max_torque,
            self.max_torque,
        )
        # A floor modulo, as jnp's %: torch.fmod would keep the dividend's sign.
        th = torch.remainder(st.theta + math.pi, 2 * math.pi) - math.pi
        cost = th**2 + 0.1 * st.theta_dot**2 + 0.001 * u**2
        new_dot = st.theta_dot + (
            3 * self.g / (2 * self.length) * torch.sin(st.theta)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        new_dot = torch.clamp(new_dot, -self.max_speed, self.max_speed)
        new = PendulumState(st.theta + new_dot * self.dt, new_dot, st.t + 1)
        truncated = new.t >= self.max_steps  # the pendulum never terminates
        return new, self._obs(new), -cost, torch.zeros_like(truncated), truncated


class StubEnvState(NamedTuple):
    x: torch.Tensor  # [N, obs_dim]
    t: torch.Tensor  # [N] int32 step count


class StubEnv(Env):
    """Deterministic stub environment for tests and rollout benchmarks.

    All dynamics are elementwise (no reductions, no matmuls), so a lane is
    bit-identical to the same lane stepped alone.  Episodes terminate when
    ``x[0]`` drifts out of bounds and truncate at ``max_steps``; the
    terminated/truncated split makes it the reference env for bootstrap
    handling.
    """

    obs_dim = 4
    num_actions = 2

    def __init__(self, max_steps: int = 16, drift: float = 0.3, threshold: float = 4.0):
        self.max_steps = max_steps
        self.drift = drift
        self.threshold = threshold

    def reset(self, keys: torch.Tensor) -> Tuple[StubEnvState, torch.Tensor]:
        x = prng.uniform(keys, (self.obs_dim,), -0.5, 0.5)  # [N, obs_dim]
        st = StubEnvState(x, torch.zeros(x.shape[:1], dtype=torch.int32, device=x.device))
        return st, st.x

    def step_raw(self, st: StubEnvState, action: torch.Tensor, keys: torch.Tensor):
        direction = torch.where(action == 1, 1.0, -1.0).to(torch.float64)
        # XLA contracts this multiply-add into one fused multiply-add (a
        # single rounding); in float64 the product is exact, so rounding
        # the sum to float32 gives the reference's bits.
        x = st.x.double() * float(np.float32(0.95))
        x = (x + direction[:, None] * float(np.float32(self.drift))).to(st.x.dtype)
        new = StubEnvState(x, st.t + 1)
        terminated = torch.abs(x[:, 0]) > self.threshold
        truncated = (new.t >= self.max_steps) & ~terminated
        reward = 1.0 + 0.1 * torch.tanh(x[:, 0])
        return new, new.x, reward, terminated, truncated


# --------------------------------------------------------------- VectorEnv
class VectorEnvState(NamedTuple):
    """Everything the vectorized rollout engine carries between steps.

    ``rng`` holds one threefry key a lane (the per-lane split the
    determinism suite pins down); ``eps_count`` counts completed episodes
    per lane so fragment assembly can stamp globally unique episode ids.
    ``VectorEnv.state_to_numpy`` makes the whole state a picklable
    checkpoint payload.
    """

    env_state: Any           # batched env state, leading dim N
    obs: torch.Tensor        # [N, obs_dim] current (post-reset) observations
    rng: torch.Tensor        # [N, 2] per-lane keys (int64 holding uint32 words)
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

    Per-lane keys: ``reset(key)`` folds the lane index into the key, and
    every step splits each lane's key chain independently (one split for
    the step's key, one for the reset's), so lane ``i`` consumes exactly the
    key stream a standalone env seeded with ``fold_in(key, i)`` would: a
    vectorized rollout equals per-env rollouts, and equals the reference's,
    whose ``VectorEnv`` does the same under ``vmap``.

    Auto-reset is owned here (via ``env.step_raw``), so both the true
    successor obs (for bootstrap) and the post-reset obs (for the next
    action) are exposed.  Envs lacking ``step_raw`` fall back to the legacy
    auto-resetting ``step`` with ``truncated == False`` and ``next_obs``
    equal to the post-reset obs.
    """

    def __init__(self, env: Env, num_envs: int):
        if num_envs < 1:
            raise ValueError(f"VectorEnv needs num_envs >= 1 (got {num_envs})")
        self.env = env
        self.num_envs = num_envs
        self.obs_dim = env.obs_dim
        self.num_actions = env.num_actions
        self.action_dim = getattr(env, "action_dim", 0)
        self._has_raw = hasattr(type(env), "step_raw") and (
            type(env).step_raw is not Env.step_raw
        )

    # ---------------------------------------------------------------- reset
    def reset(self, key: torch.Tensor) -> VectorEnvState:
        """Fresh lanes on the key's device from one key ``[2]``: lane i's
        chain starts at ``fold_in(key, i)``."""
        device = key.device
        n = self.num_envs
        lane_keys = prng.fold_in(key, torch.arange(n, device=device))
        next_rng, reset_keys = self._split_lanes(lane_keys)
        env_state, obs = self.env.reset(reset_keys)
        return VectorEnvState(
            env_state=env_state,
            obs=obs,
            rng=next_rng,
            ep_return=torch.zeros((n,), dtype=torch.float32, device=device),
            ep_len=torch.zeros((n,), dtype=torch.int32, device=device),
            eps_count=torch.zeros((n,), dtype=torch.int32, device=device),
        )

    @staticmethod
    def _split_lanes(rng: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, 2] lane keys -> (next chain keys, per-lane subkeys): each
        lane's ``jax.random.split(k, 2)``, one hash for all lanes."""
        both = prng.split(rng, 2)
        return both[:, 0], both[:, 1]

    # ----------------------------------------------------------------- step
    def step(self, state: VectorEnvState, actions: torch.Tensor) -> Tuple[VectorEnvState, VectorStep]:
        rng, k_step = self._split_lanes(state.rng)
        rng, k_reset = self._split_lanes(rng)
        if self._has_raw:
            new_env, next_obs, reward, terminated, truncated = self.env.step_raw(
                state.env_state, actions, k_step
            )
            done = terminated | truncated
            reset_env, reset_obs = self.env.reset(k_reset)
            fields = zip(reset_env, new_env)
            env_state = type(new_env)(*(_where_done(done, a, b) for a, b in fields))
            obs = torch.where(done[:, None], reset_obs, next_obs)
        else:
            env_state, obs, reward, done = self.env.step(state.env_state, actions, k_step)
            next_obs = obs  # legacy envs reset internally; the successor is lost
            terminated = done
            truncated = torch.zeros_like(done)
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
            rng=rng,
            ep_return=torch.where(done, 0.0, new_ret),
            ep_len=torch.where(done, 0, state.ep_len + 1),
            eps_count=state.eps_count + done.to(torch.int32),
        )
        return new_state, out

    # ----------------------------------------------------------- durability
    @staticmethod
    def state_to_numpy(state: VectorEnvState) -> VectorEnvState:
        """Device state -> picklable numpy state (checkpoint payload); the
        lane keys as uint32, as the reference's."""
        host = lambda x: x.detach().cpu().numpy()  # noqa: E731
        es = state.env_state
        return VectorEnvState(
            env_state=type(es)(*(host(x) for x in es)),
            obs=host(state.obs),
            rng=host(state.rng).astype(np.uint32),
            ep_return=host(state.ep_return),
            ep_len=host(state.ep_len),
            eps_count=host(state.eps_count),
        )

    @staticmethod
    def state_from_numpy(state: VectorEnvState, device: Any) -> VectorEnvState:
        device = torch.device(device)
        dev = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
        es = state.env_state
        return VectorEnvState(
            env_state=type(es)(*(dev(x) for x in es)),
            obs=dev(state.obs),
            rng=dev(np.asarray(state.rng).astype(np.int64)),
            ep_return=dev(state.ep_return),
            ep_len=dev(state.ep_len),
            eps_count=dev(state.eps_count),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"VectorEnv({type(self.env).__name__}, num_envs={self.num_envs})"


class MultiAgentCartPole:
    """N independent CartPole agents in one logical env (paper Fig 11/14:
    'multi-agent Atari with four agents per policy' analogue): the batched
    CartPole with one lane per agent, each agent's key split from the env's
    one key as the reference's ``split(key, num_agents)``.

    ``policy_mapping`` assigns each agent index to a policy id; rollout
    workers return a MultiAgentBatch keyed by policy id.
    """

    def __init__(self, num_agents: int, policy_mapping: Dict[int, str]):
        self.base = CartPole()
        self.num_agents = num_agents
        self.policy_mapping = dict(policy_mapping)
        self.obs_dim = self.base.obs_dim
        self.num_actions = self.base.num_actions

    def reset(self, key: torch.Tensor) -> Tuple[CartPoleState, torch.Tensor]:
        return self.base.reset(prng.split(key, self.num_agents))  # obs: [A, obs_dim]

    def step_raw(self, st: CartPoleState, actions: torch.Tensor, key: torch.Tensor):
        return self.base.step_raw(st, actions, prng.split(key, self.num_agents))

    def step(self, st: CartPoleState, actions: torch.Tensor, key: torch.Tensor):
        return self.base.step(st, actions, prng.split(key, self.num_agents))
