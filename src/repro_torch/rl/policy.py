"""Actor-critic policy on tensors (PyTorch port of ``repro/rl/policy.py``).

Parameters are the reference's plain dict tree, ``{"pi": [{"w": [din, dout],
"b": [dout]}, ...], "vf": [...]}``, held as tensors on the policy's device:
the ``w`` layout is the reference's ``[din, dout]``, not ``nn.Linear``'s
``[out, in]``, so ``repro_torch.interop`` carries weights across in one
numpy round trip.  Acting draws from threefry keys (``repro_torch.prng``)
bit for bit as the reference's does: ``act`` takes one key ``[2]`` for the
whole batch (the non-vectorized ``RolloutWorker``), ``compute_actions``
one key a row, ``[N, 2]`` (the reference's ``vmap``ped ``act``).
Parameter initialisation draws from a ``torch.Generator``: weights cross
between the packages through ``repro_torch.interop``, never by seed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.kernels.ops import fused_ppo_loss, fused_vtrace

PyTree = Any

__all__ = ["mlp_init", "mlp_apply", "ActorCriticPolicy", "DQNPolicy", "SACPolicy", "DummyPolicy"]


# ------------------------------------------------------------------ MLP base
def mlp_init(
    generator: torch.Generator, sizes: Sequence[int], scale_last: float = 0.01
) -> PyTree:
    """He-scaled normal weights (``scale_last`` on the output layer), zero
    biases, on the generator's device."""
    device = generator.device
    params = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        w_scale = scale_last if i == len(sizes) - 2 else math.sqrt(2.0 / din)
        w = torch.randn((din, dout), generator=generator, device=device) * w_scale
        params.append({"w": w, "b": torch.zeros((dout,), device=device)})
    return params


def mlp_apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


# ------------------------------------------------------------ Actor-critic
class ActorCriticPolicy:
    """Discrete actor-critic with selectable loss: 'pg' (A2C/A3C), 'ppo',
    'vtrace' (IMPALA).  DQN and SAC have policies of their own."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        loss_kind: str = "pg",
        vf_coef: float = 0.5,
        ent_coef: float = 0.01,
        clip_eps: float = 0.2,
        gamma: float = 0.99,
        rollout_len: int = 0,  # needed for vtrace reshaping
    ):
        if loss_kind not in ("pg", "ppo", "vtrace"):
            raise NotImplementedError(
                f"loss_kind={loss_kind!r}: the policy has the 'pg', 'ppo' and 'vtrace' losses "
                "(DQN and SAC have DQNPolicy and SACPolicy)"
            )
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.loss_kind = loss_kind
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.clip_eps = clip_eps
        self.gamma = gamma
        self.rollout_len = rollout_len

    def init_params(self, generator: torch.Generator) -> PyTree:
        return {
            "pi": mlp_init(generator, (self.obs_dim, *self.hidden, self.num_actions)),
            "vf": mlp_init(generator, (self.obs_dim, *self.hidden, 1), scale_last=1.0),
        }

    def logits_value(self, params: PyTree, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mlp_apply(params["pi"], obs), mlp_apply(params["vf"], obs)[..., 0]

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        """Sample actions for observations ``[..., obs_dim]`` from one key
        ``[2]`` (``jax.random.categorical(key, logits)``); returns (action,
        logp, value, logits)."""
        logits, value = self.logits_value(params, obs)
        action = prng.categorical_key(key, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[..., None])[..., 0]
        return action, logp, value, logits

    def compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        """Batched acting with *per-lane* keys: ``obs [N, obs_dim]``, ``keys
        [N, 2]``.  Row i samples from ``keys[i]`` alone, so its action does
        not depend on the batch it is dispatched in (the serving tier's bit
        parity rests on it)."""
        logits, value = self.logits_value(params, obs)
        action = prng.categorical(keys, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
        return action, logp, value, logits

    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        """Critic value only (the GAE bootstrap)."""
        return mlp_apply(params["vf"], obs)[..., 0]

    # ------------------------------------------------------------- losses
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        if self.loss_kind == "ppo":
            return self._ppo_loss(params, batch)
        if self.loss_kind == "vtrace":
            return self._vtrace_loss(params, batch)
        return self._pg_loss(params, batch)

    def _dist_terms(self, params, batch):
        logits, values = self.logits_value(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"].long()[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        return logp, entropy, values

    def _pg_loss(self, params, batch):
        logp, entropy, values = self._dist_terms(params, batch)
        pg = -torch.mean(logp * batch["advantages"])
        vf = torch.mean(torch.square(values - batch["returns"]))
        ent = torch.mean(entropy)
        loss = pg + self.vf_coef * vf - self.ent_coef * ent
        return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    def _ppo_loss(self, params, batch):
        """Clipped-surrogate PPO loss via ``ops.fused_ppo_loss``: the CUDA
        surrogate kernels (forward and backward) for CUDA tensors, their
        plain version for CPU tensors."""
        logits, values = self.logits_value(params, batch["obs"])
        return fused_ppo_loss(
            logits,
            values,
            batch["actions"].long(),
            batch["logp"],
            batch["advantages"],
            batch["returns"],
            clip_eps=self.clip_eps,
            vf_coef=self.vf_coef,
            ent_coef=self.ent_coef,
        )

    def _vtrace_loss(self, params, batch):
        """IMPALA: importance-corrected off-policy actor-critic.

        Batch rows are [N*T] with contiguous length-T traces (batch-major);
        they are reshaped to [T, N] time-major for ``ops.fused_vtrace``: the
        CUDA V-trace kernel for CUDA tensors, the reverse-time loop for CPU
        tensors.  The targets are stop-gradient, as in the reference, so
        the target log-probs and values enter detached.  The bootstrap is
        the value at each trace's own last step, as in the reference.
        """
        T = self.rollout_len
        if T <= 0:
            raise ValueError("the vtrace loss needs rollout_len > 0")
        logp, entropy, values = self._dist_terms(params, batch)

        def tm(x):  # [N*T, ...] -> [T, N, ...]
            return x.reshape((-1, T) + tuple(x.shape[1:])).transpose(0, 1)

        def stopped(x):
            return x.detach().contiguous()

        vs, pg_adv = fused_vtrace(
            behaviour_logp=stopped(tm(batch["logp"])),
            target_logp=stopped(tm(logp)),
            rewards=stopped(tm(batch["rewards"])),
            values=stopped(tm(values)),
            dones=stopped(tm(batch["dones"])),
            last_value=stopped(tm(values)[-1]),
            gamma=self.gamma,
        )
        pg = -torch.mean(tm(logp) * pg_adv)
        vf = torch.mean(torch.square(tm(values) - vs))
        ent = torch.mean(entropy)
        loss = pg + self.vf_coef * vf - self.ent_coef * ent
        return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


# ----------------------------------------------------------------- DQN
class DQNPolicy:
    """Double DQN with target network and Huber TD loss."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        gamma: float = 0.99,
    ):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.gamma = gamma

    def init_params(self, generator: torch.Generator) -> PyTree:
        q = mlp_init(generator, (self.obs_dim, *self.hidden, self.num_actions), scale_last=1.0)
        return {"q": q}

    def q_values(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        return mlp_apply(params["q"], obs)

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor, epsilon: float):
        """Epsilon-greedy over observations ``[..., obs_dim]`` from one key
        ``[2]``, split into the random actions' and the coins'; returns
        (action, zeros, max Q, Q)."""
        q = self.q_values(params, obs)
        greedy = torch.argmax(q, dim=-1)
        k1, k2 = prng.split(key, 2)
        random_a = prng.randint(k1, tuple(greedy.shape), 0, self.num_actions)
        explore = prng.uniform(k2, tuple(greedy.shape)) < epsilon
        action = torch.where(explore, random_a, greedy)
        value = torch.max(q, dim=-1).values
        return action, torch.zeros_like(value), value, q

    def compute_actions(
        self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor, epsilon: float
    ):
        """Per-lane-keyed batched epsilon-greedy (see ActorCriticPolicy):
        each lane's key splits into the random action's and the coin's."""
        q = self.q_values(params, obs)
        greedy = torch.argmax(q, dim=-1)
        sub = prng.split(keys, 2)
        random_a = prng.randint(sub[:, 0], (), 0, self.num_actions)
        explore = prng.uniform(sub[:, 1], ()) < epsilon
        action = torch.where(explore, random_a, greedy)
        value = torch.max(q, dim=-1).values
        return action, torch.zeros_like(value), value, q

    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        return torch.max(self.q_values(params, obs), dim=-1).values

    def loss(
        self, params: PyTree, target_params: PyTree, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict]:
        q = self.q_values(params, batch["obs"])
        q_sa = q.gather(-1, batch["actions"].long()[:, None])[:, 0]
        # Double-DQN target: online argmax, target evaluation; stop-gradient.
        with torch.no_grad():
            next_a = torch.argmax(self.q_values(params, batch["next_obs"]), dim=-1)
            next_q_target = self.q_values(target_params, batch["next_obs"])
            next_q = next_q_target.gather(-1, next_a[:, None])[:, 0]
            target = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * next_q
        td = q_sa - target
        weights = batch["weights"] if "weights" in batch else torch.ones_like(td)
        huber = torch.where(torch.abs(td) < 1.0, 0.5 * td**2, torch.abs(td) - 0.5)
        loss = torch.mean(weights * huber)
        return loss, {"td_error": td, "mean_q": torch.mean(q_sa)}


# ----------------------------------------------------------------- SAC
class SACPolicy:
    """Continuous SAC: squashed Gaussian actor + twin Q critics.

    Acting draws its noise from threefry keys, as the reference's.  ``loss``
    draws the two standard-normal noises (the critic's on ``next_obs``, the
    actor's on ``obs``) from the learner's generator (the reference splits
    them from its learner key: a deliberate difference, the learner's noise
    is not a rollout draw) and hands them to ``loss_with_noise``, the
    deterministic core.  As in the reference, the
    critic target (``next_logp`` from the online actor included) is
    stop-gradient, while the actor loss does send gradient into ``q1``/``q2``.
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (64, 64),
        gamma: float = 0.99,
        alpha: float = 0.2,
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        self.gamma = gamma
        self.alpha = alpha

    def init_params(self, generator: torch.Generator) -> PyTree:
        q_sizes = (self.obs_dim + self.action_dim, *self.hidden, 1)
        return {
            "pi": mlp_init(generator, (self.obs_dim, *self.hidden, 2 * self.action_dim)),
            "q1": mlp_init(generator, q_sizes, scale_last=1.0),
            "q2": mlp_init(generator, q_sizes, scale_last=1.0),
        }

    def _pi(self, params: PyTree, obs: torch.Tensor, eps: torch.Tensor):
        out = mlp_apply(params["pi"], obs)
        mu, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, -20, 2)
        std = torch.exp(log_std)
        action = torch.tanh(mu + std * eps)
        logp = torch.sum(
            -0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))
            - torch.log(1 - action**2 + 1e-6),
            dim=-1,
        )
        return action, logp

    def noise(self, obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Standard-normal noise of the actor's output shape for ``obs``."""
        shape = tuple(obs.shape[:-1]) + (self.action_dim,)
        return torch.randn(shape, generator=generator, device=obs.device)

    def _q(self, q_params: PyTree, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return mlp_apply(q_params, torch.cat([obs, act], dim=-1))[..., 0]

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        """Squashed-Gaussian actions for ``[..., obs_dim]`` from one key
        ``[2]``: one normal draw of the actor's output shape."""
        eps = prng.normal(key, tuple(obs.shape[:-1]) + (self.action_dim,))
        action, logp = self._pi(params, obs, eps)
        value = self._q(params["q1"], obs, action)
        return action, logp, value, action

    def compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        """Per-lane-keyed batched squashed-Gaussian acting."""
        action, logp = self._pi(params, obs, prng.normal(keys, (self.action_dim,)))
        value = self._q(params["q1"], obs, action)
        return action, logp, value, action

    def critic_loss(self, params, target_params, batch, eps):
        with torch.no_grad():
            next_a, next_logp = self._pi(params, batch["next_obs"], eps)
            tq1 = self._q(target_params["q1"], batch["next_obs"], next_a)
            tq2 = self._q(target_params["q2"], batch["next_obs"], next_a)
            target_v = torch.minimum(tq1, tq2) - self.alpha * next_logp
            target = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * target_v
        actions = batch["actions"]
        if actions.dim() == 1:
            actions = actions[:, None]
        q1 = self._q(params["q1"], batch["obs"], actions)
        q2 = self._q(params["q2"], batch["obs"], actions)
        td = q1 - target
        return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2), td

    def actor_loss(self, params, batch, eps):
        a, logp = self._pi(params, batch["obs"], eps)
        q = torch.minimum(
            self._q(params["q1"], batch["obs"], a), self._q(params["q2"], batch["obs"], a)
        )
        return torch.mean(self.alpha * logp - q)

    def loss_with_noise(self, params, target_params, batch, eps_critic, eps_actor):
        closs, td = self.critic_loss(params, target_params, batch, eps_critic)
        aloss = self.actor_loss(params, batch, eps_actor)
        return closs + aloss, {"td_error": td, "critic_loss": closs, "actor_loss": aloss}

    def loss(self, params, target_params, batch, generator: torch.Generator):
        eps_critic = self.noise(batch["next_obs"], generator)
        eps_actor = self.noise(batch["obs"], generator)
        return self.loss_with_noise(params, target_params, batch, eps_critic, eps_actor)


# --------------------------------------------------------------- Dummy
class DummyPolicy:
    """One trainable scalar: the paper's sampling-microbenchmark policy."""

    def __init__(self, obs_dim: int = 4, num_actions: int = 2):
        self.obs_dim = obs_dim
        self.num_actions = num_actions

    def init_params(self, generator: torch.Generator) -> PyTree:
        return {"theta": torch.zeros((1,), device=generator.device)}

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        shape = tuple(obs.shape[:-1])
        action = prng.randint(key, shape, 0, self.num_actions)
        zeros = torch.zeros(shape, device=obs.device)
        return action, zeros, zeros, zeros

    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        return torch.zeros(tuple(obs.shape[:-1]), device=obs.device)

    def compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        """Per-lane-keyed batched random acting (pure RNG: bit-identical to
        the reference's, which anchors the serving tier's parity tests)."""
        action = prng.randint(keys, (), 0, self.num_actions)
        zeros = torch.zeros(tuple(obs.shape[:-1]), device=obs.device)
        return action, zeros, zeros, zeros

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return torch.sum(params["theta"] ** 2), {}
