"""Model-based RL worker: learned dynamics ensemble + synthetic rollouts
(PyTorch port of ``repro/rl/model_based.py``).

The paper's flexibility argument (§2.2, §6 "an undergraduate implemented
MB-MPO/Dreamer"): model-based training adds a supervised dynamics-model
stream on top of model-free RL, 'breaking the mold' of fixed execution
patterns.  In RLlib Flow it is just one more concurrent sub-flow — see
``repro_torch.flow.plans.build_mbpo``:

    (1) env rollouts  -> replay                      (real experience)
    (2) replay        -> TrainDynamicsModel          (supervised stream)
    (3) synthetic rollouts (policy x learned model) -> TrainOneStep(policy)

This worker extends RolloutWorker with a dynamics ensemble (predicts
delta-obs and reward), each member with its own Adam state, and an eager
synthetic rollout on the worker's device.  The synthetic rollout ends in
``ops.fused_gae`` (the GAE kernel on the card), where the reference calls
its plain scan ``repro.rl.advantages.gae``: the same function, and no plain
version on the card's path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import fused_gae as gae
from repro_torch.optim import adam
from repro_torch.rl.policy import mlp_apply, mlp_init
from repro_torch.rl.rollout_worker import (
    RolloutWorker,
    _device_batch,
    _to_numpy_batch,
    _value_and_grad,
)
from repro_torch.rl.sample_batch import SampleBatch

PyTree = Any

__all__ = ["ModelBasedWorker"]


class ModelBasedWorker(RolloutWorker):
    """RolloutWorker + dynamics ensemble + synthetic rollouts."""

    def __init__(
        self,
        *args: Any,
        ensemble_size: int = 2,
        model_hidden: Tuple[int, ...] = (64, 64),
        model_lr: float = 1e-3,
        synth_rollout_len: int = 8,
        synth_batch: int = 64,
        **kwargs: Any,
    ):
        super().__init__(*args, **kwargs)
        self.ensemble_size = ensemble_size
        self.synth_rollout_len = synth_rollout_len
        self.synth_batch = synth_batch
        obs_dim = self.env.obs_dim
        in_dim = obs_dim + 1  # obs + discrete action index
        out_dim = obs_dim + 1  # delta obs + reward
        gen = torch.Generator(device=self.device)
        gen.manual_seed(271 + self.worker_index)
        self.dyn_params = [
            mlp_init(gen, (in_dim, *model_hidden, out_dim), scale_last=0.1)
            for _ in range(ensemble_size)
        ]
        self.dyn_opt = adam(model_lr)
        self.dyn_opt_states = [self.dyn_opt.init(p) for p in self.dyn_params]
        self.dyn_losses: list = []

    # ------------------------------------------------------------ dynamics
    def _dyn_forward(self, params: PyTree, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act[:, None].to(torch.float32)], dim=-1)
        out = mlp_apply(params, x)
        return out[:, :-1], out[:, -1]  # delta obs, reward

    def _dyn_loss(self, params: PyTree, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        d_obs, rew = self._dyn_forward(params, batch["obs"], batch["actions"])
        target = batch["next_obs"] - batch["obs"]
        return torch.mean(torch.square(d_obs - target)) + torch.mean(
            torch.square(rew - batch["rewards"])
        )

    def _dyn_learn(self, member: int, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One Adam step of ensemble member ``member``; its loss before it."""
        grads, loss, _ = _value_and_grad(
            lambda p: (self._dyn_loss(p, batch), {}), self.dyn_params[member]
        )
        self.dyn_params[member], self.dyn_opt_states[member] = self.dyn_opt.apply(
            self.dyn_params[member], grads, self.dyn_opt_states[member]
        )
        return loss

    def train_dynamics(self, batch: SampleBatch) -> Dict[str, float]:
        dev = _device_batch(batch, self.device)
        losses = torch.stack([self._dyn_learn(i, dev) for i in range(self.ensemble_size)])
        self.dyn_losses = losses.tolist()  # one device-to-host copy
        return {"dyn_loss": float(np.mean(self.dyn_losses))}

    # ---------------------------------------------------- synthetic rollout
    @torch.no_grad()
    def synth_rollout(
        self,
        policy_params: PyTree,
        dyn_params: PyTree,
        start_obs: torch.Tensor,
        pick: Callable[[int, torch.Tensor], torch.Tensor],
    ) -> Dict[str, torch.Tensor]:
        """Roll the CURRENT policy through the LEARNED model (one ensemble
        member per call): the deterministic core.  ``pick(t, logits)`` gives
        step t's actions ``[N]`` from the policy's logits there; the log-prob,
        value, predicted reward and next obs follow from them.  ``dones`` are
        all zero, and GAE bootstraps from the policy's value of the last
        obs."""
        obs, steps = start_obs, []
        for t in range(self.synth_rollout_len):
            logits, value = self.policy.logits_value(policy_params, obs)
            action = pick(t, logits)
            logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
            d_obs, rew = self._dyn_forward(dyn_params, obs, action)
            next_obs = obs + d_obs
            steps.append({
                "obs": obs,
                "actions": action,
                "rewards": rew,
                "dones": torch.zeros_like(rew),
                "logp": logp,
                "values": value,
                "next_obs": next_obs,
            })
            obs = next_obs
        cols = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        last_value = self.policy.value(policy_params, obs)
        adv, ret = gae(
            cols["rewards"], cols["values"], cols["dones"], last_value, self.gamma, self.lam
        )
        cols["advantages"] = adv
        cols["returns"] = ret
        return cols

    def _sample_action(self, t: int, logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def synthesize(self, batch: SampleBatch) -> SampleBatch:
        """Generate a synthetic on-policy batch branching from replayed
        states (MBPO-style)."""
        # The reference seeds the start-row draw with len(self.dyn_losses),
        # which is ensemble_size after every train_dynamics: each call then
        # draws the same rows.  Reproduced exactly: fix it in both packages
        # together.
        idx = np.random.default_rng(len(self.dyn_losses)).integers(
            0, batch.count, min(self.synth_batch, batch.count)
        )
        obs = torch.as_tensor(batch["obs"], device=self.device)
        start = obs.index_select(0, torch.as_tensor(idx, device=self.device))
        # The reference draws the member and the actions from a key it splits
        # off the worker's chain; the port draws them from the generator (a
        # deliberate difference) and advances the chain alike.
        self._next_key()
        member = int(torch.randint(self.ensemble_size, (1,), generator=self._gen,
                                   device=self.device))
        cols = self.synth_rollout(self.params, self.dyn_params[member], start, self._sample_action)
        return _to_numpy_batch(cols)
