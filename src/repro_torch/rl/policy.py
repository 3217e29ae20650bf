"""Actor-critic policy on tensors (PyTorch port of ``repro/rl/policy.py``).

Parameters are the reference's plain dict tree, ``{"pi": [{"w": [din, dout],
"b": [dout]}, ...], "vf": [...]}``, held as tensors on the policy's device:
the ``w`` layout is the reference's ``[din, dout]``, not ``nn.Linear``'s
``[out, in]``, so ``repro_torch.interop`` carries weights across in one
numpy round trip.  Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.kernels.ops import fused_ppo_loss, fused_vtrace

PyTree = Any

__all__ = ["mlp_init", "mlp_apply", "ActorCriticPolicy"]


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
    'vtrace' (IMPALA)."""

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
                f"loss_kind={loss_kind!r}: the policy has the 'pg', 'ppo' and 'vtrace' losses"
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

    def act(self, params: PyTree, obs: torch.Tensor, generator: torch.Generator):
        """Sample actions for a batch of observations ``[N, obs_dim]``;
        returns (action, logp, value, logits)."""
        logits, value = self.logits_value(params, obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(torch.exp(logp_all), 1, generator=generator)
        logp = logp_all.gather(-1, action)[..., 0]
        return action[..., 0], logp, value, logits

    def compute_actions(self, params: PyTree, obs: torch.Tensor, generator: torch.Generator):
        """Batched acting for the vectorized rollout engine (``act`` is
        already batched)."""
        return self.act(params, obs, generator)

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
