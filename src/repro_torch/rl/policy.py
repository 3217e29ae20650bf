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

from repro_torch.kernels.ops import fused_ppo_loss

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
    """Discrete actor-critic with selectable loss: 'pg' (A2C/A3C) or 'ppo'."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        loss_kind: str = "pg",
        vf_coef: float = 0.5,
        ent_coef: float = 0.01,
        clip_eps: float = 0.2,
    ):
        if loss_kind not in ("pg", "ppo"):
            raise NotImplementedError(
                f"loss_kind={loss_kind!r}: the port has the 'pg' and 'ppo' losses "
                "(the V-trace loss waits for its kernel)"
            )
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.loss_kind = loss_kind
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.clip_eps = clip_eps

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
        return self._pg_loss(params, batch)

    def _pg_loss(self, params, batch):
        logits, values = self.logits_value(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"].long()[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
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
