"""Stateful (recurrent) serving policies: per-lane state lives server-side
(PyTorch port of ``repro/rl/stateful_policy.py``).

The serving tier's *stateful-policy protocol* is two methods on top of the
usual ``init_params``:

  * ``init_lane_state(n, device) -> tree`` — fresh recurrent state for ``n``
    lanes (leading axis ``n`` on every leaf, so the server gathers and
    scatters per-lane rows with ``repro_torch.tree.tree_map``);
  * ``compute_actions_stateful(params, obs [B, D], keys [B, 2], state) ->
    (actions, logp, values, new_state)`` — one decode step over a batch of
    lanes, each sampling from its own threefry key.

``InferenceActor`` detects the protocol (``hasattr(policy,
"init_lane_state")``), keys the state by the caller's global lane id, and
``InferenceRouter`` then routes those lanes *sticky*.

``SSMStatePolicy`` is the exemplar: a Mamba block (``models/ssm.py``) as the
actor-critic trunk, whose selective-scan state ``{"h": [B, d_in, d_state],
"conv": [B, d_conv - 1, d_in]}`` is the per-lane server-side state.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
from repro_torch.models.ssm import init_mamba_state, mamba_decode, mamba_init
from repro_torch.rl.policy import mlp_apply, mlp_init

PyTree = Any

__all__ = ["SSMStatePolicy"]


def _serve_ssm_config(d_model: int, d_state: int) -> ModelConfig:
    return ModelConfig(
        name="serve-ssm",
        arch_type="ssm",
        num_layers=1,
        d_model=d_model,
        num_heads=1,
        num_kv_heads=1,
        d_ff=d_model,
        vocab_size=1,
        block_pattern=(LayerSpec(kind="mamba", mlp="none"),),
        ssm=SSMConfig(kind="mamba", d_state=d_state, d_conv=2, expand=1),
        dtype="float32",
    )


class SSMStatePolicy:
    """Discrete actor-critic over a single Mamba block, decoded one env step
    at a time with O(1) per-lane state.

    Each ``compute_actions_stateful`` call is one token of an unbounded
    decode: the observation embeds to a d_model token, the Mamba block
    advances ``(h, conv)`` for every lane in the batch, and policy/value
    heads read the block output.  The state is returned to the caller (the
    serving actor), never kept here.
    """

    def __init__(self, obs_dim: int, num_actions: int, d_model: int = 32, d_state: int = 4):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.cfg = _serve_ssm_config(d_model, d_state)

    def init_params(self, generator: torch.Generator) -> PyTree:
        d = self.cfg.d_model
        embed = torch.randn((self.obs_dim, d), generator=generator, device=generator.device)
        return {
            "embed": embed * (1.0 / math.sqrt(self.obs_dim)),
            "trunk": mamba_init(generator, self.cfg),
            "pi": mlp_init(generator, (d, self.num_actions)),
            "vf": mlp_init(generator, (d, 1), scale_last=1.0),
        }

    # ------------------------------------------------ stateful-policy protocol
    def init_lane_state(self, n: int, device: Any = "cpu") -> PyTree:
        """Fresh decode state for ``n`` lanes (leading axis n on each leaf)."""
        return init_mamba_state(self.cfg, n, device)

    def _decode(self, params: PyTree, obs: torch.Tensor, state: PyTree):
        x = (obs @ params["embed"])[:, None, :]  # [B, 1, d_model]
        out, new_state = mamba_decode(params["trunk"], x, state, self.cfg)
        return torch.tanh(out[:, 0]), new_state

    def compute_actions_stateful(
        self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor, state: PyTree
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, PyTree]:
        """One decode step for a batch of lanes with per-lane keys."""
        h, new_state = self._decode(params, obs, state)
        logits = mlp_apply(params["pi"], h)
        action = prng.categorical(keys, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
        value = mlp_apply(params["vf"], h)[:, 0]
        return action, logp, value, new_state

    # ------------------------------------------------------- value queries
    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        """State-free value estimate (bootstrap queries): decode one step
        from a fresh state without advancing anything."""
        h, _ = self._decode(params, obs, self.init_lane_state(obs.shape[0], obs.device))
        return mlp_apply(params["vf"], h)[:, 0]
