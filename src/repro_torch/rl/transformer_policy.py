"""Transformer actor-critic policy: the model zoo's attention stack as an RL
trunk (PyTorch port of ``repro/rl/transformer_policy.py``).

The observation is projected into a short learned token sequence, run
through reduced-config transformer blocks (``models/layers.py``: causal
attention through ``ops.flash_attention``, so the flash kernels forward and
backward on the card), mean-pooled, and decoded by policy/value heads.
Drop-in replacement for ``ActorCriticPolicy`` in any plan.

One difference from the reference: the trunk takes any leading batch shape
(it flattens all but the last axis), so the vectorized engine's GAE
bootstrap can pass its ``[T, N, obs_dim]`` successor observations; the
reference's trunk reads ``obs.shape[0]`` as the batch and takes ``[N,
obs_dim]`` only.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.layers import attention_apply, attention_init, mlp_apply, mlp_init, rms_norm
from repro_torch.rl.policy import ActorCriticPolicy
from repro_torch.rl.policy import mlp_apply as head_apply
from repro_torch.rl.policy import mlp_init as head_init

PyTree = Any

__all__ = ["TransformerPolicy"]


def _trunk_cfg(d_model: int, n_layers: int) -> ModelConfig:
    return ModelConfig(
        name="rl-trunk",
        arch_type="dense",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=max(d_model // 32, 1),
        num_kv_heads=max(d_model // 32, 1),
        d_ff=d_model * 4,
        vocab_size=2,  # unused (no embedding table; obs are projected)
        block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
        dtype="float32",
    )


class TransformerPolicy:
    """Discrete actor-critic with a transformer trunk over obs tokens."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        d_model: int = 64,
        n_layers: int = 2,
        n_tokens: int = 4,
        loss_kind: str = "ppo",
        vf_coef: float = 0.5,
        ent_coef: float = 0.01,
        clip_eps: float = 0.2,
    ):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.cfg = _trunk_cfg(d_model, n_layers)
        self.n_tokens = n_tokens
        self.loss_kind = loss_kind
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.clip_eps = clip_eps

    def init_params(self, generator: torch.Generator) -> PyTree:
        cfg, device = self.cfg, generator.device
        d = cfg.d_model
        obs_proj = torch.randn((self.obs_dim, self.n_tokens * d), generator=generator, device=device)
        pos = torch.randn((self.n_tokens, d), generator=generator, device=device)
        params: Dict[str, Any] = {
            "obs_proj": obs_proj * 0.2,
            "pos": pos * 0.02,
            "pi_head": head_init(generator, (d, 64, self.num_actions)),
            "vf_head": head_init(generator, (d, 64, 1), scale_last=1.0),
        }
        for i in range(cfg.num_layers):
            params[f"layer_{i}"] = {
                "norm1": torch.ones((d,), device=device),
                "attn": attention_init(generator, cfg),
                "norm2": torch.ones((d,), device=device),
                "mlp": mlp_init(generator, cfg, cfg.d_ff),
            }
        return params

    def _trunk(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = obs.shape[0]
        x = (obs @ params["obs_proj"]).reshape(B, self.n_tokens, cfg.d_model)
        x = x + params["pos"][None]
        for i in range(cfg.num_layers):
            lp = params[f"layer_{i}"]
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            x = x + attention_apply(lp["attn"], h, cfg)
            h = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg)
        return torch.mean(x, dim=1)  # [B, d]

    def logits_value(self, params: PyTree, obs: torch.Tensor):
        lead = tuple(obs.shape[:-1])
        z = self._trunk(params, obs.reshape(-1, obs.shape[-1]))
        logits = head_apply(params["pi_head"], z)
        value = head_apply(params["vf_head"], z)[..., 0]
        return logits.reshape(lead + (self.num_actions,)), value.reshape(lead)

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        """Sample actions for ``obs [N, obs_dim]`` from one key ``[2]`` (the
        non-vectorized ``RolloutWorker``; ``jax.random.categorical(key,
        logits)``)."""
        logits, value = self.logits_value(params, obs)
        action = prng.categorical_key(key, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[..., None])[..., 0]
        return action, logp, value, logits

    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        """Critic value only (GAE bootstrap at truncation boundaries)."""
        return self.logits_value(params, obs)[1]

    def compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        """Batched acting with per-lane keys: obs [N, D], keys [N, 2].  One
        trunk dispatch for all lanes; each lane samples from its own key."""
        logits, value = self.logits_value(params, obs)
        action = prng.categorical(keys, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
        return action, logp, value, logits

    # ------------------------------------------------ stateful-policy protocol
    # The trunk is memoryless, so the lane state is degenerate: a per-lane
    # step counter.  It lets this policy ride the sticky serving tier through
    # the same protocol a KV-cache or SSM policy uses.
    def init_lane_state(self, n: int, device: Any = "cpu") -> PyTree:
        return {"steps": torch.zeros((n,), dtype=torch.int32, device=device)}

    def compute_actions_stateful(
        self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor, state: PyTree
    ):
        action, logp, value, _ = self.compute_actions(params, obs, keys)
        return action, logp, value, {"steps": state["steps"] + 1}

    # Reuse ActorCriticPolicy's loss math via composition.
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        proxy = ActorCriticPolicy.__new__(ActorCriticPolicy)
        proxy.loss_kind = self.loss_kind
        proxy.vf_coef = self.vf_coef
        proxy.ent_coef = self.ent_coef
        proxy.clip_eps = self.clip_eps
        proxy.gamma = 0.99
        proxy.rollout_len = 0
        proxy.logits_value = self.logits_value
        if self.loss_kind == "ppo":
            return proxy._ppo_loss(params, batch)
        return proxy._pg_loss(params, batch)
