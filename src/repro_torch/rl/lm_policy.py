"""LM token policy: a transformer as an RL actor-critic, with KV-cache decode
as the rollout fast path (PyTorch port of ``repro/rl/lm_policy.py``).

``LMTokenPolicy`` acts on ``TokenEnv`` observations (token window + length +
step) with a ``models/transformer.Model`` trunk and an MLP value head:

  * **Learner path**: ``logits_value``/``loss`` run the full no-cache
    ``forward`` (the flash-attention kernels, forward and backward, via
    ``ops.flash_attention``) and read logits and value at each sequence's
    own last position.
  * **Decode path**: the stateful-policy protocol (``init_lane_state`` /
    ``compute_actions_stateful``) carries a per-lane KV cache: prefill once
    when a lane starts an episode, then one ``decode_step`` per action via
    ``ops.decode_attention``.

The two paths are parity-gated (``decode_parity_gap``).  The prefill-or-
decode choice is a Python branch on "any lane fresh" (the reference's
``lax.cond``), which reads one flag from the device per generated token.  A
lane is fresh at episode start or whenever its cache position disagrees
with its observation, so a lost or stale cache is rebuilt by re-prefilling
every lane from its obs window: correctness never depends on the episodes
being synchronized, only the speedup does.

Lane-state layout: every leaf carries the lane axis leading, so the model's
stacked block caches ``[num_blocks, B, ...]`` appear as ``[B, num_blocks,
...]`` at the protocol boundary and are moved back inside.  Each lane samples
its token from its own threefry key (``repro_torch.prng``, ``[B, 2]``), as
the reference's ``vmap(jax.random.categorical)`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.rl.policy import ActorCriticPolicy, mlp_apply, mlp_init
from repro_torch.rl.token_env import split_obs
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["LMTokenPolicy"]


def _lm_cfg(
    vocab_size: int, d_model: int, n_layers: int, num_heads: int, num_kv_heads: int
) -> ModelConfig:
    return ModelConfig(
        name="rl-lm",
        arch_type="dense",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        d_ff=d_model * 4,
        vocab_size=vocab_size,
        head_dim=d_model // num_heads,
        block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
        dtype="float32",
    )


def _sample(logits: torch.Tensor, keys: torch.Tensor):
    """Categorical actions from [B, V] logits, one lane key [B, 2] a row,
    and their log-probs."""
    action = prng.categorical(keys, logits)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp


class LMTokenPolicy:
    """Discrete actor-critic over a causal LM; actions are vocabulary tokens."""

    def __init__(
        self,
        ctx: int,
        vocab_size: int,
        d_model: int = 32,
        n_layers: int = 2,
        num_heads: int = 2,
        num_kv_heads: int = 0,
        loss_kind: str = "ppo",
        vf_coef: float = 0.5,
        ent_coef: float = 0.01,
        clip_eps: float = 0.2,
    ):
        self.ctx = ctx
        self.vocab_size = vocab_size
        self.obs_dim = ctx + 2
        self.num_actions = vocab_size
        self.cfg = _lm_cfg(vocab_size, d_model, n_layers, num_heads, num_kv_heads or num_heads)
        self.model = Model(self.cfg)
        # The PPO/PG losses of the actor-critic policy, read through this
        # policy's logits_value (the reference builds the same proxy).
        self._losses = ActorCriticPolicy(1, vocab_size, loss_kind=loss_kind, vf_coef=vf_coef,
                                         ent_coef=ent_coef, clip_eps=clip_eps)
        self._losses.logits_value = self.logits_value
        self.loss_kind = loss_kind
        self.vf_coef = vf_coef
        self.ent_coef = ent_coef
        self.clip_eps = clip_eps

    def init_params(self, generator: torch.Generator) -> PyTree:
        return {
            "lm": self.model.init_params(generator),
            "vf": mlp_init(generator, (self.cfg.d_model, 64, 1), scale_last=1.0),
        }

    # ------------------------------------------------------------ forward path
    def _heads(self, params: PyTree, h_last: torch.Tensor):
        """(logits [B, V], value [B]) from the last-position hidden [B, d]."""
        logits = self.model._head(params["lm"], h_last)
        value = mlp_apply(params["vf"], h_last)[..., 0]
        return logits, value

    def _last_hidden(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        """No-cache forward over [N, ctx + 2] obs, read at each length - 1."""
        tokens, length, _ = split_obs(obs, self.ctx)
        h, _ = self.model.forward(params["lm"], tokens)
        idx = torch.clamp(length - 1, 0, self.ctx - 1).long()
        return h[torch.arange(h.shape[0], device=h.device), idx]

    def logits_value(self, params: PyTree, obs: torch.Tensor):
        """No-cache forward: full-sequence attention, read at length - 1.

        Accepts any leading batch shape (the GAE bootstrap passes [T, N, D]).
        """
        lead = tuple(obs.shape[:-1])
        logits, value = self._heads(params, self._last_hidden(params, obs.reshape(-1, obs.shape[-1])))
        return logits.reshape(lead + (self.vocab_size,)), value.reshape(lead)

    def value(self, params: PyTree, obs: torch.Tensor) -> torch.Tensor:
        """Critic value only (the GAE bootstrap); skips the vocabulary head."""
        lead = tuple(obs.shape[:-1])
        h_last = self._last_hidden(params, obs.reshape(-1, obs.shape[-1]))
        return mlp_apply(params["vf"], h_last)[..., 0].reshape(lead)

    def compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        """Batched acting with per-lane keys, without a cache (the slow path)."""
        logits, value = self.logits_value(params, obs)
        action, logp = _sample(logits, keys)
        return action, logp, value, logits

    def act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        """The per-env worker's acting: obs ``[..., ctx + 2]`` from one key
        ``[2]``.  The reference runs ``compute_actions`` on ``obs[None]`` and
        ``key[None]`` and takes row 0, which is
        ``jax.random.categorical(key, logits)`` over the obs' logits; so is
        this.  Returns (action, logp, value, logits)."""
        logits, value = self.logits_value(params, obs)
        action = prng.categorical_key(key, logits)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, action[..., None])[..., 0]
        return action, logp, value, logits

    # ------------------------------------------------ stateful-policy protocol
    def init_lane_state(self, n: int, device: Any = "cpu") -> PyTree:
        """Fresh per-lane KV cache (lane axis leading on every leaf)."""
        cache = self.model.init_cache(n, self.ctx, device)
        cache["pos"] = torch.zeros((n,), dtype=torch.int32, device=device)
        return self._to_lane_layout(cache)

    @staticmethod
    def _to_lane_layout(cache: PyTree) -> PyTree:
        out = dict(cache)
        out["blocks"] = tree_map(lambda x: torch.movedim(x, 0, 1), cache["blocks"])
        return out

    @staticmethod
    def _to_model_layout(state: PyTree) -> PyTree:
        out = dict(state)
        out["blocks"] = tree_map(lambda x: torch.movedim(x, 1, 0).contiguous(), state["blocks"])
        return out

    def _hidden_stateful(self, params: PyTree, obs: torch.Tensor, state: PyTree):
        """Last-position hidden [B, d] and the new model-layout cache: prefill
        if any lane is fresh, else one decode step."""
        B = obs.shape[0]
        tokens, length, t = split_obs(obs, self.ctx)
        cache = self._to_model_layout(state)
        idx = torch.clamp(length - 1, 0, self.ctx - 1).long()
        lanes = torch.arange(B, device=obs.device)
        # A lane is fresh at episode start (t == 0) or whenever its cache
        # position disagrees with the sequence (state lost/restored/desynced):
        # either way a full re-prefill from the obs window rebuilds it.
        fresh = (t == 0) | (cache["pos"] != length - 1)
        if bool(fresh.any()):
            _, new_cache, h = self.model.prefill(params["lm"], tokens, window=self.ctx, with_hidden=True)
            new_cache["pos"] = length
            return h[lanes, idx], new_cache
        last_tok = tokens[lanes, idx][:, None]
        _, new_cache, h = self.model.decode_step(params["lm"], cache, last_tok, with_hidden=True)
        return h[:, 0], new_cache

    def compute_actions_stateful(
        self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor, state: PyTree
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, PyTree]:
        """One generation step against the per-lane KV cache, per-lane keys."""
        h_last, new_cache = self._hidden_stateful(params, obs, state)
        logits, value = self._heads(params, h_last)
        action, logp = _sample(logits, keys)
        return action, logp, value, self._to_lane_layout(new_cache)

    # ------------------------------------------------------------ parity gate
    def decode_parity_gap(self, params: PyTree, obs: torch.Tensor, state: PyTree) -> torch.Tensor:
        """Max |decode-path logits - forward-path logits| over a batch: the
        number the cache rollout is gated on."""
        tokens, length, _ = split_obs(obs, self.ctx)
        cache = self._to_model_layout(state)
        idx = torch.clamp(length - 1, 0, self.ctx - 1).long()
        last_tok = tokens[torch.arange(obs.shape[0], device=obs.device), idx][:, None]
        dec_logits, _ = self.model.decode_step(params["lm"], cache, last_tok)
        fwd_logits, _ = self.logits_value(params, obs)
        return torch.max(torch.abs(dec_logits[:, 0] - fwd_logits))

    # ----------------------------------------------------------------- loss
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return self._losses.loss(params, batch)
