"""TokenEnv: autoregressive generation as an RL environment (PyTorch port of
``repro/rl/token_env.py``), on the port's batched ``Env`` API: state fields
are ``[N]`` (tokens ``[N, ctx]``) tensors and randomness comes from an
explicit ``torch.Generator``.

  * **reset** samples prompts: ``prompt_len`` tokens drawn from the vocab
    (ragged per lane within ``[min_prompt, max_prompt]``), avoiding PAD/EOS.
  * **one action = one token.**  The action appends to the sequence; the
    episode is the generation.
  * **termination** — EOS or the decode horizon.  ``sync=True`` (default):
    EOS is absorbing (the lane appends PAD) and every lane terminates at the
    shared horizon, so all lanes of a vectorized rollout reset together and
    the KV-cache rollout prefills once per episode.  ``sync=False``: EOS
    terminates, the horizon truncates.
  * **reward** is programmatic and granted at episode end:
    ``reward_fn(tokens, prompt_len, length) -> [N]`` over the final
    sequences.

The observation is the whole generation state: the ``[ctx]`` token window
(right-padded), then ``length`` and ``t``, all float32 (``make_obs`` /
``split_obs``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.rl.env import Env

__all__ = ["TokenEnv", "TokenEnvState", "split_obs", "make_obs", "target_token_reward", "PAD", "EOS"]

PAD = 0
EOS = 1


class TokenEnvState(NamedTuple):
    tokens: torch.Tensor      # [N, ctx] int32: prompt + generated, right-padded
    length: torch.Tensor      # [N] int32: filled slots
    prompt_len: torch.Tensor  # [N] int32
    t: torch.Tensor           # [N] int32: decode step within the episode
    finished: torch.Tensor    # [N] bool: EOS emitted (absorbing under sync mode)


def make_obs(tokens: torch.Tensor, length: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., ctx] int tokens + [...] scalars -> the float32 [..., ctx + 2] observation."""
    return torch.cat([tokens.float(), length.float()[..., None], t.float()[..., None]], dim=-1)


def split_obs(obs: torch.Tensor, ctx: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of ``make_obs``: obs [..., ctx+2] -> (tokens [..., ctx] int32,
    length [...] int32, t [...] int32)."""
    tokens = obs[..., :ctx].to(torch.int32)
    length = obs[..., ctx].to(torch.int32)
    t = obs[..., ctx + 1].to(torch.int32)
    return tokens, length, t


def target_token_reward(target: int = 3) -> Callable:
    """Stub programmatic reward: fraction of generated (non-PAD) tokens equal
    to ``target``, per lane."""

    def reward_fn(tokens: torch.Tensor, prompt_len: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        idx = torch.arange(tokens.shape[-1], device=tokens.device)
        gen = (idx >= prompt_len[..., None]) & (idx < length[..., None]) & (tokens != PAD)
        hits = torch.sum(torch.where(gen, (tokens == target).float(), 0.0), dim=-1)
        return hits / torch.clamp(torch.sum(gen.float(), dim=-1), min=1.0)

    return reward_fn


class TokenEnv(Env):
    """Prompts as resets, tokens as actions, programmatic reward at the end.

    ``ctx >= max_prompt + horizon`` is enforced so a generation never
    overruns the token window, which also means a KV cache of window ``ctx``
    never wraps its ring buffer mid-episode (slot == position), the
    invariant the decode rollout path relies on.
    """

    def __init__(
        self,
        vocab_size: int = 17,
        ctx: int = 32,
        min_prompt: int = 4,
        max_prompt: int = 8,
        horizon: int = 16,
        reward_fn: Optional[Callable] = None,
        sync: bool = True,
    ):
        if ctx < max_prompt + horizon:
            raise ValueError(
                f"ctx={ctx} < max_prompt+horizon={max_prompt + horizon}: "
                "generation would overrun the token window"
            )
        if not (0 < min_prompt <= max_prompt):
            raise ValueError("need 0 < min_prompt <= max_prompt")
        self.vocab_size = vocab_size
        self.ctx = ctx
        self.min_prompt = min_prompt
        self.max_prompt = max_prompt
        self.horizon = horizon
        self.sync = sync
        self.reward_fn = reward_fn or target_token_reward()
        self.obs_dim = ctx + 2
        self.num_actions = vocab_size

    # --------------------------------------------------------------- protocol
    def reset(
        self, num_envs: int, generator: torch.Generator, device: Any
    ) -> Tuple[TokenEnvState, torch.Tensor]:
        prompt_len = torch.randint(
            self.min_prompt, self.max_prompt + 1, (num_envs,), generator=generator, device=device
        ).to(torch.int32)
        # Prompt tokens avoid PAD/EOS so prompts are unambiguous content.
        body = torch.randint(
            2, self.vocab_size, (num_envs, self.ctx), generator=generator, device=device
        ).to(torch.int32)
        idx = torch.arange(self.ctx, device=device)
        tokens = torch.where(idx[None] < prompt_len[:, None], body, PAD)
        st = TokenEnvState(
            tokens=tokens,
            length=prompt_len,
            prompt_len=prompt_len,
            t=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            finished=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        )
        return st, make_obs(st.tokens, st.length, st.t)

    def step_raw(self, st: TokenEnvState, action: torch.Tensor):
        tok = torch.where(st.finished, PAD, action.to(torch.int32))
        idx = torch.arange(self.ctx, device=st.tokens.device)
        tokens = torch.where(idx[None] == st.length[:, None], tok[:, None], st.tokens)
        length = st.length + 1
        t = st.t + 1
        finished = st.finished | (tok == EOS)
        if self.sync:
            # Absorbing EOS: every lane terminates together at the horizon.
            terminated = t >= self.horizon
            truncated = torch.zeros_like(terminated)
        else:
            terminated = (tok == EOS) & ~st.finished
            truncated = (t >= self.horizon) & ~terminated
        done = terminated | truncated
        reward = torch.where(done, self.reward_fn(tokens, st.prompt_len, length).float(), 0.0)
        new = TokenEnvState(tokens, length, st.prompt_len, t, finished)
        return new, make_obs(tokens, length, t), reward, terminated, truncated
