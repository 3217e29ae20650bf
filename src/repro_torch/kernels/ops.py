"""Dispatch layer for the compute hot spots (PyTorch port of
``repro/kernels/ops.py``).

Dispatch is by the device of the tensors: a CUDA tensor goes to the
hand-written CUDA kernel, a CPU tensor to the kernel's plain PyTorch
version.  There is no override and no fallback: a CUDA call the kernel
cannot take raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.advantages import gae_cuda, vtrace_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.surrogate import ppo_surrogate_cuda, ppo_surrogate_plain

__all__ = ["decode_attention", "flash_attention", "fused_gae", "fused_ppo_loss", "fused_vtrace"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Prefill / training attention, q [B,Sq,H,D] against k, v [B,Sk,KV,D]:
    the CUDA kernels (forward and backward) for CUDA tensors, the plain
    version for CPU tensors."""
    attention = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: [B,1,H,D]; caches: [B,W,KV,D]; valid: [W] (shared) or [B,W]
    (per-sequence occupancy). Rows with no valid slot return zeros.
    """
    attention = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return attention(q, k_cache, v_cache, valid)


def fused_ppo_loss(
    logits: torch.Tensor,          # [B, A]
    values: torch.Tensor,          # [B]
    actions: torch.Tensor,         # [B] int
    behaviour_logp: torch.Tensor,  # [B]
    advantages: torch.Tensor,      # [B]
    returns: torch.Tensor,         # [B]
    clip_eps: float = 0.2,
    vf_coef: float = 0.5,
    ent_coef: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO clipped-surrogate loss downstream of ``logits_value``.

    Returns ``(loss, aux)`` with ``aux = {"pg_loss", "vf_loss", "entropy",
    "kl"}``; the batch means and the coefficient combination are shared by
    both paths.
    """
    surrogate = ppo_surrogate_cuda if logits.is_cuda else ppo_surrogate_plain
    terms = surrogate(
        logits, values, actions, behaviour_logp, advantages, returns, clip_eps=clip_eps
    )
    pg, vf, ent, kl = (t.mean() for t in terms)
    loss = pg + vf_coef * vf - ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent, "kl": kl}


def fused_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over time-major [T, ...]: the CUDA kernel for CUDA tensors, the
    reverse-time loop for CPU tensors."""
    if rewards.is_cuda:
        return gae_cuda(rewards, values, dones, last_value, gamma=gamma, lam=lam)
    # Imported here: ``repro_torch.rl``'s package init imports the rollout
    # worker, which imports this module.
    from repro_torch.rl.advantages import gae

    return gae(rewards, values, dones, last_value, gamma=gamma, lam=lam)


def fused_vtrace(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace over time-major [T, ...]: the CUDA kernel for CUDA tensors,
    the reverse-time loop for CPU tensors."""
    kw = dict(gamma=gamma, rho_clip=rho_clip, c_clip=c_clip)
    if rewards.is_cuda:
        return vtrace_cuda(behaviour_logp, target_logp, rewards, values, dones, last_value, **kw)
    from repro_torch.rl.advantages import vtrace

    return vtrace(behaviour_logp, target_logp, rewards, values, dones, last_value, **kw)
