"""Dispatch layer for the compute hot spots (PyTorch port of
``repro/kernels/ops.py``).

Dispatch is by the device of the tensors: a CUDA tensor goes to the
hand-written CUDA kernel, a CPU tensor to the kernel's plain PyTorch
version.  There is no override and no fallback: a CUDA call the kernel
cannot take raises.  While the cost walker prices a step
(``repro_torch.distributed.hlo_cost``) each call is charged as one kernel
at its bound's formula and launches nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import hlo_cost as _cost
from repro_torch.kernels.advantages import gae_cuda, vtrace_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.moe_gmm import (
    moe_gmm_cuda,
    moe_gmm_dw_cuda,
    moe_gmm_dw_plain,
    moe_gmm_dx_cuda,
    moe_gmm_dx_plain,
    moe_gmm_plain,
)
from repro_torch.kernels.rwkv6 import rwkv6_cuda, rwkv6_plain
from repro_torch.kernels.surrogate import ppo_surrogate_cuda, ppo_surrogate_plain

__all__ = [
    "decode_attention",
    "flash_attention",
    "fused_gae",
    "fused_ppo_loss",
    "fused_vtrace",
    "moe_gmm",
    "moe_gmm_dw",
    "moe_gmm_dx",
    "rwkv6",
]


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
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("flash_attention", q, k, v, causal, window, q_offset)
    attention = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: [B,1,H,D]; caches: [B,W,KV,D]; valid: [W] (shared) or [B,W]
    (per-sequence occupancy). Rows with no valid slot return zeros.
    """
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("decode_attention", q, k_cache, v_cache, valid)
    attention = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return attention(q, k_cache, v_cache, valid)


def rwkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence, r/k/v/w [B, T, H, N], u [H, N], optional start
    state [B, H, N, N]; returns (out, final state).  CUDA tensors go to the
    kernels (forward and backward) with or without a start state: unlike the
    reference, which routes a nonzero state to its oracle, nothing here
    falls back.  ``chunk`` is the backward's remat length: the kernel saves
    one state per chunk, and the CPU's step loop checkpoints per chunk."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("rwkv6", r, k, v, w, u, state, chunk)
    if r.is_cuda:
        return rwkv6_cuda(r, k, v, w, u, state=state, chunk=chunk)
    return rwkv6_plain(r, k, v, w, u, state=state, chunk=chunk)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            block_m: int = 128) -> torch.Tensor:
    """Grouped matmul [T, D] x [E, D, F] -> [T, F] over expert-contiguous
    rows: a CUDA kernel for CUDA tensors, the loop over groups for CPU
    tensors.  ``block_m`` is the reference's row block, the rows the
    caller's groups hold (at most 128): on the card it picks the kernel
    (``moe_gmm.gmm_route``), the small-group kernel at a decode step's
    groups and the 128-row-tile kernel above; the plain version ignores it.
    Both kernels take any group sizes, so the reference's ``block_n`` and
    its alignment of groups to the block have no counterpart.  The cost
    walker charges the function, the same whichever kernel runs."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("moe_gmm", x, w, group_sizes)
    if x.is_cuda:
        return moe_gmm_cuda(x, w, group_sizes, block_m=block_m)
    return moe_gmm_plain(x, w, group_sizes)


def moe_gmm_dx(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``moe_gmm``'s gradient with respect to x, dy [T, F] x w[e]^T -> [T, D]
    per group: the dX kernel for CUDA tensors, the loop over groups for CPU
    tensors."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("moe_gmm_dx", dy, w, group_sizes)
    if dy.is_cuda:
        return moe_gmm_dx_cuda(dy, w, group_sizes)
    return moe_gmm_dx_plain(dy, w, group_sizes)


def moe_gmm_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``moe_gmm``'s gradient with respect to w, x_e^T dy_e over each
    group's rows -> [E, D, F]: the dW kernel for CUDA tensors, the loop over
    groups for CPU tensors."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("moe_gmm_dw", x, dy, group_sizes)
    if x.is_cuda:
        return moe_gmm_dw_cuda(x, dy, group_sizes)
    return moe_gmm_dw_plain(x, dy, group_sizes)


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
    args = (logits, values, actions, behaviour_logp, advantages, returns)
    if _cost.LOCAL.walker is not None:
        terms = _cost.LOCAL.walker.kernel("ppo_surrogate", *args, clip_eps=clip_eps)
    else:
        surrogate = ppo_surrogate_cuda if logits.is_cuda else ppo_surrogate_plain
        terms = surrogate(*args, clip_eps=clip_eps)
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
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("gae", rewards, values, dones, last_value, gamma, lam)
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
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel(
            "vtrace", behaviour_logp, target_logp, rewards, values, dones, last_value, **kw)
    if rewards.is_cuda:
        return vtrace_cuda(behaviour_logp, target_logp, rewards, values, dones, last_value, **kw)
    from repro_torch.rl.advantages import vtrace

    return vtrace(behaviour_logp, target_logp, rewards, values, dones, last_value, **kw)
