"""Recurrent layers on tensors (PyTorch port of the RWKV-6 part of
``repro/models/ssm.py``): the RWKV-6 "Finch" time-mix with data-dependent
decay, its sequence path through ``ops.rwkv6`` (the CUDA kernels on the
card, the step loop on the CPU) and its decode state.

Mamba and the one-token RWKV-6 decode belong to the serving slice and are
not ported yet; ``Model`` raises for a ``mamba`` layer.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, rms_norm, torch_dtype

PyTree = Any

__all__ = ["rwkv6_init", "rwkv6_apply", "init_rwkv6_state"]


def rwkv6_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    s = cfg.ssm
    d = cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    device = generator.device
    H = d // s.head_dim
    return {
        "wr": dense_init(generator, d, d, dtype),
        "wk": dense_init(generator, d, d, dtype),
        "wv": dense_init(generator, d, d, dtype),
        "wg": dense_init(generator, d, d, dtype),
        "wo": dense_init(generator, d, d, dtype),
        # Data-dependent decay (Finch): w_t = exp(-exp(w0 + tanh(x w1) w2))
        "decay_w1": dense_init(generator, d, 64, dtype),
        "decay_w2": dense_init(generator, 64, d, dtype, scale=0.1),
        "decay_w0": torch.full((d,), -2.0, dtype=dtype, device=device),
        "bonus_u": (
            torch.randn((H, s.head_dim), generator=generator, device=device) * 0.1
        ).to(dtype),
        # token-shift mix coefficients per stream
        "mix": (torch.rand((5, d), generator=generator, device=device) * 0.5 + 0.25).to(dtype),
        "ln_out": torch.ones((d,), dtype=dtype, device=device),
    }


def _rwkv6_streams(params: PyTree, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """Token-shift + projections. x: [B,T,d]; x_prev: [B,T,d] (shifted)."""
    s = cfg.ssm
    H = cfg.d_model // s.head_dim
    B, T, d = x.shape

    def mixed(i: int) -> torch.Tensor:
        mu = params["mix"][i]
        return x * mu + x_prev * (1 - mu)

    r = mixed(0) @ params["wr"]
    k = mixed(1) @ params["wk"]
    v = mixed(2) @ params["wv"]
    g = F.silu(mixed(3) @ params["wg"])
    dd = torch.tanh(mixed(4) @ params["decay_w1"]) @ params["decay_w2"]
    # As jnp.clip in the reference, except at a value exactly on a bound,
    # where jnp.clip passes half the gradient and torch.clamp all of it.
    log_w = -torch.exp(torch.clamp((params["decay_w0"] + dd).float(), -8.0, 2.0))  # <= 0
    w = torch.exp(log_w)  # decay in (0, 1]

    def hs(z: torch.Tensor) -> torch.Tensor:
        return z.reshape(B, T, H, s.head_dim)

    return hs(r), hs(k), hs(v), g, hs(w.to(x.dtype))


def rwkv6_apply(params: PyTree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequence path. x: [B, T, d] -> [B, T, d]."""
    B, T, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _rwkv6_streams(params, x, x_prev, cfg)
    out, _ = kops.rwkv6(r, k, v, w, params["bonus_u"].float(), chunk=cfg.ssm.chunk)
    out = out.reshape(B, T, d)
    out = rms_norm(out, params["ln_out"], cfg.norm_eps) * g
    return out @ params["wo"]


def init_rwkv6_state(cfg: ModelConfig, batch: int, device: Any = "cpu") -> PyTree:
    s = cfg.ssm
    H = cfg.d_model // s.head_dim
    return {
        "wkv": torch.zeros((batch, H, s.head_dim, s.head_dim), dtype=torch.float32, device=device),
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=torch_dtype(cfg.dtype), device=device),
    }
