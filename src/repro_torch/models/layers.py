"""Transformer building blocks on tensors (PyTorch port of the dense-attention
subset of ``repro/models/layers.py``): norms, rope, MLPs and GQA attention
with a training/prefill path (``ops.flash_attention``) and a single-token
decode path against a ring-buffer KV cache (``ops.decode_attention``).

Functions are pure over plain dict parameter trees in the reference's
``[din, dout]`` layout, so ``repro_torch.interop`` carries weights across.
The reference's sharding annotations (``shard``) are no-ops without a mesh
and are dropped.  MLA attention and the int8 KV cache wait for a later slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

PyTree = Any

__all__ = [
    "rms_norm",
    "rope",
    "dense_init",
    "mlp_init",
    "mlp_apply",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "init_attn_cache",
    "torch_dtype",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` as a torch dtype."""
    return _DTYPES[name]


def _unported(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention (cfg.mla) is not ported to repro_torch yet")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported to repro_torch yet")


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D]; positions: [S] or [B, S]."""
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions.float()[..., None] * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- linear
def dense_init(
    generator: torch.Generator, din: int, dout: int, dtype: torch.dtype, scale: float = 1.0
) -> torch.Tensor:
    std = scale / math.sqrt(din)
    w = torch.randn((din, dout), generator=generator, device=generator.device) * std
    return w.to(dtype)


# --------------------------------------------------------------------- MLP
def mlp_init(generator: torch.Generator, cfg: ModelConfig, d_ff: int) -> PyTree:
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    p = {
        "up": dense_init(generator, d, d_ff, dtype),
        "down": dense_init(generator, d_ff, d, dtype),
    }
    if cfg.activation == "silu":  # gated
        p["gate"] = dense_init(generator, d, d_ff, dtype)
    return p


def mlp_apply(params: PyTree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ params["up"]
    if cfg.activation == "silu":
        h = F.silu(x @ params["gate"]) * h
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(h))
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return h @ params["down"]


# --------------------------------------------------------- attention (GQA)
def attention_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    _unported(cfg)
    dtype = torch_dtype(cfg.dtype)
    device = generator.device
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, cfg.num_heads * hd, dtype),
        "wk": dense_init(generator, d, cfg.num_kv_heads * hd, dtype),
        "wv": dense_init(generator, d, cfg.num_kv_heads * hd, dtype),
        "wo": dense_init(generator, cfg.num_heads * hd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(params: PyTree, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(
    params: PyTree,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Training / prefill attention (no cache). x: [B, S, d]."""
    _unported(cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    win = window or cfg.sliding_window
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = kops.flash_attention(q, k, v, causal=True, window=win)
    return out.reshape(B, S, -1) @ params["wo"]


# ------------------------------------------------------------ decode / cache
def init_attn_cache(cfg: ModelConfig, batch: int, window: int, device: Any = "cpu") -> PyTree:
    _unported(cfg)
    shape = (batch, window, cfg.num_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attention_decode(
    params: PyTree,
    x: torch.Tensor,
    cache: PyTree,
    pos: torch.Tensor,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, PyTree]:
    """Single-token decode with ring-buffer KV cache.

    x: [B, 1, d]; pos: scalar int absolute position, or a [B] vector of
    per-lane positions (co-batched sequences at ragged depths); cache
    window W. Returns (out [B, 1, d], new_cache); the cache is not written
    in place.
    """
    _unported(cfg)
    B = x.shape[0]
    W = cache["k"].shape[1]
    hd = cfg.head_dim
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, 1, cfg.num_heads, hd)
    k = k.reshape(B, 1, cfg.num_kv_heads, hd)
    v = v.reshape(B, 1, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    slot = pos % W
    window_pos = torch.arange(W, device=x.device)
    if pos.dim() == 0:
        hit = (window_pos == slot)[None].expand(B, W)
    else:
        # Per-lane write slot: one-hot select along the window axis.
        hit = window_pos[None] == slot[:, None]  # [B, W]
    hit = hit[:, :, None, None]
    ck = torch.where(hit, k, cache["k"])
    cv = torch.where(hit, v, cache["v"])
    new_cache = {"k": ck, "v": cv}

    last = torch.clamp(pos, max=W - 1)
    if pos.dim() == 0:
        valid = window_pos <= last  # ring-buffer occupancy
    else:
        valid = window_pos[None] <= last[:, None]  # [B, W]
    out = kops.decode_attention(q, ck, cv, valid)
    return out.reshape(B, 1, -1) @ params["wo"], new_cache
