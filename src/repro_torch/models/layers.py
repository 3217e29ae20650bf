"""Transformer building blocks on tensors (PyTorch port of
``repro/models/layers.py``): norms, rope, MLPs, and attention (GQA, MLA,
qk-norm, QKV bias, sliding window) with a training/prefill path and a
single-token decode path against a ring-buffer KV cache, in the model's
dtype or in int8 with per-row bfloat16 scales.

GQA attention goes through ``ops.flash_attention`` (training, prefill) and
``ops.decode_attention`` (decode).  MLA, whose query/key and value head dims
differ, trains through ``chunked_attention``, the port's copy of the
reference's plain memory-bounded attention (``repro/kernels/ref.py``), as the
reference does, and decodes in the latent space with plain einsums.

Functions are pure over plain dict parameter trees in the reference's
``[din, dout]`` layout, so ``repro_torch.interop`` carries weights across.
The reference's sharding annotations (``shard``) are no-ops without a mesh
and are dropped.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import get_axis_rules, shard
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
    "chunked_attention",
    "torch_dtype",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` as a torch dtype."""
    return _DTYPES[name]


def split_heads(x: torch.Tensor, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """[B, S, H * hd] -> ``shape`` = [B, S, H, hd].  Under sharding rules whose
    'model' axis does not divide H (40 heads on 16 devices), the flat dim is
    gathered first: a shard of H * hd need not fall on a head's bounds."""
    rules = get_axis_rules()
    if rules is not None and rules.mesh is not None and rules.resolve(
        ["heads"], shape=[shape[2]]
    )[0] is None:
        x = shard(x, "batch", None, None)
    return x.reshape(shape)


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
    h = shard(h, "batch", None, "d_ff")
    if cfg.activation == "silu":
        h = F.silu(x @ params["gate"]) * h
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(h))
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return shard(h @ params["down"], "batch", None, None)


# --------------------------------------------------------- attention (GQA)
def attention_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    dtype = torch_dtype(cfg.dtype)
    device = generator.device
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        H = cfg.num_heads

        def up(width: int) -> torch.Tensor:
            w = torch.randn((m.kv_lora_rank, H, width), generator=generator, device=device)
            return (w / math.sqrt(m.kv_lora_rank)).to(dtype)

        return {
            "wq": dense_init(generator, d, H * (m.nope_head_dim + m.rope_head_dim), dtype),
            "w_dkv": dense_init(generator, d, m.kv_lora_rank + m.rope_head_dim, dtype),
            # up-projections from the latent: [lora, H, nope] and [lora, H, v]
            "w_uk": up(m.nope_head_dim),
            "w_uv": up(m.v_head_dim),
            "wo": dense_init(generator, H * m.v_head_dim, d, dtype),
        }
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
    q = split_heads(q, (B, S, cfg.num_heads, hd))
    k = split_heads(k, (B, S, cfg.num_kv_heads, hd))
    v = split_heads(v, (B, S, cfg.num_kv_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def _mla_qkv_train(params: PyTree, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """MLA without absorption (the training/prefill path): q and k carry the
    shared rope part in the head dim, so qk heads are nope + rope wide."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q = split_heads(x @ params["wq"], (B, S, H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = x @ params["w_dkv"]  # [B, S, lora + rope_dim]
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank :]
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)  # one shared head
    k_nope = torch.einsum("bsc,chn->bshn", c, params["w_uk"])
    v = torch.einsum("bsc,chv->bshv", c, params["w_uv"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)], dim=-1)
    q_full = shard(q_full, "batch", None, "heads", None)
    k_full = shard(k_full, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    return q_full, k_full, v


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Memory-bounded attention (the reference's ``ref.chunked_attention``):
    q [B, Sq, H, D] against k [B, Sk, KV, D] and v [B, Sk, KV, Dv], one query
    chunk at a time, so the score buffer peaks at [B, H, chunk, Sk].  Under
    autograd each chunk is checkpointed: the backward recomputes its scores
    instead of keeping them.  Plain torch on either device; the model uses it
    where the head dims differ (MLA), as the reference does."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    orig_Sq = Sq
    if Sq % chunk:
        q = F.pad(q, (0, 0, 0, 0, 0, chunk - Sq % chunk))
        Sq = q.shape[1]
    k_pos = torch.arange(Sk, device=q.device)

    def one_chunk(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int) -> torch.Tensor:
        qg = qi.reshape(B, chunk, KV, g, D)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
        q_pos = q_offset + start + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
        return out.reshape(B, chunk, H, v.shape[-1])

    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for start in range(0, Sq, chunk):
        qi = q[:, start : start + chunk]
        if remat:
            outs.append(checkpoint(one_chunk, qi, k, v, start, use_reentrant=False))
        else:
            outs.append(one_chunk(qi, k, v, start))
    return torch.cat(outs, dim=1)[:, :orig_Sq]


def attention_apply(
    params: PyTree,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Training / prefill attention (no cache). x: [B, S, d]."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    win = window or cfg.sliding_window
    if cfg.mla is not None:
        # Distinct qk and v head dims: the plain chunked path, as the
        # reference (its Pallas kernel, like the CUDA one, takes equal dims).
        q, k, v = _mla_qkv_train(params, x, cfg, positions)
        out = chunked_attention(q, k, v, causal=True, window=win)
        return shard(out.reshape(B, S, -1) @ params["wo"], "batch", None, None)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = kops.flash_attention(q, k, v, causal=True, window=win)
    return shard(out.reshape(B, S, -1) @ params["wo"], "batch", None, None)


# ------------------------------------------------------------ decode / cache
def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] -> (int8 values, per-row bfloat16 scale): the int8
    cache's storage format; the arithmetic is float32."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def init_attn_cache(cfg: ModelConfig, batch: int, window: int, device: Any = "cpu") -> PyTree:
    dtype = torch_dtype(cfg.dtype)

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        return {"c": zeros(batch, window, m.kv_lora_rank),
                "k_rope": zeros(batch, window, m.rope_head_dim)}
    shape = (batch, window, cfg.num_kv_heads)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k_q": zeros(*shape, cfg.head_dim, dtype=torch.int8),
            "k_s": zeros(*shape, 1, dtype=torch.bfloat16),
            "v_q": zeros(*shape, cfg.head_dim, dtype=torch.int8),
            "v_s": zeros(*shape, 1, dtype=torch.bfloat16),
        }
    return {"k": zeros(*shape, cfg.head_dim), "v": zeros(*shape, cfg.head_dim)}


def _ring_write(pos: torch.Tensor, B: int, W: int, device) -> torch.Tensor:
    """[B, W] bool: the ring-buffer slot each lane writes (pos % W), for a
    scalar pos or a [B] vector of per-lane positions."""
    slot = pos % W
    window_pos = torch.arange(W, device=device)
    if pos.dim() == 0:
        return (window_pos == slot)[None].expand(B, W)
    return window_pos[None] == slot[:, None]


def _ring_valid(pos: torch.Tensor, W: int, device) -> torch.Tensor:
    """Ring-buffer occupancy after the write at pos: [W], or [B, W] for
    per-lane positions."""
    window_pos = torch.arange(W, device=device)
    last = torch.clamp(pos, max=W - 1)
    if pos.dim() == 0:
        return window_pos <= last
    return window_pos[None] <= last[:, None]


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
    if cfg.mla is not None:
        return _mla_decode(params, x, cache, pos, cfg)
    B = x.shape[0]
    quant = "k_q" in cache
    W = (cache["k_q"] if quant else cache["k"]).shape[1]
    hd = cfg.head_dim
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = split_heads(q, (B, 1, cfg.num_heads, hd))
    k = split_heads(k, (B, 1, cfg.num_kv_heads, hd))
    v = split_heads(v, (B, 1, cfg.num_kv_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    hit = _ring_write(pos, B, W, x.device)[:, :, None, None]
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache_axes = ("batch", "window", "kv_heads", None)
        new_cache = {
            "k_q": shard(torch.where(hit, kq, cache["k_q"]), *cache_axes),
            "k_s": shard(torch.where(hit, ks, cache["k_s"]), *cache_axes),
            "v_q": shard(torch.where(hit, vq, cache["v_q"]), *cache_axes),
            "v_s": shard(torch.where(hit, vs, cache["v_s"]), *cache_axes),
        }
        # Dequantize for the attention math, as the reference: the cache
        # kept between steps is int8 either way, which is the memory win.
        ck = _dequantize_kv(new_cache["k_q"], new_cache["k_s"], k.dtype)
        cv = _dequantize_kv(new_cache["v_q"], new_cache["v_s"], v.dtype)
    else:
        ck = shard(torch.where(hit, k, cache["k"]), "batch", "window", "kv_heads", None)
        cv = shard(torch.where(hit, v, cache["v"]), "batch", "window", "kv_heads", None)
        new_cache = {"k": ck, "v": cv}
    out = kops.decode_attention(q, ck, cv, _ring_valid(pos, W, x.device))
    return shard(out.reshape(B, 1, -1) @ params["wo"], "batch", None, None), new_cache


def _mla_decode(
    params: PyTree, x: torch.Tensor, cache: PyTree, pos: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, PyTree]:
    """MLA decode with matrix absorption: attend in the latent space, so the
    cache is only [B, W, lora + rope] (the technique's memory win)."""
    m = cfg.mla
    B = x.shape[0]
    W = cache["c"].shape[1]
    H = cfg.num_heads
    positions = pos[None] if pos.dim() == 0 else pos[:, None]

    q = split_heads(x @ params["wq"], (B, 1, H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = x @ params["w_dkv"]
    c_new, k_rope_new = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank :]
    k_rope_new = rope(k_rope_new[..., None, :], positions, cfg.rope_theta)[..., 0, :]

    hit = _ring_write(pos, B, W, x.device)[:, :, None]
    cc = torch.where(hit, c_new, cache["c"])
    cr = torch.where(hit, k_rope_new, cache["k_rope"])

    # Absorb W_uk into the query: q_lat [B, H, lora].
    q_lat = torch.einsum("bhn,chn->bhc", q_nope[:, 0], params["w_uk"])
    scores = torch.einsum("bhc,bwc->bhw", q_lat.float(), cc.float())
    scores = scores + torch.einsum("bhr,bwr->bhw", q_rope[:, 0].float(), cr.float())
    scores = scores * (1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim))
    valid = _ring_valid(pos, W, x.device)
    if valid.dim() == 1:
        valid = valid[None].expand(B, W)
    vmask = valid[:, None]
    scores = torch.where(vmask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(vmask, p, torch.zeros_like(p)).to(cc.dtype)  # empty cache -> zeros
    ctx_lat = torch.einsum("bhw,bwc->bhc", p, cc)
    # Absorb W_uv on the way out.
    v = torch.einsum("bhc,chv->bhv", ctx_lat, params["w_uv"])
    out = v.reshape(B, 1, H * m.v_head_dim) @ params["wo"]
    return shard(out, "batch", None, None), {"c": cc, "k_rope": cr}
