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
The reference's sharding annotations (``shard``) are kept; with the
products (``dense``) and the attention of heads a mesh axis cannot split
(``_flash``) they state the reference's layouts for the dry run's DTensors
and compute nothing without axis rules.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_index, get_axis_rules, shard, shard_map
from repro_torch.kernels import ops as kops

PyTree = Any

__all__ = [
    "rms_norm",
    "rope",
    "dense",
    "dense_init",
    "mlp_init",
    "mlp_apply",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "init_attn_cache",
    "product",
    "chunked_attention",
    "torch_dtype",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` as a torch dtype."""
    return _DTYPES[name]


def _heads_unsplit(heads: int) -> bool:
    """Whether sharding rules are active whose 'model' axis does not divide
    ``heads`` (40 heads on 16 devices): a shard of H * hd then need not fall
    on a head's bounds."""
    rules = get_axis_rules()
    return rules is not None and rules.mesh is not None and rules.resolve(
        ["heads"], shape=[heads]
    )[0] is None


def split_heads(x: torch.Tensor, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """[B, S, H * hd] -> ``shape`` = [B, S, H, hd], the flat dim gathered
    first where the heads cannot be split (``_heads_unsplit``)."""
    if _heads_unsplit(shape[2]):
        x = shard(x, "batch", None, None)
    return x.reshape(shape)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, H * hd]; where the heads cannot be split, the
    merged dim (and so its gradient, which the split reads back) is kept
    whole."""
    B, S, H, _ = x.shape
    x = x.reshape(B, S, -1)
    if _heads_unsplit(H):
        x = shard(x, "batch", None, None)
    return x


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    # Where the features are split over a mesh axis the mean is a partial
    # sum there: reduced in place, as GSPMD does (DTensor would rather split
    # the rows over that axis, a layout the products after it cannot take).
    var = shard(torch.mean(torch.square(x), dim=-1, keepdim=True),
                "batch", *([None] * (x.dim() - 1)))
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
def dense(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """``x @ w`` for the weight called ``name`` (a [din, dout] leaf of
    ``distributed/specs.py``'s table), in its layout (``product``)."""
    from repro_torch.distributed.specs import _PARAM_RULES

    lead = ("batch",) + (None,) * (x.dim() - 2)
    return product(torch.matmul, x, w, lead, _PARAM_RULES[name])


def product(fn: Any, x: torch.Tensor, w: torch.Tensor, x_lead: Tuple, w_axes: Tuple) -> Any:
    """``fn(x, w)``, a product over x's last dim and w's second to last;
    ``x_lead`` names x's other dims and ``w_axes`` all of w's (its spec).

    Under sharding rules whose mesh places ``w``, the product runs on each
    rank's shards in the layout the weight's own spec gives GSPMD: its
    tensor-parallel dim (heads, d_ff, vocab, experts) split, its 'fsdp' dim
    gathered and x's rows on their batch shard; or, where the batch cannot
    take the 'fsdp' axes (a decode of one sequence), the weight left in
    place and x split alike, as GSPMD keeps a weight in place when the
    activations are the smaller side.  A split contraction leaves a partial
    sum that the caller's ``shard`` reduces.  Stated here because DTensor's
    own choice per product can gather a weight whole (it prices the
    collectives, not the work) or split rows over an axis the next product
    has no rule for.
    """
    rules = get_axis_rules()
    if rules is None or rules.mesh is None or not hasattr(w, "placements"):
        return fn(x, w)
    *w_lead, k, n = w_axes
    stationary = "fsdp" in (k, n) and rules.resolve(["batch"], shape=x.shape[:1])[0] is None \
        and rules.resolve(["fsdp"], shape=[w.shape[-2 if k == "fsdp" else -1]])[0] is not None
    if not stationary:
        k, n = (None if a == "fsdp" else a for a in (k, n))
    split = rules.resolve([k], shape=w.shape[-2:-1])[0] if k else None
    return shard_map(fn, (tuple(x_lead) + (k,), (*w_lead, k, n)), tuple(x_lead) + (n,), x, w,
                     partial=(split,) if isinstance(split, str) else (split or ()))


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
    h = dense(x, params["up"], "up")
    h = shard(h, "batch", None, "d_ff")
    if cfg.activation == "silu":
        h = F.silu(dense(x, params["gate"], "gate")) * h
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(h))
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return shard(dense(h, params["down"], "down"), "batch", None, None)


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
    q = dense(x, params["wq"], "wq")
    k = dense(x, params["wk"], "wk")
    v = dense(x, params["wv"], "wv")
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
    q = split_heads(dense(x, params["wq"], "wq"), (B, S, H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = dense(x, params["w_dkv"], "w_dkv")  # [B, S, lora + rope_dim]
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
        heads = ("batch", None, "heads", None)
        out = shard_map(lambda q, k, v: chunked_attention(q, k, v, causal=True, window=win),
                        (heads, heads, heads), heads, q, k, v)
        return shard(dense(merge_heads(out), params["wo"], "wo"), "batch", None, None)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _flash(q, k, v, win)
    return shard(dense(merge_heads(out), params["wo"], "wo"), "batch", None, None)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """Causal ``ops.flash_attention`` over [B, S, H, D].

    Under sharding rules whose heads axis does not divide H (40 heads on
    16 devices), the heads stay whole on every rank, so the queries are
    split over that axis instead, each rank taking two of 2m blocks of S
    (blocks i and 2m-1-i: every rank the same share of the causal square)
    against the whole K and V.  Each rank's result holds its own rows and
    zeros elsewhere, a partial sum over the axis that ``merge_heads``
    reduces.  Elsewhere it is the one kernel call."""
    rules = get_axis_rules()
    H, S = q.shape[2], q.shape[1]
    if not _heads_unsplit(H) or not hasattr(q, "placements"):
        return kops.flash_attention(q, k, v, causal=True, window=window)
    axes = rules.rules.get("heads")
    index, m = axis_index(rules.mesh, axes)
    if m == 1 or S % (2 * m):
        return kops.flash_attention(q, k, v, causal=True, window=window)
    L = S // (2 * m)

    def local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        parts, at = [], 0
        for b in sorted((index, 2 * m - 1 - index)):
            parts.append(torch.zeros_like(q[:, at:b * L]))
            parts.append(kops.flash_attention(q[:, b * L:(b + 1) * L], k, v, causal=True,
                                              window=window, q_offset=b * L))
            at = (b + 1) * L
        parts.append(torch.zeros_like(q[:, at:]))
        return torch.cat(parts, dim=1)

    rows = ("batch", None, None, None)
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if a in rules.mesh.mesh_dim_names)
    return shard_map(local, (rows, rows, rows), rows, q, k, v, partial=axes)


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
    q = dense(x, params["wq"], "wq")
    k = dense(x, params["wk"], "wk")
    v = dense(x, params["wv"], "wv")
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
    out = _decode(q, ck, cv, _ring_valid(pos, W, x.device))
    return shard(dense(merge_heads(out), params["wo"], "wo"), "batch", None, None), new_cache


def _decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``ops.decode_attention`` of q [B, 1, H, D] against a [B, W, KV, D] cache.

    Under sharding rules whose mesh splits the cache's window, each rank
    attends over its own slice of the window with every query head (q is
    gathered; the cache stays where it is), and the softmax is merged over
    the window's axis: a maximum, then partial sums of the weights and of
    the weighted values.  That is the plain decode attention partitioned as
    GSPMD partitions the reference's, in plain ops, as the reference's dry
    run prices it.  Elsewhere it is the one kernel call."""
    rules = get_axis_rules()
    B, _, H, D = q.shape
    W, KV = ck.shape[1], ck.shape[2]
    if rules is None or rules.mesh is None or not hasattr(ck, "placements"):
        return kops.decode_attention(q, ck, cv, valid)
    split = rules.resolve(["window"], shape=[W])[0]
    if split is None:
        return kops.decode_attention(q, ck, cv, valid)
    axes = (split,) if isinstance(split, str) else tuple(split)
    if valid.dim() == 1:
        valid = valid[None].expand(B, W)
    rows, cache, window = ("batch", None, None, None), ("batch", "window", None, None), ("batch", "window")
    g = H // KV

    def scores(q, k, valid):  # [B, KV, g, W_local] over the local window
        s = torch.einsum("bkgd,bwkd->bkgw", q[:, 0].reshape(q.shape[0], KV, g, D).float(), k.float())
        return torch.where(valid[:, None, None], s / math.sqrt(D), torch.full_like(s, -1e30))

    s = shard_map(scores, (rows, cache, window), ("batch", None, None, "window"), q, ck, valid)
    m = shard(shard_map(lambda s: s.amax(dim=-1), (("batch", None, None, "window"),),
                        ("batch", None, None), s, partial=axes, reduce_op="max"), "batch", None, None)

    def weighted(s, m, v, valid):  # the local window's share of the softmax's sums
        e = torch.where(valid[:, None, None], torch.exp(s - m[..., None]), torch.zeros_like(s))
        return e.sum(dim=-1), torch.einsum("bkgw,bwkd->bkgd", e, v.float())

    den, num = shard_map(weighted, (("batch", None, None, "window"), ("batch", None, None), cache,
                                    window), (("batch", None, None), ("batch", None, None, None)),
                         s, m, cv, valid, partial=axes)
    den, num = shard(den, "batch", None, None), shard(num, "batch", None, None, None)
    out = num / torch.clamp(den, min=1e-30)[..., None]  # no valid slot: zeros
    return out.reshape(B, 1, H, D).to(q.dtype)


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

    q = split_heads(dense(x, params["wq"], "wq"), (B, 1, H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = dense(x, params["w_dkv"], "w_dkv")
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
    out = dense(v.reshape(B, 1, H * m.v_head_dim), params["wo"], "wo")
    return shard(out, "batch", None, None), {"c": cc, "k_rope": cr}
