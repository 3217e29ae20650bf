"""Recurrent layers on tensors (PyTorch port of ``repro/models/ssm.py``): the
RWKV-6 "Finch" time-mix with data-dependent decay, its sequence path through
``ops.rwkv6`` (the CUDA kernels on the card, the step loop on the CPU) and
its one-token decode; and Mamba, its sequence path and its one-token decode.
Each decode state is carried like env state in a rollout actor.

The reference computes the RWKV-6 decode step and Mamba's selective scan
with plain ops (no TPU kernel), and so does the port: the scan runs through
``scan_utils.chunked_scan`` in chunks of 128 steps, each checkpointed, as
the reference's, with each chunk's elementwise work done for the whole
chunk at once (``chunked_scan``'s ``prep`` and ``post``) rather than a step
at a time.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard, shard_map
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense, dense_init, rms_norm, torch_dtype
from repro_torch.models.scan_utils import chunked_scan

PyTree = Any

__all__ = [
    "rwkv6_init",
    "rwkv6_apply",
    "rwkv6_decode",
    "init_rwkv6_state",
    "mamba_init",
    "mamba_apply",
    "mamba_decode",
    "init_mamba_state",
]


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

    r = dense(mixed(0), params["wr"], "wr")
    k = dense(mixed(1), params["wk"], "wk")
    v = dense(mixed(2), params["wv"], "wv")
    g = F.silu(dense(mixed(3), params["wg"], "wg"))
    dd = dense(torch.tanh(dense(mixed(4), params["decay_w1"], "decay_w1")), params["decay_w2"],
               "decay_w2")
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
    return shard(dense(out, params["wo"], "wo"), "batch", None, None)


def init_rwkv6_state(cfg: ModelConfig, batch: int, device: Any = "cpu") -> PyTree:
    s = cfg.ssm
    H = cfg.d_model // s.head_dim
    return {
        "wkv": torch.zeros((batch, H, s.head_dim, s.head_dim), dtype=torch.float32, device=device),
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=torch_dtype(cfg.dtype), device=device),
    }


def _wkv_step(r1, k1, v1, w1, u, S):
    """One WKV step per (batch, head): (out [B, H, N], new state)."""
    kv = k1[..., :, None] * v1[..., None, :]
    o = torch.einsum("bhn,bhnm->bhm", r1, S + u[None, :, :, None] * kv)
    return o, w1[..., :, None] * S + kv


def rwkv6_decode(
    params: PyTree, x: torch.Tensor, state: PyTree, cfg: ModelConfig
) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode. x: [B, 1, d]; returns (out [B, 1, d], new state)."""
    B = x.shape[0]
    d = cfg.d_model
    x_prev = state["x_prev"][:, None, :]
    r, k, v, g, w = _rwkv6_streams(params, x, x_prev, cfg)
    r1, k1, v1, w1 = (z[:, 0].float() for z in (r, k, v, w))
    head = ("batch", "heads", None)
    o, S = shard_map(_wkv_step, (head, head, head, head, ("heads", None), head + (None,)),
                     (head, head + (None,)), r1, k1, v1, w1, params["bonus_u"].float(),
                     state["wkv"])
    out = o.reshape(B, 1, d).to(x.dtype)
    out = rms_norm(out, params["ln_out"], cfg.norm_eps) * g
    return shard(dense(out, params["wo"], "wo"), "batch", None, None), {"wkv": S, "x_prev": x[:, 0]}


# ================================================================== Mamba
def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time as stack + einsum, as the reference.
    xc: [B, T, d_in]; w: [K, d_in]; b: [d_in]."""
    K = w.shape[0]
    T = xc.shape[1]
    pad = F.pad(xc, (0, 0, K - 1, 0))
    stacked = torch.stack([pad[:, i : i + T] for i in range(K)], dim=-1)  # [B, T, d, K]
    return torch.einsum("btdk,kd->btd", stacked, w) + b


def mamba_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dtype = torch_dtype(cfg.dtype)
    device = generator.device
    # S4D-real initialization for A.
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=device)[None, :].repeat(d_in, 1)
    return {
        "in_proj": dense_init(generator, d, 2 * d_in, dtype),
        "conv_w": (
            torch.randn((s.d_conv, d_in), generator=generator, device=device) / math.sqrt(s.d_conv)
        ).to(dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, d_in, 2 * s.d_state + 1, dtype),  # -> B, C, dt
        "dt_bias": torch.full((d_in,), -4.0, dtype=dtype, device=device),  # softplus(-4): small dt
        "dt_proj": dense_init(generator, 1, d_in, dtype),
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, d_in, d, dtype),
    }


def _mamba_scan(
    params: PyTree, xc: torch.Tensor, h0: torch.Tensor, s
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan. xc: [B, T, d_in] (post conv + silu); h0: [B, d_in, N].
    Under sharding rules the recurrence runs on each (batch, d_in) shard, the
    layout of ``xc`` and of the state."""
    A = -torch.exp(params["A_log"])  # [d_in, N]
    proj = dense(xc, params["x_proj"], "x_proj")  # [B, T, 2N + 1]
    Bp, Cp, dt_in = proj[..., : s.d_state], proj[..., s.d_state : 2 * s.d_state], proj[..., -1:]
    dt = F.softplus(dense(dt_in, params["dt_proj"], "dt_proj") + params["dt_bias"])  # [B, T, d_in]
    seq, rows, state = ("batch", None, "d_ff"), ("batch", None, None), ("batch", "d_ff", None)
    ys, h = shard_map(_selective_scan, (seq, rows, rows, seq, ("d_ff", None), state),
                      (seq, state), xc, Bp, Cp, dt, A, h0)
    y = ys.float() + xc.float() * params["D"]
    return y.to(xc.dtype), h


def _selective_scan(xc, Bp, Cp, dt, A, h0):
    """The recurrence h_t = exp(dt_t A) h_t-1 + dt_t B_t x_t, y_t = h_t . C_t
    over [B, T, ...] inputs: (ys [B, T, d_in] in xc's dtype, final state)."""

    def prep(inp):
        # A chunk's xs [L, B, ...] stay in model dtype; math in fp32.  The
        # reference's step computes dA and dB x each step; here a chunk at a
        # time, the same elementwise ops in the same order.
        x_t, b_t, c_t, dt_t = (z.float() for z in inp)
        dA = torch.exp(dt_t[..., None] * A)  # [L, B, d_in, N]
        dBx = dt_t[..., None] * b_t[:, :, None, :] * x_t[..., None]
        return dA, dBx, c_t

    def step(h, inp):
        dA, dBx = inp[0], inp[1]
        h = dA * h + dBx
        return h, h

    def post(hs, prepped):
        # y_t = h_t . C_t for the chunk's L steps: [L, B, d_in].
        return torch.einsum("lbdn,lbn->lbd", hs, prepped[2]).to(xc.dtype)

    tm = lambda z: z.transpose(0, 1)  # noqa: E731
    h, ys = chunked_scan(step, h0, (tm(xc), tm(Bp), tm(Cp), tm(dt)), chunk=128, prep=prep, post=post)
    return ys.transpose(0, 1), h


def mamba_apply(params: PyTree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequence path. x: [B, T, d]."""
    s = cfg.ssm
    B = x.shape[0]
    d_in = s.expand * x.shape[-1]
    xz = dense(x, params["in_proj"], "in_proj")
    xc, z = xz[..., :d_in], xz[..., d_in:]
    xc = shard(xc, "batch", None, "d_ff")
    xc = F.silu(_causal_conv(xc, params["conv_w"], params["conv_b"]))
    h0 = torch.zeros((B, d_in, s.d_state), dtype=torch.float32, device=x.device)
    y, _ = _mamba_scan(params, xc, h0, s)
    return shard(dense(y * F.silu(z), params["out_proj"], "out_proj"), "batch", None, None)


def init_mamba_state(cfg: ModelConfig, batch: int, device: Any = "cpu") -> PyTree:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros(
            (batch, s.d_conv - 1, d_in), dtype=torch_dtype(cfg.dtype), device=device
        ),
    }


def mamba_decode(
    params: PyTree, x: torch.Tensor, state: PyTree, cfg: ModelConfig
) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode. x: [B, 1, d]; returns (out [B, 1, d], new state)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    xz = dense(x, params["in_proj"], "in_proj")
    xc, z = xz[..., :d_in], xz[..., d_in:]
    window = torch.cat([state["conv"], xc], dim=1)  # [B, d_conv, d_in]
    conv = torch.einsum("bkd,kd->bd", window, params["conv_w"]) + params["conv_b"]
    xc1 = F.silu(conv)[:, None, :]  # [B, 1, d_in]
    y, h = _mamba_scan(params, xc1, state["h"], s)
    out = dense(y * F.silu(z), params["out_proj"], "out_proj")
    return shard(out, "batch", None, None), {"h": h, "conv": window[:, 1:]}
