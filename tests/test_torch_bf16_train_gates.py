"""The gates ``chip_smoke.py`` holds the bf16 backward kernels to, fixed on
the CPU from an emulation of each kernel's roundings before any card run.

* The flash backward (``csrc/flash_attention_bf16.cu``): P recomputed in
  fp32 from the forward's fp32 logsumexp, rounded to bf16 for dV += P^T dO;
  dS = P o (dP - delta) in fp32, rounded to bf16 for dK += dS^T Q and dQ +=
  dS K; delta from the bf16 O and dO; fp32 sums; each gradient rounded to
  bf16 once.  Against its plain version (autograd through the plain bf16
  forward: exact fp32 gradients rounded once) every element must be within
  ``chip_smoke.GRAD_ROW_TOL`` x (m + its own |plain|), m the largest |plain|
  of its row (one head's D gradient values: a query's dq, a key's dk or
  dv; at least 2^-8 of the tensor's largest), dq's plus the most the bf16
  O's delta moves its row (``chip_smoke._dq_allowance``).  The emulation
  must stay within ``MARGIN`` of that limit at six shapes, and one 64-key
  tile dropped from the dQ sums, or one 64-query tile from a kv head's dK
  and dV sums, must exceed it.
* RWKV-6 at bf16 (``csrc/rwkv6.cu``): the float32 kernels' arithmetic on
  the widened operands, each output rounded once, so the kernel and its
  plain version are each their float32 computation rounded once.  With the
  float32 kernel's own tolerances (1e-5 forward, 1e-4 gradients, relative
  to a row's largest value) standing in for the kernel's float32 error, the
  rounded outputs must be within the same per-row limit
  (``chip_smoke.BF16_TOL`` for the output, ``GRAD_ROW_TOL`` for the
  gradients), and one dropped time step must exceed it.

The ratios are printed (``pytest -s``).  Inputs are made with numpy from a
seed.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rwkv6 import rwkv6_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

MARGIN = 0.7  # the emulation's largest error over its limit, at most
BF = torch.bfloat16


def _ratio(got: torch.Tensor, want: torch.Tensor, tol: float, unit: bool = False,
           allowance=None) -> float:
    """The largest error over its per-row limit (``chip_smoke._row_ratio``)."""
    return chip_smoke._row_ratio(got, want, tol, unit, allowance)


# ------------------------------------------------------------ flash backward
# [B, Sq, Sk, H, KV, D, causal, window, q_offset]
FLASH_SHAPES = [
    (1, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 4, 1, 128, True, 0, 0),
    (1, 384, 384, 4, 2, 64, True, 128, 0),
    (1, 128, 384, 4, 2, 128, True, 0, 256),
    (1, 512, 512, 2, 2, 64, True, 0, 0),
    (1, 128, 256, 2, 2, 128, False, 0, 0),
]


def _flash_case(shape, seed):
    B, Sq, Sk, H, KV, D, causal, window, q_offset = shape
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF)

    q, k, v, dout = bf(B, Sq, H, D), bf(B, Sk, KV, D), bf(B, Sk, KV, D), bf(B, Sq, H, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    # The plain version: autograd through the plain bf16 forward.
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = torch.autograd.grad(flash_attention_plain(*xs, **kw), xs, dout)
    o = flash_attention_plain(q, k, v, **kw)
    o32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    allow = [chip_smoke._dq_allowance(k, dout, o, o32), None, None]
    return (q, k, v, dout), kw, plain, allow


def _emulate_flash_bwd(q, k, v, dout, causal, window, q_offset, drop=None):
    """The kernel's roundings (fp32 elsewhere): (dq, dk, dv) in bf16.
    ``drop``: "dq" leaves keys [64, 128) out of dQ's sums, "dkdv" queries
    [64, 128) of query head 0 out of its kv head's dK and dV sums."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    o = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, dout))
    qg = qf.reshape(B, Sq, KV, g, D)
    gg = gf.reshape(B, Sq, KV, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    pos_q, pos_k = q_offset + torch.arange(Sq), torch.arange(Sk)
    if causal:
        mask &= pos_q[:, None] >= pos_k[None, :]
    if window:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    lse = torch.logsumexp(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    delta = (gf * of).sum(-1).reshape(B, Sq, KV, g).permute(0, 2, 3, 1)[..., None]  # [B,KV,g,Sq,1]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gg, vf)
    ds = p * (dp - delta)
    p16, ds16 = p.to(BF).float(), ds.to(BF).float()
    keep_dq = torch.ones(Sk)
    keep_dkdv = torch.ones(KV, g, Sq)
    if drop == "dq":
        keep_dq[64:128] = 0
    elif drop == "dkdv":
        keep_dkdv[0, 0, 64:128] = 0
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds16 * keep_dq, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds16 * keep_dkdv[..., None], qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p16 * keep_dkdv[..., None], gg)
    return dq.reshape(B, Sq, H, D).to(BF), dk.to(BF), dv.to(BF)


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_bwd_bf16_roundings_stay_within_the_gate(shape):
    (q, k, v, dout), kw, plain, allow = _flash_case(shape, seed=sum(shape[:6]))
    got = _emulate_flash_bwd(q, k, v, dout, **kw)
    ratios = [_ratio(a, b, chip_smoke.GRAD_ROW_TOL, allowance=c)
              for a, b, c in zip(got, plain, allow)]
    dropped = [_ratio(_emulate_flash_bwd(q, k, v, dout, **kw, drop=d)[i], plain[i],
                      chip_smoke.GRAD_ROW_TOL, allowance=allow[i])
               for d, i in (("dq", 0), ("dkdv", 1), ("dkdv", 2))]
    print(f"flash bwd bf16 {shape}: dq/dk/dv error over the gate "
          f"{[round(r, 3) for r in ratios]}; a dropped tile {[round(r, 1) for r in dropped]}")
    assert max(ratios) <= MARGIN
    assert min(dropped) > 1.0


# ------------------------------------------------------------------- RWKV-6
RWKV_SHAPES = [(2, 128, 2, 16, 16), (1, 256, 2, 32, 64), (1, 192, 1, 64, 64)]  # B, T, H, N, chunk


def _rwkv_case(shape, seed):
    B, T, H, N, chunk = shape
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy((0.5 * rng.standard_normal((B, T, H, N))).astype(np.float32)).to(BF)
               for _ in range(3))
    logit = np.clip(-2.0 + 0.5 * rng.standard_normal((B, T, H, N)), -8.0, 2.0)
    logit = np.where(rng.random(logit.shape) < 0.25, rng.choice([-8.0, 2.0], logit.shape), logit)
    w = torch.from_numpy(np.exp(-np.exp(logit)).astype(np.float32)).to(BF)
    u = torch.from_numpy((0.1 * rng.standard_normal((H, N))).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((B, T, H, N)).astype(np.float32)).to(BF)
    return (r, k, v, w, u), dout, chunk


def _rwkv_f32(xs, dout, chunk):
    """The float32 computation of the output and of dr, dk, dv, dw."""
    wide = [x.float().requires_grad_(True) for x in xs]
    out, _ = rwkv6_plain(*wide, chunk=chunk)
    return (out, *torch.autograd.grad(out, wide[:4], dout.float()))


def _perturb(x: torch.Tensor, tol: float, seed: int) -> torch.Tensor:
    """x moved by up to ``tol`` x its row's largest |value|, the float32
    kernel's error against its plain version."""
    g = torch.Generator().manual_seed(seed)
    scale = x.abs().amax(-1, keepdim=True)
    return x + tol * scale * (2 * torch.rand(x.shape, generator=g) - 1)


@pytest.mark.parametrize("shape", RWKV_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_rwkv6_bf16_roundings_stay_within_the_gate(shape):
    xs, dout, chunk = _rwkv_case(shape, seed=sum(shape))
    exact = _rwkv_f32(xs, dout, chunk)
    plain = [x.to(BF) for x in exact]
    tols = [chip_smoke.TOL] + [chip_smoke.GRAD_TOL] * 4
    gates = [chip_smoke.BF16_TOL] + [chip_smoke.GRAD_ROW_TOL] * 4
    got = [_perturb(x, t, i).to(BF) for i, (x, t) in enumerate(zip(exact, tols))]
    units = [True] + [False] * 4
    ratios = [_ratio(a, b, gate, unit) for a, b, gate, unit in zip(got, plain, gates, units)]
    # A dropped time step: the step's r, k, v, w ignored (the state carried past it).
    t = shape[1] // 2
    cut = [torch.cat([x[:, :t], x[:, t + 1:]], 1) for x in xs[:4]]
    short = _rwkv_f32([*cut, xs[4]], torch.cat([dout[:, :t], dout[:, t + 1:]], 1), chunk)
    dropped = [_ratio(torch.cat([a[:, :t].to(BF), b[:, t:t + 1], a[:, t:].to(BF)], 1), b, gate,
                      unit) for a, b, gate, unit in zip(short, plain, gates, units)]
    print(f"rwkv6 bf16 {shape}: out/dr/dk/dv/dw error over the gate "
          f"{[round(r, 3) for r in ratios]}; a dropped step {[round(r, 1) for r in dropped]}")
    assert max(ratios) <= MARGIN
    assert min(dropped) > 1.0
