#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, one line each (the script stops with a non-zero exit at the first
phase that fails, and then prints no result line):

1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all at once, sm_90a);
3. kernels: hold each kernel against its plain PyTorch version on the card
   and time kernel, plain version, bound and (for attention) the
   ``scaled_dot_product_attention`` yardstick: GAE at the LM path's
   [32, 8], CartPole's [64, 8], an APPO rollout's [32, 4], [128, 4096] and
   a ragged [33, 1001]; V-trace at the IMPALA learner's
   [32, 16] and the many-lane learner's [32, 512], at [128, 4096], a ragged
   [33, 1001], trailing dims [16, 8, 2], T = 1, and with clips 2.0 / 0.5;
   the surrogate forward + autograd
   backward at [128, 151936] (the LM learner's vocabulary), CartPole's
   [256, 2], the APPO learner's [512, 2] and [65536, 18], with rows whose
   ratio is exactly 1 and rows exactly on the clip boundary; decode attention at the RLHF path's [8, 1, 20, 128] x
   W = 256 with a ragged per-lane mask, GQA 40/8 at W = 4096, an
   all-invalid row (exact zeros) and a ragged W; flash attention forward at
   the learner's [128, 256, 20, 128], the bootstrap's [256, 256, 20, 128],
   the prefill's sliding window, GQA 40/8 at S = 2048 with a 512 window and
   with a q_offset, and a ragged S; its backward at [128, 256, 20, 128],
   [4, 512, 20, 128] and GQA [2, 1024, 40/8, 128];
4. learner parity: four PPO SGD steps on one CartPole batch on the card
   (kernels) and on the CPU (plain versions) from the same weights agree to
   1e-4;
5. main path 1: PPO on CartPole through ``WorkerSet.create`` ->
   ``Algorithm.from_plan("ppo")`` -> ``ITERS`` ``train()`` iterations with
   the configuration of ``examples/ppo_cartpole.py`` (2 workers, 8 envs x 64
   steps, 1024-row train batch, 4 SGD epochs of 256-row minibatches), launch
   counters zeroed just before and read just after, checked against what
   the configuration implies;
6. LM learner parity: one ``learn_on_batch`` (SGD, lr 1) of an
   ``LMTokenPolicy`` at a reduced width (d_model 256, 4 heads, 2 KV heads,
   ctx 64, 2 layers) on the card and on the CPU from the same weights
   agrees to 1e-4;
7. main path 2: PPO on a language model (``build_ppo_lm``) at Qwen1.5-4B's
   attention and vocabulary widths cut to 2 layers, through
   ``Algorithm.from_plan("ppo_lm")``, ``RLHF_ITERS`` ``train()`` iterations
   with KV-cache rollouts; counters zeroed just before and read just after
   and checked against the configuration, the decode-vs-forward logits gap,
   peak memory, seconds per iteration and the device's idle share;
8. V-trace learner parity: one ``learn_on_batch`` (SGD, lr 1) of an IMPALA
   worker on a 512-row batch concatenated from 4 samples, on the card and
   on the CPU from the same weights, agrees to 1e-4;
9. main path 3: IMPALA (``Algorithm.from_plan("impala")``) at the
   configuration of ``examples/impala_vtrace.py`` (3 workers x 4 envs x 32
   steps, 512-row train batch, ``num_async`` 2): asynchronous rollouts, a
   learner thread and the weight-broadcast gate, ``train()`` under a
   deadline until the learner has taken ``min_steps`` steps, the learner
   thread checked alive after every iteration, one profiled window, then
   ``stop()`` and no thread of the flow left alive; launches checked
   against the learner's own step count (V-trace once per step, no GAE);
10. main path 4: APPO (``Algorithm.from_plan("appo")``), the same with PPO
   workers (surrogate forward and backward once per learner step, GAE once
   per rollout the workers ran);
11. main path 5: IMPALA with many lanes: ``VectorizedRolloutWorker``s with
   256 lanes, 2 workers x 32 steps, 16,384-row train batch.

Then one JSON line with every kernel's launches, error, times, bound and
library time (at the first case's shape, and under ``cases_by_path`` at
each main path's own shape), and last ``{"ok": true, "device": {...}}``.  Needs a CUDA
device and the repo's ``src/`` beside this file; it imports nothing of JAX
or of ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor-core fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = 1e-5  # atol = rtol for kernel vs plain version, float32
# atol = rtol for attention gradients, kernel vs autograd through the plain
# version: each dK/dV element sums Sq * g terms, each dQ element Sk terms,
# in another order.
GRAD_TOL = 1e-4
LEARNER_TOL = 1e-4  # weights after SGD steps, card vs CPU

PPO_CONFIG = dict(
    num_workers=2, num_envs=8, rollout_len=64,
    train_batch_size=1024, num_sgd_iter=4, sgd_minibatch_size=256,
)
ITERS = 8  # train() iterations on the main path

# The RLHF path: Qwen1.5-4B's attention and vocabulary widths (the port's
# copy of src/repro/configs/qwen15_4b.py), cut to 2 layers; LMTokenPolicy
# fixes d_ff = 4 * d_model and has no QKV bias.
RLHF_LAYERS = 2
RLHF_ENV = dict(ctx=256, min_prompt=64, max_prompt=192, horizon=32)
RLHF_CONFIG = dict(
    num_workers=2, num_envs=8, rollout_len=32,
    train_batch_size=512, num_sgd_iter=1, sgd_minibatch_size=128,
)
RLHF_ITERS = 3
# Reduced width of the card-vs-CPU LM learner parity phase.
LM_PARITY = dict(vocab_size=512, ctx=64, d_model=256, n_layers=2, num_heads=4, num_kv_heads=2)

# The asynchronous paths: IMPALA at examples/impala_vtrace.py's configuration,
# APPO on the same graph with PPO workers, and IMPALA's many-lane scenario
# (build_impala's vector=N lanes per shard).  ``min_steps`` is the number of
# learner-thread steps each must reach.
ASYNC_PATHS = {
    "impala": dict(plan="impala", algo="vtrace", num_workers=3, num_envs=4, rollout_len=32,
                   train_batch_size=512, num_async=2, vector=0, min_steps=16),
    "appo": dict(plan="appo", algo="ppo", num_workers=3, num_envs=4, rollout_len=32,
                 train_batch_size=512, num_async=2, vector=0, min_steps=16),
    "impala_vector": dict(plan="impala", algo="vtrace", num_workers=2, num_envs=256,
                          rollout_len=32, train_batch_size=16384, num_async=2, vector=256,
                          min_steps=8),
}
# The shape each main path gives each kernel, where phase 3 checks it.
PATH_SHAPES = {
    "gae": {"ppo_cartpole": [64, 8], "ppo_lm": [32, 8], "appo": [32, 4]},
    "vtrace": {"impala": [32, 16], "impala_vector": [32, 512]},
    "ppo_surrogate_fwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2]},
    "ppo_surrogate_bwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2]},
}
ASYNC_DEADLINE_S = 300  # per async path: a wedged flow fails its phase
ASYNC_PROFILE_S = 1.0  # the profiled window of train() calls lasts at least this


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(prof) -> dict:
    """Device microseconds by kernel name from a ``torch.profiler`` run."""
    import torch

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total
    return out


def _device_ms(fn, iters: int = 50):
    """Mean device milliseconds per call: the device time of every kernel
    the call launched (torch.profiler, CUPTI), or None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_device_kernels(prof).values())
    return total_us / iters / 1e3 if total_us > 0 else None


def _timings(kernel, plain, plain_iters: int) -> dict:
    """Kernel and plain version: device ms per call (profiler) and ms per
    call on the stream (CUDA events, host launch cost included).  ``ms`` is
    the device time where the profiler gives one, else the event time;
    ``ms_from`` and ``plain_ms_from`` say which ("profiler" or "cuda_events")."""
    t = {
        "call_ms": _time_ms(kernel),
        "plain_call_ms": _time_ms(plain, iters=plain_iters, warmup=2),
        "device_ms": _device_ms(kernel),
        "plain_device_ms": _device_ms(plain, iters=plain_iters),
    }
    for key, device, call in (("ms", "device_ms", "call_ms"),
                              ("plain_ms", "plain_device_ms", "plain_call_ms")):
        profiled = t[device] is not None
        t[key] = t[device] if profiled else t[call]
        t[key + "_from"] = "profiler" if profiled else "cuda_events"
    return t


def _bound_ms(nbytes: int, nops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(name: str, got, want, tol: float = TOL) -> float:
    import torch

    err = _max_err(got, want)
    ok = bool(torch.allclose(got, want, atol=tol, rtol=tol)) and bool(torch.isfinite(got).all())
    _require(ok, f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {err:.3e}, tol {tol})")
    return err


# ----------------------------------------------------------------- phase 1
def phase_device() -> dict:
    import torch

    _require(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(
        f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]}"
    )
    return {"nvidia_smi": line}


# ----------------------------------------------------------------- phase 2
def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    seconds = time.perf_counter() - t0
    info = build.build_info()
    usage = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    for ln in usage:
        print(f"ptxas: {ln}")
    n_src = len(list(build.CSRC_DIR.glob("*.cu")))
    print(f"build: {n_src} sources in {seconds:.2f} s -> {info['path']}")
    return {"build_s": seconds}


# ----------------------------------------------------------------- phase 3
def _gae_case(T: int, B: int, seed: int) -> dict:
    import torch

    from repro_torch.kernels.advantages import gae_cuda
    from repro_torch.rl.advantages import gae

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((T, B), generator=g, device="cuda")
    v = torch.randn((T, B), generator=g, device="cuda")
    d = (torch.rand((T, B), generator=g, device="cuda") < 0.1).float()
    last = torch.randn((B,), generator=g, device="cuda")
    adv_k, ret_k = gae_cuda(r, v, d, last, gamma=0.99, lam=0.95)
    adv_p, ret_p = gae(r, v, d, last, gamma=0.99, lam=0.95)
    torch.cuda.synchronize()
    err = max(_close(f"gae[{T},{B}] adv", adv_k, adv_p), _close(f"gae[{T},{B}] ret", ret_k, ret_p))
    nbytes = (5 * T * B + B) * 4
    bound, by = _bound_ms(nbytes, 8 * T * B)
    return {
        "shape": [T, B], "max_abs_err": err, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "library_ms": None,
        **_timings(lambda: gae_cuda(r, v, d, last), lambda: gae(r, v, d, last), plain_iters=20),
    }


def _vtrace_case(shape: tuple, seed: int, rho_clip: float = 1.0, c_clip: float = 1.0) -> dict:
    """V-trace kernel against its plain loop on time-major ``shape``: about
    10 % dones, log-ratios spread so rho lands below and above the clips,
    and every fifth element with target == behaviour log-prob exactly."""
    import torch

    from repro_torch.kernels.advantages import vtrace_cuda
    from repro_torch.rl.advantages import vtrace

    g = torch.Generator(device="cuda").manual_seed(seed)
    blp = -2.0 * torch.rand(shape, generator=g, device="cuda") - 0.05
    tlp = blp + 0.8 * torch.randn(shape, generator=g, device="cuda")
    tlp.view(-1)[::5] = blp.view(-1)[::5]
    r = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    d = (torch.rand(shape, generator=g, device="cuda") < 0.1).float()
    last = torch.randn(shape[1:], generator=g, device="cuda")
    rho = torch.exp(tlp - blp)
    _require(bool((rho < min(rho_clip, c_clip)).any()) and bool((rho > max(rho_clip, c_clip)).any()),
             f"vtrace{list(shape)}: rho does not straddle the clips")
    kw = dict(gamma=0.99, rho_clip=rho_clip, c_clip=c_clip)
    vs_k, pg_k = vtrace_cuda(blp, tlp, r, v, d, last, **kw)
    vs_p, pg_p = vtrace(blp, tlp, r, v, d, last, **kw)
    torch.cuda.synchronize()
    name = f"vtrace{list(shape)} clips {rho_clip}/{c_clip}"
    err = max(_close(f"{name} vs", vs_k, vs_p), _close(f"{name} pg_adv", pg_k, pg_p))
    T, B = shape[0], math.prod(shape[1:])
    nbytes = (5 * T * B + B) * 4 + 2 * T * B * 4  # six inputs read, two outputs written
    bound, by = _bound_ms(nbytes, 20 * T * B)
    return {
        "shape": list(shape), "rho_clip": rho_clip, "c_clip": c_clip, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "library_ms": None,
        **_timings(lambda: vtrace_cuda(blp, tlp, r, v, d, last, **kw),
                   lambda: vtrace(blp, tlp, r, v, d, last, **kw), plain_iters=20),
    }


def _surrogate_inputs(B: int, A: int, seed: int, clip_eps: float):
    """Random rows plus, at the top, rows with zero logits whose ratio is
    exactly 1 (the min() ties inside the clip band) and rows exactly on the
    hi and lo clip bounds: logits [30, 0, ...] with action 0 make logp
    exactly 0 (the exp sum rounds to 1), so the ratio is exp(-blp), and a
    searched blp pins it to the bound."""
    import torch

    from repro_torch.kernels.surrogate import ppo_surrogate_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((B, A), generator=g, device="cuda")
    actions = torch.randint(0, A, (B,), generator=g, device="cuda")
    values = torch.randn((B,), generator=g, device="cuda")
    adv = torch.randn((B,), generator=g, device="cuda")
    ret = torch.randn((B,), generator=g, device="cuda")
    n = max(B // 16, 1)
    logits[: 3 * n] = 0.0
    logits[n: 3 * n, 0] = 30.0
    actions[n: 3 * n] = 0
    logp = torch.log_softmax(logits, -1).gather(-1, actions[:, None])[:, 0]
    _require(bool((logp[n: 3 * n] == 0).all()), "boundary rows: logp is not exactly 0")
    blp = logp + 0.3 * torch.randn((B,), generator=g, device="cuda")
    blp[:n] = logp[:n]
    bounds = torch.tensor([1.0 + clip_eps, 1.0 - clip_eps], dtype=torch.float32, device="cuda")
    for k in (1, 2):
        target = bounds[k - 1]
        cand = -torch.log(target) + torch.arange(-64, 65, device="cuda") * 5e-9
        hit = torch.nonzero(torch.exp(-cand) == target)[:, 0]
        _require(hit.numel() > 0, f"no behaviour logp puts the ratio exactly on {float(target)}")
        blp[k * n: (k + 1) * n] = cand[hit[hit.numel() // 2]]
    kl = ppo_surrogate_plain(logits, values, actions, blp, adv, ret, clip_eps=clip_eps)[3]
    ratio = torch.exp(-kl)  # kl = blp - logp
    _require(bool((ratio[:n] == 1.0).all()), "ratio-1 rows are not exactly 1")
    for k in (1, 2):
        _require(bool((ratio[k * n: (k + 1) * n] == bounds[k - 1]).all()),
                 "boundary rows are not exactly on the clip bound")
    return logits, actions, values, blp, adv, ret


def _surrogate_case(B: int, A: int, seed: int, clip_eps: float = 0.2, plain_iters: int = 50) -> dict:
    import torch

    from repro_torch.kernels.surrogate import (
        ppo_surrogate_cuda,
        ppo_surrogate_plain,
        surrogate_bwd_cuda,
        surrogate_fwd_cuda,
    )

    logits, actions, values, blp, adv, ret = _surrogate_inputs(B, A, seed, clip_eps)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cots = [torch.randn((B,), generator=g, device="cuda") for _ in range(4)]

    def run(fn):
        xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
        terms = fn(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)
        grads = torch.autograd.grad(terms, xs, grad_outputs=cots)
        return [t.detach() for t in terms], grads

    terms_k, grads_k = run(ppo_surrogate_cuda)
    terms_p, grads_p = run(ppo_surrogate_plain)
    torch.cuda.synchronize()
    fwd_err = max(
        _close(f"surrogate[{B},{A}] {n}", k, p)
        for n, k, p in zip(("pg", "vf", "ent", "kl"), terms_k, terms_p)
    )
    bwd_err = max(
        _close(f"surrogate[{B},{A}] d{n}", k, p)
        for n, k, p in zip(("logits", "values", "blp", "adv", "ret"), grads_k, grads_p)
    )

    # Timing: the forward kernel alone, the backward kernel alone, and the
    # plain version's forward and its autograd backward.
    xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
    plain_terms = ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)

    def plain_fwd():
        with torch.no_grad():
            ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)

    fwd_t = _timings(
        lambda: surrogate_fwd_cuda(logits, actions, values, blp, adv, ret, clip_eps),
        plain_fwd, plain_iters=plain_iters,
    )
    bwd_t = _timings(
        lambda: surrogate_bwd_cuda(logits, actions, values, blp, adv, ret, *cots, clip_eps),
        lambda: torch.autograd.grad(plain_terms, xs, grad_outputs=cots, retain_graph=True),
        plain_iters=plain_iters,
    )

    row_in = 4 * 4 + 8  # four float [B] vectors and the int64 action
    fwd_bytes = B * (4 * A + row_in) + B * 4 * 4
    bwd_bytes = B * (4 * A + row_in + 4 * 4) + B * (4 * A + 4 * 4)
    fwd_bound = _bound_ms(fwd_bytes, B * (6 * A + 20))
    bwd_bound = _bound_ms(bwd_bytes, B * (16 * A + 40))
    shape = [B, A]
    return {
        "fwd": {"shape": shape, "max_abs_err": fwd_err, "bound_ms": fwd_bound[0],
                "bound_by": fwd_bound[1], "bytes": fwd_bytes, "library_ms": None, **fwd_t},
        "bwd": {"shape": shape, "max_abs_err": bwd_err, "bound_ms": bwd_bound[0],
                "bound_by": bwd_bound[1], "bytes": bwd_bytes, "library_ms": None, **bwd_t},
    }


def _library(fn, iters: int = 20) -> dict:
    """The PyTorch library call's device ms per call, and which SDPA backend
    it took, read from the names of the kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    total_us = sum(kernels.values())
    names = " ".join(kernels).lower()
    backend = next(
        (b for key, b in (("flash", "flash"), ("fmha", "efficient"), ("cutlass", "efficient"),
                          ("cudnn", "cudnn")) if key in names),
        "math",
    )
    top = sorted(kernels, key=lambda k: -kernels[k])[:3]
    return {
        "library_ms": total_us / iters / 1e3 if total_us > 0 else _time_ms(fn, iters=iters, warmup=2),
        "library_backend": backend,
        "library_kernels": [k[:60] for k in top],
    }


def _randn(g, *shape):
    import torch

    return torch.randn(shape, generator=g, device="cuda")


def _decode_case(B: int, H: int, KV: int, D: int, W: int, mode: str, seed: int) -> dict:
    """``mode``: "ragged" (per-lane [B, W] lengths in [1, W]), "empty_row"
    (ragged, lane 1 has no valid slot and must give exact zeros) or
    "shared" (one [W] mask)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, kc, vc = _randn(g, B, 1, H, D), _randn(g, B, W, KV, D), _randn(g, B, W, KV, D)
    pos = torch.arange(W, device="cuda")
    if mode == "shared":
        valid = pos < W - W // 7
    else:
        lens = torch.randint(1, W + 1, (B,), generator=g, device="cuda")
        valid = pos[None] < lens[:, None]
        if mode == "empty_row":
            valid[1] = False
    got = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    err = _close(f"decode_attention[{B},1,{H},{D}] W={W} {mode}", got, want)
    if mode == "empty_row":
        _require(bool((got[1] == 0).all()), "decode_attention: an all-invalid row is not exactly 0")
    n_valid = int(valid.sum()) * (B if valid.dim() == 1 else 1)
    nbytes = (2 * B * H * D + 2 * n_valid * KV * D) * 4 + valid.numel()
    bound, by = _bound_ms(nbytes, 4 * H * D * n_valid)
    mask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    out = {
        "shape": [B, 1, H, KV, D, W], "mode": mode, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        **_timings(lambda: decode_attention_cuda(q, kc, vc, valid),
                   lambda: decode_attention_plain(q, kc, vc, valid), plain_iters=20),
    }
    if mode != "empty_row":  # SDPA's softmax over an empty row is NaN
        out.update(_library(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    return out


def _visible_pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset: int):
    import torch

    q_pos = q_offset + torch.arange(Sq, device="cuda")
    k_pos = torch.arange(Sk, device="cuda")
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask, int(mask.sum())


def _sdpa(q, k, v, mask, simple_causal: bool):
    """The library yardstick: SDPA on the port's [B, S, heads, D] tensors."""
    import torch.nn.functional as F

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if simple_causal:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _flash_fwd_case(B, Sq, Sk, H, KV, D, causal, window, q_offset, seed) -> dict:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _randn(g, B, Sq, H, D), _randn(g, B, Sk, KV, D), _randn(g, B, Sk, KV, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with torch.no_grad():
        got, _ = flash_fwd_cuda(q, k, v, causal, window, q_offset)
        want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _close(f"flash_attention_fwd[{B},{Sq},{H}/{KV},{D}] Sk={Sk} {kw}", got, want)
    del want
    mask, pairs = _visible_pairs(Sq, Sk, causal, window, q_offset)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D + B * H * Sq) * 4
    bound, by = _bound_ms(nbytes, 4 * B * H * D * pairs)
    simple = causal and not window and not q_offset and Sq == Sk

    def plain():
        with torch.no_grad():
            flash_attention_plain(q, k, v, **kw)

    return {
        "shape": [B, Sq, H, KV, D], "Sk": Sk, **kw, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": 4 * B * H * D * pairs,
        **_timings(lambda: flash_fwd_cuda(q, k, v, causal, window, q_offset), plain, plain_iters=5),
        **_library(lambda: _sdpa(q, k, v, mask, simple)),
    }


def _flash_bwd_case(B, S, H, KV, D, seed) -> dict:
    """Causal backward: gradients of the kernel's autograd.Function against
    torch autograd through the plain version, and the backward launch alone
    timed against the plain version's autograd backward and SDPA's."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_bwd_cuda,
        flash_fwd_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _randn(g, B, S, H, D), _randn(g, B, S, KV, D), _randn(g, B, S, KV, D)
    dout = _randn(g, B, S, H, D)

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs, causal=True)
        return torch.autograd.grad(out, xs, dout, retain_graph=True), (out, xs)

    got, _ = grads(flash_attention_cuda)
    again, _ = grads(flash_attention_cuda)
    want, (plain_out, plain_xs) = grads(flash_attention_plain)
    torch.cuda.synchronize()
    err = max(_close(f"flash_attention_bwd[{B},{S},{H}/{KV},{D}] d{n}", a, b, GRAD_TOL)
              for n, a, b in zip("qkv", got, want))
    _require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             "flash_attention_bwd: gradients differ between two runs")
    del got, again, want
    o, lse = flash_fwd_cuda(q, k, v, True, 0, 0)
    _, pairs = _visible_pairs(S, S, True, 0, 0)
    # reads q, o, dO, lse, k, v; writes dq, dk, dv
    nbytes = (3 * B * S * H * D + 2 * B * S * KV * D + B * H * S) * 4 + (B * S * H * D + 2 * B * S * KV * D) * 4
    bound, by = _bound_ms(nbytes, 10 * B * H * D * pairs)
    lib_xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = _sdpa(*lib_xs, None, True)
    return {
        "shape": [B, S, H, KV, D], "causal": True, "max_abs_err": err, "deterministic": True,
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": 10 * B * H * D * pairs,
        **_timings(
            lambda: flash_bwd_cuda(q, k, v, o, lse, dout, True, 0, 0),
            lambda: torch.autograd.grad(plain_out, plain_xs, dout, retain_graph=True),
            plain_iters=5,
        ),
        **_library(lambda: torch.autograd.grad(lib_out, lib_xs, dout.transpose(1, 2), retain_graph=True)),
    }


def phase_kernels() -> dict:
    """Every kernel at its main paths' shapes and at large ones; the first
    case of each kernel is its path's shape (the RLHF path's, and the IMPALA
    learner's for V-trace)."""
    gae_cases = [_gae_case(32, 8, 5), _gae_case(64, 8, 0), _gae_case(32, 4, 7),
                 _gae_case(128, 4096, 1), _gae_case(33, 1001, 2)]
    vtrace_cases = [_vtrace_case((32, 16), 40), _vtrace_case((32, 512), 41),
                    _vtrace_case((128, 4096), 42), _vtrace_case((33, 1001), 43),
                    _vtrace_case((16, 8, 2), 44), _vtrace_case((1, 64), 45),
                    _vtrace_case((32, 512), 46, rho_clip=2.0, c_clip=0.5)]
    sur_cases = [_surrogate_case(128, 151936, 6, plain_iters=10), _surrogate_case(256, 2, 3),
                 _surrogate_case(512, 2, 8), _surrogate_case(65536, 18, 4)]
    d = RLHF_ENV["ctx"]
    out = {
        "gae": gae_cases,
        "vtrace": vtrace_cases,
        "ppo_surrogate_fwd": [c["fwd"] for c in sur_cases],
        "ppo_surrogate_bwd": [c["bwd"] for c in sur_cases],
        "decode_attention": [
            _decode_case(8, 20, 20, 128, d, "ragged", 10),
            _decode_case(8, 40, 8, 128, 4096, "ragged", 11),
            _decode_case(4, 20, 20, 128, d, "empty_row", 12),
            _decode_case(8, 40, 8, 128, 1000, "shared", 13),
        ],
        "flash_attention_fwd": [
            _flash_fwd_case(128, d, d, 20, 20, 128, True, 0, 0, 20),   # learner
            _flash_fwd_case(256, d, d, 20, 20, 128, True, 0, 0, 21),   # GAE bootstrap
            _flash_fwd_case(8, d, d, 20, 20, 128, True, d, 0, 22),     # prefill (window = ctx)
            _flash_fwd_case(2, 2048, 2048, 40, 8, 128, True, 512, 0, 23),
            _flash_fwd_case(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 24),
            _flash_fwd_case(2, 1000, 1000, 40, 8, 128, True, 0, 0, 25),
        ],
        "flash_attention_bwd": [
            _flash_bwd_case(128, d, 20, 20, 128, 30),  # learner
            _flash_bwd_case(4, 512, 20, 20, 128, 31),
            _flash_bwd_case(2, 1024, 40, 8, 128, 32),
        ],
    }
    for name, cases in out.items():
        tol = GRAD_TOL if name == "flash_attention_bwd" else TOL
        for c in cases:
            lib = c.get("library_ms")
            lib_txt = f" library_ms={lib} ({c.get('library_backend')})" if lib is not None else ""
            print(
                f"kernel {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} (tol {tol}) "
                f"device_ms={c['device_ms']} call_ms={c['call_ms']:.5f} "
                f"plain_device_ms={c['plain_device_ms']} plain_call_ms={c['plain_call_ms']:.5f} "
                f"bound_ms={c['bound_ms']:.6f} ({c['bound_by']}){lib_txt}"
            )
    return out


# ----------------------------------------------------------------- phase 4
def _make_worker(index: int, device: str):
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    return RolloutWorker(
        CartPole(),
        ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind="ppo", ent_coef=0.0),
        algo="ppo", num_envs=PPO_CONFIG["num_envs"], rollout_len=PPO_CONFIG["rollout_len"],
        seed=0, worker_index=index, device=device,
    )


def phase_learner_parity() -> dict:
    import numpy as np

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_to_numpy
    from repro_torch.rl import SampleBatch
    from repro_torch.tree import tree_leaves

    gpu, cpu = _make_worker(0, "cuda"), _make_worker(0, "cpu")
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = SampleBatch.concat_samples([gpu.sample(), gpu.sample()])
    batch = StandardizeFields(["advantages"])(batch)
    rng = np.random.default_rng(0)
    mbs = list(batch.minibatches(PPO_CONFIG["sgd_minibatch_size"], rng))
    for mb in mbs:
        info_g, info_c = gpu.learn_on_batch(mb), cpu.learn_on_batch(mb)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    _require(err <= LEARNER_TOL, f"learner parity: card vs CPU weights differ by {err:.3e}")
    loss_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(loss_err <= LEARNER_TOL, f"learner parity: stats differ by {loss_err:.3e}")
    print(f"learner parity: {len(mbs)} SGD steps on {batch.count} rows, card vs CPU "
          f"max weight err {err:.3e}, max stat err {loss_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": loss_err}


# ----------------------------------------------------------------- phase 5
RESULT_KEYS = {"counters", "episodes", "gauges", "info", "latencies", "time_total_s", "timers"}
INFO_KEYS = {"loss", "pg_loss", "vf_loss", "entropy", "kl"}


def phase_main_path(counters: list) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg, iters = PPO_CONFIG, ITERS
    workers = WorkerSet.create(lambda i: _make_worker(i, "cuda"), cfg["num_workers"])
    rows = []
    with Algorithm.from_plan(
        "ppo", workers, train_batch_size=cfg["train_batch_size"],
        num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["sgd_minibatch_size"],
    ) as algo:
        for c in counters:
            c.reset()
        t_all = time.perf_counter()
        for i in range(iters):
            prof = None
            if i == iters - 1:  # the last iteration runs under the profiler
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.start()
            t0 = time.perf_counter()
            result = algo.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
                busy = _device_kernels(prof)
            info, ctr = result["info"], result["counters"]
            reward = result["episodes"]["episode_reward_mean"]
            rows.append({"iter": i, "seconds": dt, "reward": reward, "loss": info["loss"]})
            print(
                f"train {i}: steps_sampled={ctr['num_steps_sampled']} "
                f"steps_trained={ctr['num_steps_trained']} reward_mean={reward:.2f} "
                f"loss={info['loss']:.4f} kl={info['kl']:.5f} {dt:.3f} s "
                + " ".join(f"{c.name}={c.value}" for c in counters)
            )
            _require(set(result) == RESULT_KEYS, f"result keys {sorted(result)}")
            _require(set(info) == INFO_KEYS, f"info keys {sorted(info)}")
            _require(all(math.isfinite(info[k]) for k in INFO_KEYS), f"non-finite stats {info}")
        total = time.perf_counter() - t_all
        launches = {c.name: c.value for c in counters}
    busy_ms = sum(busy.values()) / 1e3
    ours = {k: v / 1e3 for k, v in busy.items() if "gae_kernel" in k or "surrogate_" in k}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    # The profiled iteration runs slower than the others (tracing cost), so
    # the idle share is given against both its own wall time and the mean
    # of the unprofiled iterations after the first (warm-up) one.
    warm_ms = 1e3 * sum(r["seconds"] for r in rows[1:-1]) / max(len(rows) - 2, 1)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3),
        "idle_share_vs_unprofiled": 1.0 - busy_ms / warm_ms,
        "port_kernels_ms": ours,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(
        f"profile train {iters - 1}: wall {dt * 1e3:.1f} ms (unprofiled mean {warm_ms:.1f} ms), "
        f"device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
        f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled), port kernels {ours}"
    )
    steps = iters * cfg["train_batch_size"]
    _require(ctr["num_steps_sampled"] == steps and ctr["num_steps_trained"] == steps,
             f"counters {ctr} after {iters} iterations")
    samples_per_iter = cfg["train_batch_size"] // (cfg["num_envs"] * cfg["rollout_len"])
    sgd_steps = cfg["num_sgd_iter"] * (cfg["train_batch_size"] // cfg["sgd_minibatch_size"])
    expect = {
        "gae": iters * samples_per_iter,
        "ppo_surrogate_fwd": iters * sgd_steps,
        "ppo_surrogate_bwd": iters * sgd_steps,
    }
    _require(launches == expect, f"launches {launches}, expected {expect}")
    print(f"main path: {iters} train() iterations in {total:.3f} s, launches {launches}")
    return {"iterations": rows, "seconds": total, "launches": launches, "profile": profiled}


# ----------------------------------------------------------------- phase 6
def _lm_parity_worker(device: str):
    """The parity phase's worker.  It learns with SGD at lr 1, so the weight
    difference after one step is the gradient difference.  Adam's first
    step is lr * sign(g) wherever |g| >> eps, so any of the ~1M gradients
    whose true value lies within rounding of zero moves by 2 * lr apart on
    the two devices whatever the kernels do."""
    from repro_torch.optim import sgd
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    c = LM_PARITY
    env = TokenEnv(vocab_size=c["vocab_size"], ctx=c["ctx"], min_prompt=8, max_prompt=32, horizon=32)
    policy = LMTokenPolicy(ctx=c["ctx"], vocab_size=c["vocab_size"], d_model=c["d_model"],
                           n_layers=c["n_layers"], num_heads=c["num_heads"],
                           num_kv_heads=c["num_kv_heads"])
    return VectorizedRolloutWorker(env, policy, algo="ppo", num_envs=8, rollout_len=32,
                                   decode="cache", seed=0, optimizer=sgd(1.0), device=device)


def phase_lm_learner_parity() -> dict:
    import numpy as np

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_to_numpy
    from repro_torch.tree import tree_leaves

    gpu, cpu = _lm_parity_worker("cuda"), _lm_parity_worker("cpu")
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = StandardizeFields(["advantages"])(gpu.sample())
    info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(err <= LEARNER_TOL, f"LM learner parity: card vs CPU weights differ by {err:.3e}")
    _require(stat_err <= LEARNER_TOL, f"LM learner parity: stats differ by {stat_err:.3e}")
    print(f"LM learner parity: one learn_on_batch on {batch.count} rows at {LM_PARITY}, card vs "
          f"CPU max weight err {err:.3e}, max stat err {stat_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": stat_err, "config": dict(LM_PARITY)}


# ----------------------------------------------------------------- phase 7
def _rlhf_worker(index: int):
    from repro_torch.configs.qwen15_4b import CONFIG as QWEN
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    env = TokenEnv(vocab_size=QWEN.vocab_size, **RLHF_ENV)
    policy = LMTokenPolicy(
        ctx=RLHF_ENV["ctx"], vocab_size=QWEN.vocab_size, d_model=QWEN.d_model,
        n_layers=RLHF_LAYERS, num_heads=QWEN.num_heads, num_kv_heads=QWEN.num_kv_heads,
    )
    return VectorizedRolloutWorker(
        env, policy, algo="ppo", num_envs=RLHF_CONFIG["num_envs"],
        rollout_len=RLHF_CONFIG["rollout_len"], decode="cache", seed=0, worker_index=index,
        device="cuda",
    )


def _rlhf_expected_launches() -> dict:
    """Launches per train() iteration implied by the RLHF configuration: with
    the sync TokenEnv every lane resets together, so a rollout prefills once
    per episode and decodes every other step; the GAE bootstrap runs one
    forward per sample and the learner one forward and one backward per SGD
    minibatch, each through every layer."""
    c, L = RLHF_CONFIG, RLHF_LAYERS
    _require(c["rollout_len"] % RLHF_ENV["horizon"] == 0, "rollout_len must be a multiple of horizon")
    samples = c["train_batch_size"] // (c["num_envs"] * c["rollout_len"])
    prefills = c["rollout_len"] // RLHF_ENV["horizon"]
    decodes = c["rollout_len"] - prefills
    sgd_steps = c["num_sgd_iter"] * (c["train_batch_size"] // c["sgd_minibatch_size"])
    return {
        "gae": samples,
        "ppo_surrogate_fwd": sgd_steps,
        "ppo_surrogate_bwd": sgd_steps,
        "decode_attention": samples * decodes * L,
        "flash_attention_fwd": samples * (prefills + 1) * L + sgd_steps * L,
        "flash_attention_bwd": sgd_steps * L,
    }


def _split_times(worker) -> dict:
    """Seconds of one rollout (decode loop), its GAE bootstrap forward and
    one learner SGD step on ``worker``, each ended by a synchronize."""
    import torch

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.rl.rollout_worker import assemble_fragments

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cols, t_roll = timed(worker._vrollout)
    cols, t_boot = timed(lambda: worker._postprocess_cols(worker.params, cols))
    cols.pop("completed")
    batch = StandardizeFields(["advantages"])(assemble_fragments(cols, worker._lane_base))
    mb = batch.slice(0, RLHF_CONFIG["sgd_minibatch_size"])
    _, t_learn = timed(lambda: worker.learn_on_batch(mb))
    return {"rollout_s": t_roll, "bootstrap_s": t_boot, "sgd_step_s": t_learn}


def phase_rlhf(counters: list) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.launch.rlhf import parity_gap

    cfg, iters = RLHF_CONFIG, RLHF_ITERS
    per_iter = _rlhf_expected_launches()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    workers = WorkerSet.create(_rlhf_worker, cfg["num_workers"])
    init_s = time.perf_counter() - t_init
    rows = []
    try:
        with Algorithm.from_plan(
            "ppo_lm", workers, train_batch_size=cfg["train_batch_size"],
            num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["sgd_minibatch_size"],
        ) as algo:
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            for i in range(iters):
                prof = None
                if i == iters - 1:  # the last iteration runs under the profiler
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.start()
                before = {c.name: c.value for c in counters}
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    prof.stop()
                    busy = _device_kernels(prof)
                launched = {c.name: c.value - before[c.name] for c in counters}
                info, ctr = result["info"], result["counters"]
                rows.append({"iter": i, "seconds": dt, "loss": info["loss"], "launches": launched,
                             "reward": result["episodes"]["episode_reward_mean"]})
                print(
                    f"rlhf train {i}: steps_sampled={ctr['num_steps_sampled']} "
                    f"steps_trained={ctr['num_steps_trained']} loss={info['loss']:.4f} "
                    f"kl={info['kl']:.5f} entropy={info['entropy']:.4f} "
                    f"reward_mean={result['episodes']['episode_reward_mean']:.4f} {dt:.3f} s "
                    + " ".join(f"{k}={v}" for k, v in launched.items())
                )
                _require(set(result) == RESULT_KEYS, f"result keys {sorted(result)}")
                _require(set(info) == INFO_KEYS, f"info keys {sorted(info)}")
                _require(all(math.isfinite(info[k]) for k in INFO_KEYS), f"non-finite stats {info}")
                steps = (i + 1) * cfg["train_batch_size"]
                _require(ctr["num_steps_sampled"] == steps and ctr["num_steps_trained"] == steps,
                         f"counters {ctr} after {i + 1} iterations")
                _require(launched == per_iter,
                         f"iteration {i} launched {launched}, expected {per_iter}")
            total = time.perf_counter() - t_all
            launches = {c.name: c.value for c in counters}
            peak = torch.cuda.max_memory_allocated()
            lw = workers.local_worker()
            gap = parity_gap(lw)
            with torch.no_grad():
                logits, _ = lw.policy.logits_value(lw.params, lw.vstate.obs)
            scale = float(logits.abs().max())
            print(f"rlhf parity: decode-vs-forward max |logits gap| {gap:.3e}, max |forward "
                  f"logits| {scale:.3e}, limit {1e-4 * scale:.3e}")
            _require(gap <= 1e-4 * scale, f"decode-vs-forward gap {gap:.3e} > 1e-4 * {scale:.3e}")
            split = _split_times(lw)
    finally:
        workers.stop()
    busy_ms = sum(busy.values()) / 1e3
    names = ("decode_attention", "flash_fwd", "flash_bwd", "surrogate_", "gae_kernel")
    ours = {k[:60]: v / 1e3 for k, v in busy.items() if any(n in k for n in names)}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    warm_ms = 1e3 * sum(r["seconds"] for r in rows[1:-1]) / max(len(rows) - 2, 1)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3),
        "idle_share_vs_unprofiled": 1.0 - busy_ms / warm_ms,
        "port_kernels_ms": ours,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(
        f"rlhf profile train {iters - 1}: wall {dt * 1e3:.1f} ms (unprofiled {warm_ms:.1f} ms), "
        f"device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
        f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled); peak memory "
        f"{peak / 2**30:.2f} GiB; worker init {init_s:.2f} s; split {split}"
    )
    print(f"rlhf top device kernels (ms): {profiled['top_kernels_ms']}")
    print(f"rlhf main path: {iters} train() iterations in {total:.3f} s, launches {launches}")
    return {"iterations": rows, "seconds": total, "launches": launches, "profile": profiled,
            "expected_per_iter": per_iter, "peak_memory_bytes": peak, "init_s": init_s,
            "parity_gap": gap, "max_abs_logit": scale, "split": split}


# ----------------------------------------------------------------- phase 8
def _async_worker(index: int, device: str, cfg: dict, optimizer=None):
    """A CartPole worker of an async path: the example's 64x64 actor-critic
    with the V-trace loss (IMPALA) or the PPO loss (APPO)."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker, VectorizedRolloutWorker

    loss_kind = "vtrace" if cfg["algo"] == "vtrace" else "ppo"
    policy = ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind=loss_kind, ent_coef=0.01,
                               rollout_len=cfg["rollout_len"])
    cls = VectorizedRolloutWorker if cfg["vector"] else RolloutWorker
    kw = {"optimizer": optimizer} if optimizer is not None else {}
    return cls(CartPole(), policy, algo=cfg["algo"], num_envs=cfg["num_envs"],
               rollout_len=cfg["rollout_len"], seed=0, worker_index=index, device=device, **kw)


def phase_vtrace_learner_parity() -> dict:
    """One IMPALA learner step on the card (V-trace kernel) and on the CPU
    (plain loop) from the same weights, with SGD at lr 1 so the weight
    difference is the gradient difference (see phase 6)."""
    import numpy as np

    from repro_torch.interop import params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.rl import SampleBatch
    from repro_torch.tree import tree_leaves

    cfg = ASYNC_PATHS["impala"]
    gpu = _async_worker(0, "cuda", cfg, optimizer=sgd(1.0))
    cpu = _async_worker(0, "cpu", cfg, optimizer=sgd(1.0))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = SampleBatch.concat_samples([gpu.sample() for _ in range(4)])
    _require(batch.count == cfg["train_batch_size"], f"parity batch has {batch.count} rows")
    info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(err <= LEARNER_TOL, f"V-trace learner parity: card vs CPU weights differ by {err:.3e}")
    _require(stat_err <= LEARNER_TOL, f"V-trace learner parity: stats differ by {stat_err:.3e}")
    print(f"V-trace learner parity: one learn_on_batch (SGD, lr 1) on {batch.count} rows, card "
          f"vs CPU max weight err {err:.3e}, max stat err {stat_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": stat_err, "rows": batch.count}


# ------------------------------------------------------------ phases 9-11
class _Rollouts:
    """Count and host seconds of the rollouts (``sample()`` calls) the
    workers of one path ran, across their actor threads."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def wrap(self, worker):
        sample = worker.sample

        def counted():
            t0 = time.perf_counter()
            out = sample()  # ends in a device-to-host copy
            with self._lock:
                self.count += 1
                self.seconds += time.perf_counter() - t0
            return out

        worker.sample = counted
        return worker


@contextlib.contextmanager
def _deadline(seconds: int, what: str):
    """Raise PhaseError in the main thread when ``seconds`` pass."""

    def expired(signum, frame):
        raise PhaseError(f"{what}: not done within its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def phase_async(name: str, counters: list) -> dict:
    """One asynchronous main path: ``train()`` until the learner thread has
    taken ``min_steps`` steps, then a profiled window, then ``stop()``.
    Launches are read after ``stop()`` has joined every thread of the flow
    and checked against the learner's and the workers' own counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg = ASYNC_PATHS[name]
    rollouts = _Rollouts()
    thread_errors: dict = {}
    hook = threading.excepthook

    def record(args):
        thread_errors[args.thread.name] = repr(args.exc_value)
        hook(args)

    threads_before = set(threading.enumerate())
    threading.excepthook = record
    t_init = time.perf_counter()
    workers = WorkerSet.create(lambda i: rollouts.wrap(_async_worker(i, "cuda", cfg)),
                               cfg["num_workers"])
    plan_kw = dict(train_batch_size=cfg["train_batch_size"], num_async=cfg["num_async"])
    if cfg["vector"]:
        plan_kw["vector"] = cfg["vector"]
    algo = Algorithm.from_plan(cfg["plan"], workers, **plan_kw)
    init_s = time.perf_counter() - t_init
    learner = algo.resources["learner"]
    info_keys = INFO_KEYS if cfg["algo"] == "ppo" else INFO_KEYS - {"kl"}
    rows = []

    def train_once(i: int) -> dict:
        t0 = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _require(learner.is_alive(), f"{name}: the learner thread died after iteration {i}: "
                                     f"{thread_errors.get(learner.name, 'no exception recorded')}")
        _require(set(result) == RESULT_KEYS, f"{name}: result keys {sorted(result)}")
        info, ctr = result["info"], result["counters"]
        if info:  # empty until the first learner result reaches the driver
            _require(set(info) == info_keys, f"{name}: info keys {sorted(info)}")
            _require(all(math.isfinite(info[k]) for k in info), f"{name}: non-finite stats {info}")
        reward = result["episodes"]["episode_reward_mean"]
        rows.append({"iter": i, "seconds": dt, "reward": reward, "loss": info.get("loss"),
                     "steps_sampled": ctr.get("num_steps_sampled", 0),
                     "steps_trained": ctr.get("num_steps_trained", 0),
                     "learner_steps": learner.num_steps})
        print(f"{name} train {i}: steps_sampled={rows[-1]['steps_sampled']} "
              f"steps_trained={rows[-1]['steps_trained']} learner_steps={learner.num_steps} "
              f"reward_mean={reward:.2f} loss={info.get('loss')} {dt:.3f} s "
              + " ".join(f"{c.name}={c.value}" for c in counters))
        return result

    def snapshot() -> dict:
        return {"t": time.perf_counter(), "learn_s": learner.learn_timer.total,
                "learn_n": learner.learn_timer.count, "roll_s": rollouts.seconds,
                "roll_n": rollouts.count, "trained": rows[-1]["steps_trained"] if rows else 0}

    try:
        with _deadline(ASYNC_DEADLINE_S, name):
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            result = train_once(0)
            warm = snapshot()  # the first iteration starts every thread: warm-up
            while learner.num_steps < cfg["min_steps"] or len(rows) < 3:
                result = train_once(len(rows))
            steady = snapshot()
            total = steady["t"] - t_all
            # The profiled window: whole train() calls lasting at least
            # ASYNC_PROFILE_S, so the learner and rollout threads' kernels
            # launched meanwhile are in it.
            steps0, trained0 = learner.num_steps, rows[-1]["steps_trained"]
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            t_prof = time.perf_counter()
            while time.perf_counter() - t_prof < ASYNC_PROFILE_S:
                result = train_once(len(rows))
            window = time.perf_counter() - t_prof
            window_steps = learner.num_steps - steps0
            window_trained = rows[-1]["steps_trained"] - trained0
            prof.stop()
            busy = _device_kernels(prof)
            _require(rows[-1]["steps_trained"] > 0, f"{name}: nothing trained")
    finally:
        algo.stop()
        threading.excepthook = hook
    _require(not learner.is_alive(), f"{name}: the learner thread is alive after stop()")
    # Dummy threads are the Python faces of native threads (the autograd
    # engine's device threads run the surrogate backward): not the flow's.
    left = [t.name for t in threading.enumerate() if t not in threads_before and t.is_alive()
            and not isinstance(t, threading._DummyThread)]
    _require(not left, f"{name}: threads of the flow alive after stop(): {left}")

    launches = {c.name: c.value for c in counters}
    steps = learner.num_steps
    received = rows[-1]["steps_sampled"] // (cfg["num_envs"] * cfg["rollout_len"])
    if cfg["algo"] == "vtrace":
        expect = {"gae": 0, "vtrace": steps, "ppo_surrogate_fwd": 0, "ppo_surrogate_bwd": 0}
    else:
        expect = {"gae": rollouts.count, "vtrace": 0,
                  "ppo_surrogate_fwd": steps, "ppo_surrogate_bwd": steps}
    _require(launches == expect, f"{name}: launches {launches}, expected {expect} "
                                 f"(learner steps {steps}, rollouts run {rollouts.count})")
    _require(rollouts.count >= received, f"{name}: {received} rollouts received but "
                                         f"{rollouts.count} run")
    busy_ms = sum(busy.values()) / 1e3
    ours = {k[:60]: v / 1e3 for k, v in busy.items()
            if any(n in k for n in ("vtrace_kernel", "gae_kernel", "surrogate_"))}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    iters = [r["seconds"] for r in rows]
    profiled = {
        "window_s": window, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (window * 1e3),
        "learner_steps": window_steps, "steps_trained": window_trained,
        "port_kernels_ms": ours, "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    # Where the time goes, over the unprofiled iterations after the first:
    # the learner thread's learn_on_batch time and the rollout threads'
    # sample time, each against the wall time of that stretch.
    d = {k: steady[k] - warm[k] for k in warm}
    split = {
        "wall_s": d["t"], "steps_trained_per_s": d["trained"] / d["t"],
        # The learner's own rate: the driver drains results behind it.
        "learner_rows_per_s": d["learn_n"] * cfg["train_batch_size"] / d["t"],
        "learner_steps": d["learn_n"], "learner_s": d["learn_s"],
        "learn_step_mean_s": d["learn_s"] / max(d["learn_n"], 1),
        "learner_busy_share": d["learn_s"] / d["t"], "rollouts": d["roll_n"],
        "rollout_s": d["roll_s"], "rollout_mean_s": d["roll_s"] / max(d["roll_n"], 1),
        "rollout_busy_share_per_worker": d["roll_s"] / cfg["num_workers"] / d["t"],
        "latencies": result["latencies"],
    }
    print(f"{name} profile: window {window:.3f} s, device busy {busy_ms:.2f} ms, idle share "
          f"{profiled['idle_share']:.4f}, {window_steps} learner steps, {window_trained} steps "
          f"trained; port kernels {ours}")
    print(f"{name} top device kernels (ms): {profiled['top_kernels_ms']}")
    print(f"{name} split: {json.dumps(split)}")
    print(f"{name} main path: {len(rows)} train() iterations in {total:.3f} s (mean "
          f"{sum(iters) / len(iters):.4f} s, init {init_s:.2f} s), learner steps {steps}, "
          f"rollouts run {rollouts.count} (received {received}), "
          f"after the first iteration {split['learner_rows_per_s']:.1f} rows learned/s "
          f"(learner) and {split['steps_trained_per_s']:.1f} steps trained/s (driver), "
          f"launches {launches}; no flow thread alive after stop()")
    return {"config": dict(cfg), "iterations": rows, "seconds": total, "init_s": init_s,
            "launches": launches, "learner_steps": steps, "rollouts_run": rollouts.count,
            "rollouts_received": received, "profile": profiled, "split": split}


# ------------------------------------------------------------------- main
KERNEL_SITES = {
    "gae": ("src/repro_torch/kernels/csrc/gae.cu", "src/repro/kernels/advantages.py:59"),
    "vtrace": ("src/repro_torch/kernels/csrc/vtrace.cu", "src/repro/kernels/advantages.py:72"),
    "ppo_surrogate_fwd": ("src/repro_torch/kernels/csrc/surrogate.cu",
                          "src/repro/kernels/surrogate.py:58"),
    "ppo_surrogate_bwd": ("src/repro_torch/kernels/csrc/surrogate.cu",
                          "src/repro/kernels/surrogate.py:85"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:29"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:30"),
    # The TPU kernel has no backward: the reference learner differentiates
    # its oracle, jax.grad through ref.chunked_attention.
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/ref.py:58"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write every measurement here as JSON")
    args = ap.parse_args()
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.advantages import GAE_LAUNCHES, VTRACE_LAUNCHES
    from repro_torch.kernels.decode_attention import DECODE_ATTENTION_LAUNCHES
    from repro_torch.kernels.flash_attention import FLASH_BWD_LAUNCHES, FLASH_FWD_LAUNCHES
    from repro_torch.kernels.surrogate import SURROGATE_BWD_LAUNCHES, SURROGATE_FWD_LAUNCHES

    record: dict = {}
    try:
        record["device"] = phase_device()
        record["build"] = phase_build()
        record["kernels"] = phase_kernels()
        record["learner_parity"] = phase_learner_parity()
        record["main_path"] = phase_main_path(
            [GAE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES]
        )
        record["lm_learner_parity"] = phase_lm_learner_parity()
        record["rlhf"] = phase_rlhf(
            [GAE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES,
             DECODE_ATTENTION_LAUNCHES, FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES]
        )
        record["vtrace_learner_parity"] = phase_vtrace_learner_parity()
        for name in ASYNC_PATHS:
            record[name] = phase_async(
                name, [GAE_LAUNCHES, VTRACE_LAUNCHES, SURROGATE_FWD_LAUNCHES,
                       SURROGATE_BWD_LAUNCHES]
            )
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    kernels = []
    paths = {"ppo_cartpole": record["main_path"]["launches"], "ppo_lm": record["rlhf"]["launches"],
             **{name: record[name]["launches"] for name in ASYNC_PATHS}}
    for name, (source, replaces) in KERNEL_SITES.items():
        path_case = record["kernels"][name][0]  # the path's shape comes first
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        cases_by_path = {}
        for p, shape in PATH_SHAPES.get(name, {}).items():
            c = next(c for c in record["kernels"][name] if c["shape"] == shape)
            cases_by_path[p] = {k: c[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "call_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in record["kernels"][name]),
            "ms": path_case["ms"], "plain_ms": path_case["plain_ms"],
            "ms_from": path_case["ms_from"], "plain_ms_from": path_case["plain_ms_from"],
            "bound_ms": path_case["bound_ms"], "bound_by": path_case["bound_by"],
            "library_ms": path_case["library_ms"],
            "library_backend": path_case.get("library_backend"), "shape": path_case["shape"],
            "call_ms": path_case["call_ms"], "plain_call_ms": path_case["plain_call_ms"],
            "cases_by_path": cases_by_path,
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
