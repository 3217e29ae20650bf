#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, one line each (the script stops with a non-zero exit at the first
phase that fails, and then prints no result line):

1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all at once, sm_90a); each tensor-core kernel's (flash attention's
   and the grouped matmul's) registers, spills, shared memory and resident
   blocks per SM, and its count of TF32 tensor-core instructions in the SASS
   (``cuobjdump``; none fails the phase);
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
   with a q_offset, a ragged S, and Phi-3.5-MoE's [2, 4096, 32/8, 128]; its
   backward at [128, 256, 20, 128], [4, 512, 20, 128], GQA [2, 1024, 40/8,
   128], Phi's [2, 4096, 32/8, 128], GQA 40/8 at S = 2048 with a 512 window
   and with a q_offset; both at D = 64 and D = 32 (GQA with a ragged S, a
   non-causal case with Sq != Sk, a window with a q_offset), each with the
   3xTF32 bound and the fp32 CUDA-core bound beside it; the RWKV-6
   recurrence forward and backward (gradients of r, k, v, w, u and the start state against autograd
   through the plain loop, and bitwise equal across two runs) at the
   pretraining path's [2, 4096, 64, 64], a ragged T = 1000, with a start
   state, and at narrow [4, 256, 8, 32] heads; the MoE grouped matmul and
   the dX and dW products of its backward (dW bitwise equal across two runs)
   at the path's two products ([20480, 4096] x [16, 4096, 6400] and
   [20480, 6400] x [16, 6400, 4096], beside ``torch.bmm`` and the einsums of
   ``GmmMatmul``'s backward they replace), ragged unequal groups (an empty
   one, groups summing past x's rows, rows past the last group), and a group
   that is not a multiple of 64, each with the 3xTF32 and the fp32 bound;
   each time of the Phi-3.5-MoE path's grouped-matmul and flash-backward
   cases read by both clocks before and after the profiler, with the card's
   SM clock, power and temperature beside them;
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
   256 lanes, 2 workers x 32 steps, 16,384-row train batch;
12. pretraining learner parity: one ``learn_on_batch`` (SGD, lr 1) of the
   LM pretraining learner at the reduced configuration of RWKV-6 and of
   Phi-3.5-MoE (float32), on the card and on the CPU from the same weights,
   agrees to 1e-4, after checking that every token routes to the same
   experts on both devices;
13. main path 6: LM pretraining (``launch/train.py``: ``make_pretrain`` ->
   ``build_lm_flow`` -> ``Algorithm.from_plan``) of RWKV-6 7B at its
   published widths cut to 2 layers, 4 ``train()`` steps of 2 x 4,096
   tokens under a deadline, launches read per step and checked against the
   configuration (every other kernel 0), losses finite and within 0.5 of
   ln V + sigma^2 / 2 (uniform tokens under the initial logits), peak
   memory, seconds per step, tokens per second and the idle share of the
   profiled last step;
14. main path 7: the same for Phi-3.5-MoE 42B (16 experts, top-2) cut to 2
   layers.

Then one JSON line with every kernel's launches, error, times, bound and
library time (at the first case's shape, and under ``cases_by_path`` at
each main path's own shape; ``ms``, ``plain_ms`` and ``library_ms`` are device
time by the profiler unless their ``*_from`` key says ``cuda_events``, the
``*call_ms`` beside them CUDA events per call on the stream), and last
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the repo's
``src/`` beside this file; it imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, non-tensor-core fp32,
# and TF32 on the tensor cores (dense).  The flash kernels run 3xTF32: three
# tensor-core products for each fp32 product.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
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
# The LM pretraining paths (launch/train.py): each configuration at its
# published widths cut to 2 layers, 4,096 tokens per sequence (the repo's
# train_4k length) and a global batch of 2 (from 256) in 2 data shards.
PRETRAIN = dict(seq=4096, batch=2, data_shards=2, steps=4, layers=2)
PRETRAIN_PATHS = {"pretrain_rwkv6": "rwkv6-7b", "pretrain_phi": "phi3.5-moe-42b-a6.6b"}
PRETRAIN_DEADLINE_S = 420  # per path, model init included
# The shapes those paths give their kernels (the path phases check them
# against the configurations): RWKV-6's r, k, v, w [B, T, H, N]; Phi's
# grouped matmul [E * B * C, D] x [E, D, F], C = ceil(1.25 * T * top_k / E)
# = 640 slots per expert and row; Phi's attention [B, S, H, KV, D].
RWKV6_PATH_SHAPE = (2, 4096, 64, 64)
MOE_GMM_UP = (20480, 4096, 6400, 16)  # [T, D, F, E] of the up and gate products
PHI_ATTENTION = (2, 4096, 32, 8, 128)
# atol = rtol for the grouped matmul against the loop over groups: each
# output element sums 4,096 to 6,400 products, in another order than cuBLAS.
GMM_TOL = 1e-4
# The shape each main path gives each kernel, where phase 3 checks it (a
# list of shapes where one path gives a kernel several).
PATH_SHAPES = {
    "gae": {"ppo_cartpole": [64, 8], "ppo_lm": [32, 8], "appo": [32, 4]},
    "vtrace": {"impala": [32, 16], "impala_vector": [32, 512]},
    "ppo_surrogate_fwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2]},
    "ppo_surrogate_bwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2]},
    "flash_attention_fwd": {"ppo_lm": [128, 256, 20, 20, 128], "pretrain_phi": list(PHI_ATTENTION)},
    "flash_attention_bwd": {"ppo_lm": [128, 256, 20, 20, 128], "pretrain_phi": list(PHI_ATTENTION)},
    "rwkv6_fwd": {"pretrain_rwkv6": list(RWKV6_PATH_SHAPE)},
    "rwkv6_bwd": {"pretrain_rwkv6": list(RWKV6_PATH_SHAPE)},
    **{name: {"pretrain_phi": [list(MOE_GMM_UP), [MOE_GMM_UP[0], MOE_GMM_UP[2], MOE_GMM_UP[1],
                                                 MOE_GMM_UP[3]]]}
       for name in ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw")},
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


class _DeviceProfile:
    """``torch.profiler`` (CUPTI) over the kernels launched between
    ``start()`` and ``stop()``; ``stop()`` returns device microseconds by
    kernel name and leaves the count of each kernel's device records in
    ``records``.  On an H100, once the port's kernel library was loaded, a
    profiler session lost device records of kernels whose launches it
    recorded: the first kernel of a session, and now and then one later
    (``torch.bmm`` at the grouped matmul's shape read 7.7 ms per call over
    5 calls against 20.2 ms by CUDA events).  A short spin kernel launched
    first kept the first record (``_profiler_records`` counts the records
    both ways), so ``start()`` launches one and ``stop()`` leaves it out
    (``prime=False`` skips it); ``_per_call`` copes with the later ones."""

    PRIMER = "spin_kernel"  # the kernel of torch.cuda._sleep

    def __init__(self, prime: bool = True):
        self.prime = prime

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        if self.prime:
            torch.cuda._sleep(1000)

    def stop(self) -> dict:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        out: dict = {}
        self.records: dict = {}
        for e in self.prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                    and self.PRIMER not in e.key):
                out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total
                self.records[e.key] = self.records.get(e.key, 0) + e.count
        return out


def _profiler_records(fn, iters: int = 50) -> dict:
    """How many device records of ``fn``'s main kernel a profiler session
    kept over ``iters`` calls, started cold and primed as
    ``_DeviceProfile`` starts: the evidence for its primer."""
    import torch

    out = {"calls": iters}
    for name, prime in (("cold", False), ("primed", True)):
        fn()
        torch.cuda.synchronize()
        prof = _DeviceProfile(prime)
        prof.start()
        for _ in range(iters):
            fn()
        kernels = prof.stop()
        out[name] = prof.records[max(kernels, key=kernels.get)]
    return out


def _per_call(fn, iters: int) -> tuple:
    """Device microseconds per call of ``fn`` by kernel name over ``iters``
    calls, and how many device records the profiler lost.  A kernel with
    fewer records than its launches per call, round(records / iters) and
    at least 1, times ``iters`` lost the rest: its time per call is the
    mean of its records times those launches (a lost record leaves the mean
    as it was, where dividing the sum by ``iters`` would read it as a
    faster call).  Any other kernel's is its sum over ``iters``, so a kernel
    that does not run the same number of times in every call is not
    scaled up."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = _DeviceProfile()
    prof.start()
    for _ in range(iters):
        fn()
    total = prof.stop()
    per_call, lost = {}, 0
    for name, us in total.items():
        n = prof.records[name]
        launches = max(1, round(n / iters))
        if n < launches * iters:
            per_call[name] = us / n * launches
            lost += launches * iters - n
        else:
            per_call[name] = us / iters
    return per_call, lost


def _device_ms(fn, iters: int = 50) -> tuple:
    """Mean device milliseconds per call, by the profiler's records of every
    kernel the call launched (``_per_call``), or None when it records no
    device time; and the records it lost."""
    per_call, lost = _per_call(fn, iters)
    total_us = sum(per_call.values())
    return (total_us / 1e3 if total_us > 0 else None), lost


def _smi_sample() -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
    fields = smi.stdout.strip().splitlines()[0].split(",") if smi.returncode == 0 else []
    return dict(zip(("clocks_sm", "power_draw", "temperature"),
                    (float(f) for f in fields))) if len(fields) == 3 else {}


def _timings(kernel, plain, plain_iters: int, kernel_iters: int = 200,
             plain_profile: bool = True, clocks: bool = False) -> dict:
    """Kernel and plain version: device ms per call (profiler) and ms per
    call on the stream (CUDA events, host launch cost included), the
    kernel's events read before (``call_ms``) and after (``call_ms_after``)
    its profiled calls.  ``ms`` is the device time where the profiler gives
    one, else the event time; ``ms_from`` and ``plain_ms_from`` say which
    ("profiler" or "cuda_events").  Kernels of tens of milliseconds take a
    smaller ``kernel_iters``; a plain version of tens of thousands of
    launches is not profiled (``plain_profile``), its trace alone would take
    minutes.  With ``clocks``, the card's SM clock, power draw and
    temperature before and after each of the kernel's three readings."""
    samples = [_smi_sample()] if clocks else []
    t = {"call_ms": _time_ms(kernel, iters=kernel_iters, warmup=min(10, kernel_iters))}
    samples += [_smi_sample()] if clocks else []
    t["device_ms"], t["records_lost"] = _device_ms(kernel, iters=min(50, kernel_iters))
    samples += [_smi_sample()] if clocks else []
    t["call_ms_after"] = _time_ms(kernel, iters=kernel_iters, warmup=0)
    if clocks:
        t["clocks"] = samples + [_smi_sample()]
    t["plain_call_ms"] = _time_ms(plain, iters=plain_iters, warmup=2 if plain_profile else 1)
    t["plain_device_ms"], t["plain_records_lost"] = (
        _device_ms(plain, iters=plain_iters) if plain_profile else (None, None))
    for key, device, call in (("ms", "device_ms", "call_ms"),
                              ("plain_ms", "plain_device_ms", "plain_call_ms")):
        profiled = t[device] is not None
        t[key] = t[device] if profiled else t[call]
        t[key + "_from"] = "profiler" if profiled else "cuda_events"
    return t


def _bound_ms(nbytes: int, nops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tensor_core_bounds(nbytes: int, flops: int) -> dict:
    """The bound of the flash and grouped-matmul kernels on their route,
    3xTF32 (three TF32 tensor-core products per product), and the fp32
    CUDA-core bound of earlier PRs beside it as ``bound_fp32_ms``."""
    bound, by = _bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)
    return {"bound_ms": bound, "bound_by": by, "bound_fp32_ms": _bound_ms(nbytes, flops)[0],
            "bytes": nbytes, "flops": flops}


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
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# Rows of the streamed tile by D (forward, backward) and of a block's own
# tile, as flash_attention.cu's fwd_cols / bwd_cols / kRows, for the dynamic
# shared memory of its fwd_smem / dq_smem / dkdv_smem.
FLASH_COLS = {32: (64, 32), 64: (64, 32), 128: (16, 16)}
FLASH_ROWS = 64
# The grouped-matmul kernels of moe_gmm.cu (forward, dX, dW) and, as its
# kBM / kBN / kBK / kStages, their tiles: a staged K-major operand tile holds
# [rows][GMM_BK + 4] floats, an MN-major one [GMM_BK][cols + 8], and B's
# split big and small tiles GMM_TILE x GMM_BK floats each.
GMM_KERNELS = {"gmm_rows_kernelILb0E": "gmm_rows_kernel<false>",
               "gmm_rows_kernelILb1E": "gmm_rows_kernel<true>", "gmm_dw_kernel": "gmm_dw_kernel"}
GMM_TILE, GMM_BK, GMM_STAGES, GMM_THREADS = 128, 32, 4, 256
SM_SMEM_BYTES = 233472  # 228 KB of shared memory on an H100 SM; 1 KB more per block
SM_REGISTERS = 65536


def _kernel_name(symbol: str):
    """``flash_fwd_kernel<128>`` or ``gmm_rows_kernel<false>`` from a mangled
    kernel symbol of the flash or grouped-matmul sources, or None."""
    m = re.search(r"(" + "|".join(FLASH_KERNELS) + r")ILi(\d+)E", symbol)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    return next((name for key, name in GMM_KERNELS.items() if key in symbol), None)


def _kernel_smem(name: str) -> tuple:
    """Dynamic shared memory bytes and threads of a block of ``name``."""
    if name.startswith("gmm_"):
        k_major = GMM_TILE * (GMM_BK + 4)
        mn_major = GMM_BK * (GMM_TILE + 8)
        tiles = {"gmm_rows_kernel<false>": k_major + mn_major,
                 "gmm_rows_kernel<true>": 2 * k_major, "gmm_dw_kernel": 2 * mn_major}[name]
        return (GMM_STAGES * tiles + 2 * GMM_TILE * GMM_BK) * 4, GMM_THREADS
    kernel, D = name[:-1].split("<")
    fwd_cols, bwd_cols = FLASH_COLS[int(D)]
    if kernel == "flash_fwd_kernel":
        return (FLASH_ROWS + 4 * fwd_cols) * (int(D) + 4) * 4, 128
    dq = (2 * FLASH_ROWS + 4 * bwd_cols) * (int(D) + 4) * 4
    return (dq + 16 * bwd_cols if kernel == "flash_bwd_dkdv_kernel" else dq), 128


def _kernel_usage(log: str, library: str) -> dict:
    """Each flash and grouped-matmul kernel's registers and spills (``ptxas
    -v``), dynamic shared memory, resident blocks per SM by registers and
    shared memory, and, where ``cuobjdump`` is found, its count of TF32
    ``HMMA``/``HGMMA`` instructions in the SASS (a kernel with none fails the
    phase: its products would not be on the tensor cores)."""
    usage: dict = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
            if name:
                usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage[name]["registers"] = int(m.group(1))
    for name, u in usage.items():
        smem, threads = _kernel_smem(name)
        regs_per_warp = -(-u.get("registers", 255) * 32 // 256) * 256
        u.update(smem_bytes=smem, blocks_per_sm=min(SM_REGISTERS // (threads // 32 * regs_per_warp),
                                                     SM_SMEM_BYTES // (smem + 1024), 16))
    _require(len(usage) == 12, f"ptxas reported {sorted(usage)}, want 3 flash kernels x 3 head "
                               "dims and 3 grouped-matmul kernels")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300)
        _require(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
        name = None
        for ln in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                name = _kernel_name(m.group(1))
                if name:
                    usage[name].update(hmma=0, hmma_tf32=0)
            elif name and "MMA" in ln:
                usage[name]["hmma"] += 1
                usage[name]["hmma_tf32"] += "TF32" in ln
        for name, u in usage.items():
            _require(u.get("hmma_tf32", 0) > 0,
                     f"{name}: no TF32 HMMA/HGMMA instruction in its SASS ({u.get('hmma')} MMA)")
    return usage


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
    log = info["log"] or (build.BUILD_DIR / "build.log").read_text()  # "" when cached
    usage = _kernel_usage(log, info["path"])
    for name, u in usage.items():
        print(f"tensor-core kernel {name}: {json.dumps(u)}")
    return {"build_s": seconds, "tensor_core_kernels": usage}


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
    """The PyTorch library call's device ms per call by the profiler
    (``library_ms``, the clock of the kernels' ``ms``), its ms per call on
    the stream (CUDA events, ``library_call_ms``, beside the kernels'
    ``call_ms``), and which SDPA backend it took, read from the names of
    its kernels."""
    kernels, lost = _per_call(fn, iters)
    total_us = sum(kernels.values())
    names = " ".join(kernels).lower()
    backend = next(
        (b for key, b in (("flash", "flash"), ("fmha", "efficient"), ("cutlass", "efficient"),
                          ("cudnn", "cudnn")) if key in names),
        "math",
    )
    top = sorted(kernels, key=lambda k: -kernels[k])[:3]
    call_ms = _time_ms(fn, iters=iters, warmup=2)
    return {
        "library_ms": total_us / 1e3 if total_us > 0 else call_ms,
        "library_ms_from": "profiler" if total_us > 0 else "cuda_events",
        "library_call_ms": call_ms,
        "library_records_lost": lost,
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


def _flash_fwd_case(B, Sq, Sk, H, KV, D, causal, window, q_offset, seed, kernel_iters=200) -> dict:
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
    simple = causal and not window and not q_offset and Sq == Sk

    def plain():
        with torch.no_grad():
            flash_attention_plain(q, k, v, **kw)

    return {
        "shape": [B, Sq, H, KV, D], "Sk": Sk, **kw, "max_abs_err": err,
        **_tensor_core_bounds(nbytes, 4 * B * H * D * pairs),
        **_timings(lambda: flash_fwd_cuda(q, k, v, causal, window, q_offset), plain, plain_iters=5,
                   kernel_iters=kernel_iters),
        **_library(lambda: _sdpa(q, k, v, mask, simple)),
    }


def _flash_bwd_case(B, Sq, Sk, H, KV, D, causal, window, q_offset, seed, kernel_iters=200,
                    clocks=False) -> dict:
    """Backward: gradients of the kernel's autograd.Function against torch
    autograd through the plain version (and bitwise equal across two runs),
    and the backward launch alone timed against the plain version's
    autograd backward and SDPA's, under the same mask; ``clocks`` as
    ``_timings``'."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_bwd_cuda,
        flash_fwd_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _randn(g, B, Sq, H, D), _randn(g, B, Sk, KV, D), _randn(g, B, Sk, KV, D)
    dout = _randn(g, B, Sq, H, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    name = f"flash_attention_bwd[{B},{Sq},{H}/{KV},{D}] Sk={Sk} {kw}"

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs, **kw)
        return torch.autograd.grad(out, xs, dout, retain_graph=True), (out, xs)

    got, _ = grads(flash_attention_cuda)
    again, _ = grads(flash_attention_cuda)
    want, (plain_out, plain_xs) = grads(flash_attention_plain)
    torch.cuda.synchronize()
    err = max(_close(f"{name} d{n}", a, b, GRAD_TOL) for n, a, b in zip("qkv", got, want))
    _require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{name}: gradients differ between two runs")
    del got, again, want
    o, lse = flash_fwd_cuda(q, k, v, causal, window, q_offset)
    mask, pairs = _visible_pairs(Sq, Sk, causal, window, q_offset)
    # reads q, o, dO, lse, k, v; writes dq, dk, dv
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * KV * D + B * H * Sq) * 4
    simple = causal and not window and not q_offset and Sq == Sk
    lib_xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = _sdpa(*lib_xs, mask, simple)
    return {
        "shape": [B, Sq, H, KV, D], "Sk": Sk, **kw, "max_abs_err": err, "deterministic": True,
        **_tensor_core_bounds(nbytes, 10 * B * H * D * pairs),
        **_timings(
            lambda: flash_bwd_cuda(q, k, v, o, lse, dout, causal, window, q_offset),
            lambda: torch.autograd.grad(plain_out, plain_xs, dout, retain_graph=True),
            plain_iters=5, kernel_iters=kernel_iters, clocks=clocks,
        ),
        **_library(lambda: torch.autograd.grad(lib_out, lib_xs, dout.transpose(1, 2), retain_graph=True)),
    }


def _rwkv6_inputs(B: int, T: int, H: int, N: int, seed: int, state: bool):
    """r, k, v ~ N(0, 0.25); decays from the model's own law at its
    initial bias, w = exp(-exp(clip(-2 + 0.5 z, -8, 2))); u ~ N(0, 0.01);
    a start state ~ N(0, 1) when asked for."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (0.5 * _randn(g, B, T, H, N) for _ in range(3))
    w = torch.exp(-torch.exp(torch.clamp(-2.0 + 0.5 * _randn(g, B, T, H, N), -8.0, 2.0)))
    u = 0.1 * _randn(g, H, N)
    s0 = _randn(g, B, H, N, N) if state else None
    return r, k, v, w, u, s0


def _rwkv6_case(B: int, T: int, H: int, N: int, seed: int, state: bool = False,
                chunk: int = 64, kernel_iters: int = 50, check_profiler: bool = False) -> dict:
    """Forward (out, final state) and the gradients of all inputs, with
    cotangents on the output and the final state, through the kernels'
    autograd.Function, against the plain loop in float64 (chunk-checkpointed,
    as the reference's oracle) and its autograd; the backward twice, for
    bitwise equal gradients.  The oracle runs in float64 because du sums
    B * T steps: at [2, 4096, 64, 64] on an H100 the float32 plain loop's
    own du is 6.8e-4 away from the oracle in places, more than the
    tolerance (each case records the float32 loop's distance as
    ``plain_fp32_err``).  Times are of the float32 plain loop.  With
    ``check_profiler``, also ``_profiler_records`` of the forward."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6_bwd_cuda, rwkv6_cuda, rwkv6_fwd_cuda, rwkv6_plain

    xs = _rwkv6_inputs(B, T, H, N, seed, state)
    s0 = xs[5]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cot_o, cot_s = _randn(g, B, T, H, N), _randn(g, B, H, N, N)
    name = f"rwkv6[{B},{T},{H},{N}]" + (" with a start state" if state else "")

    def grads(fn, dtype, **kw):
        ts = [x.to(dtype, copy=True).requires_grad_(True) for x in xs if x is not None]
        out, final = fn(*ts[:5], state=ts[5] if state else None, chunk=chunk, **kw)
        cots = (cot_o.to(dtype), cot_s.to(dtype))
        return (out, final), ts, torch.autograd.grad((out, final), ts, cots, retain_graph=True)

    (out_k, fin_k), _, got = grads(rwkv6_cuda, torch.float32)
    _, _, again = grads(rwkv6_cuda, torch.float32)
    (out_p, fin_p), _, want = grads(rwkv6_plain, torch.float64)
    torch.cuda.synchronize()
    fwd_err = max(_close(f"{name} out", out_k.detach().double(), out_p.detach()),
                  _close(f"{name} final state", fin_k.detach().double(), fin_p.detach()))
    names = ["r", "k", "v", "w", "u", "state"]
    bwd_err = max(_close(f"{name} d{n}", a.double(), b, GRAD_TOL) for n, a, b in zip(names, got, want))
    _require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{name}: gradients differ between two runs")
    del got, again, out_k, fin_k, out_p, fin_p
    # The float32 plain loop against the same oracle, for the record.
    (out_p, fin_p), plain_ts, plain32 = grads(rwkv6_plain, torch.float32)
    plain_fp32_err = {n: _max_err(a, b) for n, a, b in zip(names, plain32, want)}
    del want, plain32

    r, k, v, w, u = xs[:5]
    plain_graph = (out_p, fin_p)

    def plain_fwd():
        with torch.no_grad():
            rwkv6_plain(r, k, v, w, u, state=s0)

    _, _, ckpt = rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True)
    fwd_t = _timings(lambda: rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True), plain_fwd,
                     plain_iters=1, kernel_iters=kernel_iters, plain_profile=False)
    if check_profiler:
        fwd_t["profiler_records"] = _profiler_records(
            lambda: rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True))
        print(f"profiler records of {name}'s forward: {fwd_t['profiler_records']}")
    bwd_t = _timings(
        lambda: rwkv6_bwd_cuda(r, k, v, w, u, cot_o, ckpt, cot_s, chunk, state),
        lambda: torch.autograd.grad(plain_graph, plain_ts, (cot_o, cot_s), retain_graph=True),
        plain_iters=1, kernel_iters=kernel_iters, plain_profile=False,
    )
    del plain_graph, plain_ts, out_p, fin_p

    # Bytes: the training forward reads r, k, v, w, u (and s0) and writes o,
    # the final state and the chunk-start states; the backward reads r, k,
    # v, w, u, dO, dS_T and the chunk-start states and writes dr, dk, dv, dw,
    # du (and dS_0).  Operations per (b, t, h), counting an FMA as two: the
    # forward's k v, S + u k v, r . (...) and w S + k v, 7 N^2; the
    # backward's recomputed update, 3 N^2, and its sums and G update, 11 N^2.
    seq, st_bytes = B * T * H * N * 4, B * H * N * N * 4
    ck_bytes = B * H * -(-T // chunk) * N * N * 4
    fwd_bytes = 5 * seq + H * N * 4 + st_bytes + ck_bytes + (st_bytes if state else 0)
    bwd_bytes = 9 * seq + 2 * H * N * 4 + st_bytes + ck_bytes + (st_bytes if state else 0)
    fwd_bound = _bound_ms(fwd_bytes, 7 * B * T * H * N * N)
    bwd_bound = _bound_ms(bwd_bytes, 14 * B * T * H * N * N)
    shape = [B, T, H, N]
    common = {"shape": shape, "state": state, "chunk": chunk, "library_ms": None}
    return {
        "fwd": {**common, "max_abs_err": fwd_err, "bound_ms": fwd_bound[0],
                "bound_by": fwd_bound[1], "bytes": fwd_bytes, **fwd_t},
        "bwd": {**common, "max_abs_err": bwd_err, "deterministic": True, "bound_ms": bwd_bound[0],
                "bound_by": bwd_bound[1], "bytes": bwd_bytes, "plain_fp32_err": plain_fp32_err,
                **bwd_t},
    }


def _gmm_inputs(sizes: list, D: int, F: int, seed: int, tail: int):
    """x [T, D] and dy [T, F] N(0, 1) and w [E, D, F] N(0, 1/D), as the
    model's experts, so the forward's and dX's outputs are O(1); T is the
    groups' rows plus ``tail`` rows past the last group."""
    import torch

    E, T = len(sizes), sum(sizes) + tail
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = _randn(g, T, D), _randn(g, T, F)
    w = _randn(g, E, D, F) / math.sqrt(D)
    return x, dy, w, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _gmm_library(sizes: list, fn) -> dict:
    """With equal groups, the PyTorch call on the same inputs that the
    grouped product replaces (``fn``), else None."""
    if len(set(sizes)) != 1:
        return {"library_ms": None}
    out = _library(fn, iters=5)
    out["library_backend"] = "cublas"
    return out


def _gmm_case(sizes: list, D: int, F: int, seed: int, kernel_iters: int = 20,
              overrun: int = 0, tail: int = 0) -> dict:
    """The grouped matmul against the loop over groups.  With ``overrun``,
    also the same groups over x cut by that many rows: groups that sum past
    x's end are cut there by both versions; with ``tail``, x has that many
    rows past the last group, which come out zero."""
    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_plain

    x, _, w, gs = _gmm_inputs(sizes, D, F, seed, tail)
    (T, _), E = x.shape, len(sizes)
    got = moe_gmm_cuda(x, w, gs)
    want = moe_gmm_plain(x, w, gs)
    torch.cuda.synchronize()
    err = _close(f"moe_gmm [{T}, {D}] x [{E}, {D}, {F}] groups {sizes[:6]}...", got, want, GMM_TOL)
    del got, want
    if overrun:
        cut = x[: T - overrun]
        err = max(err, _close(f"moe_gmm groups summing to {T} over {T - overrun} rows",
                              moe_gmm_cuda(cut, w, gs), moe_gmm_plain(cut, w, gs), GMM_TOL))
    nbytes = 4 * (T * D + E * D * F + T * F)
    path = sizes == [MOE_GMM_UP[0] // MOE_GMM_UP[3]] * MOE_GMM_UP[3]
    return {
        "shape": [T, D, F, E], "groups": sizes, "tail": tail, "max_abs_err": err,
        **_tensor_core_bounds(nbytes, 2 * T * D * F),
        **_timings(lambda: moe_gmm_cuda(x, w, gs), lambda: moe_gmm_plain(x, w, gs),
                   plain_iters=3, kernel_iters=kernel_iters, clocks=path),
        **_gmm_library(sizes, lambda: torch.bmm(x.view(E, sizes[0], D), w)),
    }


def _gmm_bwd_case(sizes: list, D: int, F: int, seed: int, kernel_iters: int = 20,
                  overrun: int = 0, tail: int = 0) -> dict:
    """The backward products of the grouped matmul out = x @ w[e] against the
    loops over groups: dX = dy @ w[e]^T and dW[e] = x_e^T dy_e (twice: bitwise
    equal), with ``overrun`` and ``tail`` as ``_gmm_case``.  For dW, dy is
    scaled by 1 / sqrt(mean group size), so dW is O(1) as the other outputs.
    Each yardstick is the einsum of ``GmmMatmul``'s backward that the kernel
    replaces (``repro/models/moe.py:145``), on the [B, E, C, .] layout of
    the pretraining path (B = PRETRAIN["batch"])."""
    import torch

    from repro_torch.kernels.moe_gmm import (
        moe_gmm_dw_cuda,
        moe_gmm_dw_plain,
        moe_gmm_dx_cuda,
        moe_gmm_dx_plain,
    )

    x, dy, w, gs = _gmm_inputs(sizes, D, F, seed, tail)
    (T, _), E = x.shape, len(sizes)
    dyw = dy / math.sqrt(max(1, sum(sizes)) / E)
    name = f"[{T}, {D}] x [{E}, {D}, {F}] groups {sizes[:6]}..."
    dx_err = _close(f"moe_gmm_dx {name}", moe_gmm_dx_cuda(dy, w, gs), moe_gmm_dx_plain(dy, w, gs),
                    GMM_TOL)
    got = moe_gmm_dw_cuda(x, dyw, gs)
    _require(bool(torch.equal(got, moe_gmm_dw_cuda(x, dyw, gs))),
             f"moe_gmm_dw {name}: dW differs between two runs")
    dw_err = _close(f"moe_gmm_dw {name}", got, moe_gmm_dw_plain(x, dyw, gs), GMM_TOL)
    del got
    if overrun:
        n = T - overrun
        dx_err = max(dx_err, _close(f"moe_gmm_dx groups summing to {T} over {n} rows",
                                    moe_gmm_dx_cuda(dy[:n], w, gs), moe_gmm_dx_plain(dy[:n], w, gs),
                                    GMM_TOL))
        dw_err = max(dw_err, _close(f"moe_gmm_dw groups summing to {T} over {n} rows",
                                    moe_gmm_dw_cuda(x[:n], dyw[:n], gs),
                                    moe_gmm_dw_plain(x[:n], dyw[:n], gs), GMM_TOL))
    torch.cuda.synchronize()
    path = sizes == [MOE_GMM_UP[0] // MOE_GMM_UP[3]] * MOE_GMM_UP[3]
    common = {"shape": [T, D, F, E], "groups": sizes, "tail": tail,
              **_tensor_core_bounds(4 * (T * D + E * D * F + T * F), 2 * T * D * F)}
    dx_lib, dw_lib = {"library_ms": None}, {"library_ms": None}
    if len(set(sizes)) == 1:
        B = PRETRAIN["batch"]
        per_b = (E, B, sizes[0] // B)
        dy4 = dy.view(*per_b, F).transpose(0, 1).contiguous()
        x4 = x.view(*per_b, D).transpose(0, 1).contiguous()
        dx_lib = _gmm_library(sizes, lambda: torch.einsum("becn,ekn->beck", dy4, w))
        dw_lib = _gmm_library(sizes, lambda: torch.einsum("beck,becn->ekn", x4, dy4))
    return {
        "dx": {**common, "max_abs_err": dx_err, **dx_lib,
               **_timings(lambda: moe_gmm_dx_cuda(dy, w, gs), lambda: moe_gmm_dx_plain(dy, w, gs),
                          plain_iters=3, kernel_iters=kernel_iters, clocks=path)},
        "dw": {**common, "max_abs_err": dw_err, "deterministic": True, **dw_lib,
               **_timings(lambda: moe_gmm_dw_cuda(x, dyw, gs),
                          lambda: moe_gmm_dw_plain(x, dyw, gs),
                          plain_iters=3, kernel_iters=kernel_iters, clocks=path)},
    }


def _gmm_cases() -> dict:
    """The grouped matmul and its backward products at the pretraining
    path's two shapes, at ragged groups (an empty one, groups past x's end,
    rows past the last group) and with a group that is not a multiple of
    64."""
    T, D, F, E = MOE_GMM_UP
    ragged = [300, 0, 1000, 77, 129, 640, 1, 511]
    shapes = [([T // E] * E, D, F, 60, 10, 0, 0),  # up and gate products
              ([T // E] * E, F, D, 61, 10, 0, 0),  # down product
              (ragged, 1024, 1536, 62, 20, 600, 0),
              (ragged, 1024, 1536, 64, 20, 0, 250),
              ([1280, 1000, 1280, 1280], D, F, 63, 20, 0, 0)]
    out = {"moe_gmm": [], "moe_gmm_dx": [], "moe_gmm_dw": []}
    for sizes, d, f, seed, iters, overrun, tail in shapes:
        out["moe_gmm"].append(_gmm_case(sizes, d, f, seed, iters, overrun, tail))
        bwd = _gmm_bwd_case(sizes, d, f, seed + 10, iters, overrun, tail)
        out["moe_gmm_dx"].append(bwd["dx"])
        out["moe_gmm_dw"].append(bwd["dw"])
    return out


def _narrow_heads(case, seed: int) -> list:
    """Flash cases at D = 64 and D = 32 (tiles of other sizes than D = 128's):
    GQA with a ragged S, a non-causal one with Sq != Sk, and a window with a
    q_offset."""
    return [
        case(2, 1000, 1000, 16, 4, 64, True, 0, 0, seed),
        case(2, 777, 777, 8, 2, 32, True, 0, 0, seed + 1),
        case(2, 300, 500, 8, 2, 64, False, 0, 0, seed + 2),
        case(2, 300, 812, 8, 8, 32, True, 128, 512, seed + 3),
    ]


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
    B, S, H, KV, D = PHI_ATTENTION
    _phi = (B, S, S, H, KV, D)
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
            _flash_bwd_case(128, d, d, 20, 20, 128, True, 0, 0, 30),  # learner
            _flash_bwd_case(4, 512, 512, 20, 20, 128, True, 0, 0, 31),
            _flash_bwd_case(2, 1024, 1024, 40, 8, 128, True, 0, 0, 32),
            _flash_bwd_case(*_phi, True, 0, 0, 33, kernel_iters=10, clocks=True),  # Phi's learner
            _flash_bwd_case(2, 2048, 2048, 40, 8, 128, True, 512, 0, 34),  # sliding window
            _flash_bwd_case(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 35),  # q_offset
            *_narrow_heads(_flash_bwd_case, 36),
        ],
    }
    out["flash_attention_fwd"] += [
        _flash_fwd_case(*_phi, True, 0, 0, 26, kernel_iters=20),
        *_narrow_heads(_flash_fwd_case, 27),
    ]
    rwkv6_cases = [
        _rwkv6_case(*RWKV6_PATH_SHAPE, 50, kernel_iters=20, check_profiler=True),  # path shape
        _rwkv6_case(2, 1000, 64, 64, 51),  # ragged T
        _rwkv6_case(2, 300, 8, 64, 52, state=True),  # a start state
        _rwkv6_case(4, 256, 8, 32, 53, chunk=16),  # narrow heads
    ]
    out["rwkv6_fwd"] = [c["fwd"] for c in rwkv6_cases]
    out["rwkv6_bwd"] = [c["bwd"] for c in rwkv6_cases]
    out.update(_gmm_cases())
    for name, cases in out.items():
        tol = GRAD_TOL if name in ("flash_attention_bwd", "rwkv6_bwd") else TOL
        tol = GMM_TOL if name.startswith("moe_gmm") else tol
        for c in cases:
            lib = c.get("library_ms")
            lib_txt = f" library_ms={lib} ({c.get('library_backend')})" if lib is not None else ""
            fp32 = c.get("bound_fp32_ms")
            fp32_txt = f" bound_fp32_ms={fp32:.6f}" if fp32 is not None else ""
            print(
                f"kernel {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} (tol {tol}) "
                f"device_ms={c['device_ms']} call_ms={c['call_ms']:.5f} "
                f"call_ms_after={c['call_ms_after']:.5f} "
                f"plain_device_ms={c['plain_device_ms']} plain_call_ms={c['plain_call_ms']:.5f} "
                f"bound_ms={c['bound_ms']:.6f} ({c['bound_by']}){fp32_txt} "
                f"records_lost={c['records_lost']}{lib_txt}"
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
                prof = _DeviceProfile()
                prof.start()
            t0 = time.perf_counter()
            result = algo.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if prof is not None:
                busy = prof.stop()
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
                    prof = _DeviceProfile()
                    prof.start()
                before = {c.name: c.value for c in counters}
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    busy = prof.stop()
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
            prof = _DeviceProfile()
            prof.start()
            t_prof = time.perf_counter()
            while time.perf_counter() - t_prof < ASYNC_PROFILE_S:
                result = train_once(len(rows))
            window = time.perf_counter() - t_prof
            window_steps = learner.num_steps - steps0
            window_trained = rows[-1]["steps_trained"] - trained0
            busy = prof.stop()
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


# ------------------------------------------------------------ phase 12
def _record_routing(fn):
    """Run ``fn`` while recording the experts every MoE layer routes to."""
    from repro_torch.models import moe as moe_mod

    route, seen = moe_mod.route, []

    def recording(params, x, cfg):
        probs, top_p, top_e = route(params, x, cfg)
        seen.append(top_e.detach().cpu())
        return probs, top_p, top_e

    moe_mod.route = recording
    try:
        fn()
    finally:
        moe_mod.route = route
    return seen


def phase_pretrain_parity() -> dict:
    """One ``learn_on_batch`` of the pretraining learner (SGD at lr 1, so
    the weight difference is the gradient difference; see phase 6) on the
    card and on the CPU from the same weights, at the reduced configuration
    of each architecture in float32.  For the MoE one the experts every
    token routes to must first be the same on both devices: one flipped
    choice would make the weight comparison meaningless."""
    import numpy as np
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.data import make_batch
    from repro_torch.interop import params_to_numpy
    from repro_torch.launch.train import train_config
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    out = {}
    for arch in PRETRAIN_PATHS.values():
        cfg = train_config(arch, smoke=True)
        gpu = SPMDLearnerWorker(SPMDTrainContext(cfg, sgd(1.0), device="cuda"))
        cpu = SPMDLearnerWorker(SPMDTrainContext(cfg, sgd(1.0), device="cpu"))
        cpu.set_weights(params_to_numpy(gpu.get_weights()))
        batch = make_batch(cfg, InputShape("t", 64, 2, "train"), seed=0, step=0)
        routed = 0
        if cfg.moe is not None:
            def probe(worker):
                tokens, labels = (torch.from_numpy(batch[k]).to(worker.ctx.device)
                                  for k in ("tokens", "labels"))
                with torch.no_grad():
                    return _record_routing(lambda: worker.ctx.model.loss(worker.params, tokens, labels))

            on_gpu, on_cpu = probe(gpu), probe(cpu)
            _require(len(on_gpu) == len(on_cpu) == cfg.num_layers, "routing probe missed a layer")
            flips = sum(int((a != b).sum()) for a, b in zip(on_gpu, on_cpu))
            _require(flips == 0, f"pretrain parity ({arch}): {flips} expert choices differ between "
                                 "card and CPU, so the weights cannot be compared")
            routed = sum(a.numel() for a in on_gpu)
        info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
        w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
        w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
        err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
        stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
        _require(err <= LEARNER_TOL, f"pretrain parity ({arch}): card vs CPU weights differ by {err:.3e}")
        _require(stat_err <= LEARNER_TOL, f"pretrain parity ({arch}): stats differ by {stat_err:.3e}")
        routing = f"; {routed} expert choices identical" if cfg.moe is not None else ""
        print(f"pretrain learner parity ({cfg.name}): one learn_on_batch (SGD, lr 1) on 2 x 64 tokens, "
              f"card vs CPU max weight err {err:.3e}, max stat err {stat_err:.3e} (tol "
              f"{LEARNER_TOL}){routing}; loss {info_g['loss']:.4f}")
        out[arch] = {"weight_err": err, "stat_err": stat_err, "expert_choices_checked": routed}
    return out


# --------------------------------------------------------- phases 13-14
def _pretrain_expected(cfg) -> dict:
    """Launches per train() step implied by the configuration: each layer's
    forward once (no remat) and its backward once; an MoE layer runs three
    expert products (up, gate, down) with a gated MLP, two without, and the
    dX and dW products of each in the backward."""
    L = cfg.num_layers
    spec = cfg.block_pattern[0]
    expect = {}
    if spec.kind == "rwkv6":
        expect.update(rwkv6_fwd=L, rwkv6_bwd=L)
    if spec.kind == "attn":
        expect.update(flash_attention_fwd=L, flash_attention_bwd=L)
    if spec.mlp == "moe":
        products = L * (3 if cfg.activation == "silu" else 2)
        expect.update(moe_gmm=products, moe_gmm_dx=products, moe_gmm_dw=products)
    return expect


def _check_path_shapes(cfg) -> None:
    """The shapes phase 3 held the kernels to are this path's own."""
    B, T = PRETRAIN["batch"], PRETRAIN["seq"]
    if cfg.ssm is not None:
        s = cfg.ssm
        shape = (B, T, cfg.d_model // s.head_dim, s.head_dim)
        _require(shape == RWKV6_PATH_SHAPE, f"{cfg.name}: RWKV-6 shape {shape} != {RWKV6_PATH_SHAPE}")
    if cfg.moe is not None:
        e = cfg.moe
        C = max(1, math.ceil(e.capacity_factor * T * e.top_k / e.num_experts))
        shape = (e.num_experts * B * C, cfg.d_model, e.d_ff, e.num_experts)
        _require(shape == MOE_GMM_UP, f"{cfg.name}: grouped-matmul shape {shape} != {MOE_GMM_UP}")
    if cfg.num_heads:
        shape = (B, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        _require(shape == PHI_ATTENTION, f"{cfg.name}: attention shape {shape} != {PHI_ATTENTION}")


def phase_pretrain(name: str, counters: list) -> dict:
    """One LM pretraining main path: ``launch/train.py``'s flow
    (``make_pretrain`` -> ``build_lm_flow`` -> ``Algorithm.from_plan``) at
    the configuration's widths cut to 2 layers, ``steps`` train() calls
    under a deadline, the last one profiled.  Launches are read per step and
    must be exactly what the configuration implies, every other kernel 0."""
    import gc

    import torch

    from repro_torch.flow import Algorithm
    from repro_torch.launch.train import make_pretrain, train_config
    from repro_torch.tree import tree_leaves

    c = PRETRAIN
    cfg = train_config(PRETRAIN_PATHS[name], layers=c["layers"])
    _check_path_shapes(cfg)
    expect = {k.name: 0 for k in counters}
    expect.update(_pretrain_expected(cfg))
    # The synthetic tokens are uniform, so the loss stays at the NLL of
    # uniform labels under the initial logits, ln V + sigma^2 / 2, with sigma
    # = 0.02 sqrt(d_model) the logits' spread (the head's init scale times
    # the unit-RMS final norm): 11.91 for RWKV-6 and 11.20 for Phi-3.5-MoE.
    loss0 = math.log(cfg.vocab_size) + (0.02 * math.sqrt(cfg.d_model)) ** 2 / 2
    tokens = c["seq"] * c["batch"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    with _deadline(PRETRAIN_DEADLINE_S, name):
        t_init = time.perf_counter()
        learner, _, workers, spec = make_pretrain(
            cfg, c["seq"], c["batch"], c["data_shards"], c["steps"], device="cuda"
        )
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        n_params = sum(p.numel() for p in tree_leaves(learner.params))
        with Algorithm.from_plan(spec, workers) as algo:
            for k in counters:
                k.reset()
            for i in range(c["steps"]):
                prof = None
                if i == c["steps"] - 1:  # the last step runs under the profiler
                    prof = _DeviceProfile()
                    prof.start()
                before = {k.name: k.value for k in counters}
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    busy = prof.stop()
                launched = {k.name: k.value - before[k.name] for k in counters}
                info = result["info"]
                rows.append({"step": i, "seconds": dt, "tokens_per_s": tokens / dt, **info})
                print(f"{name} train {i}: loss={info['loss']:.4f} nll={info['nll']:.4f} "
                      f"aux={info['aux']:.5f} {dt:.3f} s {tokens / dt:.1f} tokens/s "
                      + " ".join(f"{k}={v}" for k, v in launched.items() if v))
                _require(set(info) == {"loss", "nll", "aux"}, f"{name}: info keys {sorted(info)}")
                _require(all(math.isfinite(v) for v in info.values()), f"{name}: non-finite {info}")
                _require(abs(info["loss"] - loss0) < 0.5,
                         f"{name}: loss {info['loss']:.4f} not within 0.5 of ln V + sigma^2/2 = "
                         f"{loss0:.4f}")
                _require(result["counters"]["num_steps_trained"] == (i + 1) * c["batch"],
                         f"{name}: counters {result['counters']} after {i + 1} steps")
                _require(launched == expect, f"{name}: step {i} launched {launched}, expected {expect}")
            launches = {k.name: k.value for k in counters}
        peak = torch.cuda.max_memory_allocated()
        del learner, workers, spec, algo
    gc.collect()
    torch.cuda.empty_cache()
    _require(peak < 80e9, f"{name}: peak memory {peak / 1e9:.2f} GB")
    busy_ms = sum(busy.values()) / 1e3
    names = ("rwkv6_", "gmm_", "flash_")
    ours = {k[:60]: v / 1e3 for k, v in busy.items() if any(n in k for n in names)}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    warm = [r["seconds"] for r in rows[1:-1]]
    warm_s = sum(warm) / len(warm)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_s * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3), "idle_share_vs_unprofiled": 1.0 - busy_ms / (warm_s * 1e3),
        "port_kernels_ms": ours, "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(f"{name} profile step {c['steps'] - 1}: wall {dt * 1e3:.1f} ms (unprofiled {warm_s * 1e3:.1f} "
          f"ms), device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
          f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled); peak memory "
          f"{peak / 2**30:.2f} GiB; {n_params / 1e9:.3f} B parameters, init {init_s:.2f} s")
    print(f"{name} top device kernels (ms): {profiled['top_kernels_ms']}")
    print(f"{name} main path: {c['steps']} train() steps of {tokens} tokens, "
          f"{warm_s:.3f} s per step and {tokens / warm_s:.1f} tokens/s after the first "
          f"(steps 1-{c['steps'] - 2}), per-step launches {expect}")
    return {"config": cfg.name, "layers": cfg.num_layers, "params": n_params, "steps": rows,
            "seconds_per_step": warm_s, "tokens_per_s": tokens / warm_s, "init_s": init_s,
            "launches": launches,
            "expected_per_step": expect, "peak_memory_bytes": peak, "profile": profiled}


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
    "rwkv6_fwd": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/rwkv6.py:31"),
    # No TPU kernel either: the reference learner differentiates ref.rwkv6_ref.
    "rwkv6_bwd": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/ref.py:128"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:24"),
    # No TPU kernel: the reference's custom VJP computes both products of
    # the backward with einsums.
    "moe_gmm_dx": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/models/moe.py:145"),
    "moe_gmm_dw": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/models/moe.py:145"),
}


def main() -> int:
    t_script = time.perf_counter()
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
    from repro_torch.kernels.moe_gmm import (
        MOE_GMM_DW_LAUNCHES,
        MOE_GMM_DX_LAUNCHES,
        MOE_GMM_LAUNCHES,
    )
    from repro_torch.kernels.rwkv6 import RWKV6_BWD_LAUNCHES, RWKV6_FWD_LAUNCHES
    from repro_torch.kernels.surrogate import SURROGATE_BWD_LAUNCHES, SURROGATE_FWD_LAUNCHES

    every_counter = [GAE_LAUNCHES, VTRACE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES,
                     DECODE_ATTENTION_LAUNCHES, FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES,
                     RWKV6_FWD_LAUNCHES, RWKV6_BWD_LAUNCHES, MOE_GMM_LAUNCHES, MOE_GMM_DX_LAUNCHES,
                     MOE_GMM_DW_LAUNCHES]
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
        record["pretrain_parity"] = phase_pretrain_parity()
        for name in PRETRAIN_PATHS:
            record[name] = phase_pretrain(name, every_counter)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    kernels = []
    paths = {"ppo_cartpole": record["main_path"]["launches"], "ppo_lm": record["rlhf"]["launches"],
             **{name: record[name]["launches"] for name in ASYNC_PATHS},
             **{name: record[name]["launches"] for name in PRETRAIN_PATHS}}
    for name, (source, replaces) in KERNEL_SITES.items():
        path_case = record["kernels"][name][0]  # the path's shape comes first
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        cases_by_path = {}
        for p, shapes in PATH_SHAPES.get(name, {}).items():
            picked = []
            for shape in shapes if isinstance(shapes[0], list) else [shapes]:
                c = next(c for c in record["kernels"][name] if c["shape"] == shape)
                picked.append({k: c.get(k) for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "bound_fp32_ms",
                                                     "call_ms", "call_ms_after", "library_ms",
                                                     "library_call_ms")})
            cases_by_path[p] = picked if len(picked) > 1 else picked[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in record["kernels"][name]),
            "ms": path_case["ms"], "plain_ms": path_case["plain_ms"],
            "ms_from": path_case["ms_from"], "plain_ms_from": path_case["plain_ms_from"],
            "bound_ms": path_case["bound_ms"], "bound_by": path_case["bound_by"],
            **({"bound_fp32_ms": path_case["bound_fp32_ms"]} if "bound_fp32_ms" in path_case else {}),
            "library_ms": path_case["library_ms"], "library_ms_from": path_case.get("library_ms_from"),
            "library_backend": path_case.get("library_backend"), "shape": path_case["shape"],
            "call_ms": path_case["call_ms"], "plain_call_ms": path_case["plain_call_ms"],
            "library_call_ms": path_case.get("library_call_ms"),
            "cases_by_path": cases_by_path,
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_script:.1f} s")
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
