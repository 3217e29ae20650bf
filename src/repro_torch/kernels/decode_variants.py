"""Time the design choices of the decode-attention kernel on the GPU.

``csrc/decode_attention.cu`` splits the cache window over blocks, keeps
several slots' K/V rows in flight per warp in registers, and merges the
splits in the last block of each group to finish.  This script builds two
extra copies of the source, each undoing one choice:

* ``ring``: the rows stream through a per-warp ``cp.async`` ring of
  shared-memory stages instead, one slot folded at a time;
* ``two_launch``: a second kernel merges the splits;

and runs each, beside the shipped source, at splits 1, 2, 4, 8 and the
wrapper's choice (``decode_splits``), on the RLHF path's [8, 1, 20, 128] x
W 256 with ragged per-lane lengths and with ring-buffer masks, GQA 40/8 at
W 4096 ragged, and W 1000 under one shared mask.  For each it prints the
max abs error against the plain version, whether two calls agree bitwise,
``ms`` (CUDA events over back-to-back launches from preallocated buffers:
the device time plus the gaps between launches) and ``call_ms`` (the same
through a Python call that allocates the output and the workspace, as the
wrapper does: where it exceeds ``ms``, the host paces the calls), with the
card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.decode_variants [--out f.json]

With ``--bf16`` it times the bf16 kernels instead: the shipped one
(``csrc/decode_attention_bf16.cu``: a cluster of blocks a group, TMA-fed
64-slot tiles, the scores and P V on ``mma.sync``, the ranks merged through
distributed shared memory) at ``bf16_decode_plan``'s cluster and stages,
beside the design it replaced, ``variants/decode_attention_bf16_simt.cu``
(never linked into the package's library; its splits from
``decode_splits`` and its workspace and tickets allocated as that design's
wrapper did), and SDPA at bf16 with the same mask, at every bf16 decode
shape of ``chip_smoke.py``'s phase 3 (``BF16_CASES``: the serve steps of
Jamba and Nemotron-4, the RLHF path's shapes, GQA 40/8 at W 4,096 and
1,000, and the decode steps of Qwen1.5-32B, MusicGen and LLaVA-NeXT).  For
each design it prints ``device_ms`` (the profiler's device time of its
kernels a call), the host microseconds a launch and a wrapper call take
(the host clock over calls that only enqueue), ``ms`` (CUDA events over back-to-back launches from
preallocated buffers, the designs in turns, twice, in both orders),
``call_ms`` (a Python call that allocates what the design's wrapper
allocates: for the shipped kernel ``decode_attention_cuda`` itself, whose
per-call host work includes encoding the two tensor maps), the max abs
error against the plain version, its largest error over ``chip_smoke.py``'s
per-row gate (2^-7 x (min(row max, 1) + |x|)) and whether two calls agree
bitwise, with the card's name and power limit.  With ``--sweep`` it adds the
shipped kernel at clusters of 1, 2, 4, 8 and 16 blocks (16 is past the
portable limit: the launch asks for non-portable cluster sizes).

    PYTHONPATH=src python -m repro_torch.kernels.decode_variants --bf16 [--sweep] [--serve] [--out f.json]

The SIMT design's ``call_ms`` and host microseconds go through
``simt_wrapper``: the shipped wrapper's own operand checks, then what that
design's wrapper allocated.  With ``--serve`` it also runs the bf16 decode
steps of Jamba and Nemotron-4 as ``chip_smoke.py``'s phase 21e does, with
the shipped kernel and with the SIMT design routed in, in turns: host ms a
step, the device busy ms of one profiled step and its decode kernel's ms
(``serve_steps``).

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    DECODE_ATTENTION_BF16_LAUNCHES,
    _operands,
    bf16_decode_plan,
    decode_attention_cuda,
    decode_attention_plain,
    decode_splits,
)

# The ring: cp.async helpers and a walk that folds one slot at a time from a
# per-warp ring of stages in shared memory, each [2][32 * CHUNKS] float4 (K
# row, V row), a slot's copy issued STAGES - 1 slots before it is folded.
RING_WALK = """
__host__ __device__ constexpr int ring_stages(int chunks) { return chunks == 1 ? 8 : 4; }

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d), "l"(src));
}

template <int HEADS, int CHUNKS>
__device__ __forceinline__ void walk_ring(SlotCursor& cur, const float* kb, const float* vb,
                                          size_t slot_stride, int nchunk, int lane,
                                          const float4 (*qs)[32 * CHUNKS],
                                          float4 (&acc)[HEADS][CHUNKS], float (&m)[HEADS],
                                          float (&l)[HEADS], int nh, float scale, float4* ring) {
  constexpr int STAGES = ring_stages(CHUNKS);
  constexpr int ROW = 32 * CHUNKS;
  int slot[STAGES];
  auto issue = [&](int st, int s) {
    if (s >= 0) {
      const float4* kw = reinterpret_cast<const float4*>(kb + static_cast<size_t>(s) * slot_stride);
      const float4* vw = reinterpret_cast<const float4*>(vb + static_cast<size_t>(s) * slot_stride);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int ci = lane + 32 * c;
        if (ci < nchunk) {
          cp_async16(ring + (st * 2) * ROW + ci, kw + ci);
          cp_async16(ring + (st * 2 + 1) * ROW + ci, vw + ci);
        }
      }
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  };
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    slot[st] = cur.next(lane);
    issue(st, slot[st]);
  }
  for (;;) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      asm volatile("cp.async.wait_group %0;\\n" ::"n"(STAGES - 1) : "memory");
      __syncwarp();
      if (slot[st] < 0) return;
      float4 kr[1][CHUNKS], vr[1][CHUNKS];
      const bool on[1] = {true};
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int ci = lane + 32 * c;
        kr[0][c] = ci < nchunk ? ring[(st * 2) * ROW + ci] : zero4();
        vr[0][c] = ci < nchunk ? ring[(st * 2 + 1) * ROW + ci] : zero4();
      }
      fold<HEADS, CHUNKS, 1>(qs, lane, kr, vr, on, acc, m, l, nh, scale);
      __syncwarp();
      slot[st] = cur.next(lane);
      issue(st, slot[st]);
    }
  }
}

"""
RING_LAUNCH = """// Dynamic shared memory of the ring, allowed once per kernel (a refusal
// shows as the launch's error).
template <int HEADS, int CHUNKS>
size_t ring_smem() {
  const size_t bytes = sizeof(float4) * kWarps * ring_stages(CHUNKS) * 2 * 32 * CHUNKS;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<HEADS, CHUNKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  (void)attr;
  return bytes;
}

"""
# The second kernel that merges the splits, one block per group.
COMBINE = """__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ work, float* __restrict__ out, int H, int KV,
                          int D, int splits, int heads) {
  const int g = H / KV;
  const int chunks = (g + heads - 1) / heads;
  const int chunk = blockIdx.x % chunks;
  const int pair = blockIdx.x / chunks;
  const int head0 = chunk * heads;
  merge_splits(work + static_cast<size_t>(pair) * splits * g * (D + 2),
               out + static_cast<size_t>(pair) * g * D, splits, g, head0, min(heads, g - head0), D);
}

"""
MERGE = "// Merge the splits' states of one group"
LAUNCH = "template <int HEADS, int CHUNKS, typename Elt>\ncudaError_t launch("
WALK = """  walk_registers<HEADS, CHUNKS>(cur, k + first, v + first, slot_stride, nchunk, lane, s_q, acc, m,
                                l, nh, scale);"""
GRID = "<<<static_cast<unsigned>(groups * splits), kThreads, 0,"
LAUNCH_END = "  return cudaGetLastError();\n}\n\ntemplate <int CHUNKS, typename Elt>"
# Each variant: (text in the source, its replacement) pairs.
VARIANTS = {
    "shipped": [],
    "ring": [
        (MERGE, RING_WALK + MERGE),
        (WALK, """  extern __shared__ float4 s_ring[];
  walk_ring<HEADS, CHUNKS>(cur, k + first, v + first, slot_stride, nchunk, lane, s_q, acc, m, l,
                           nh, scale, s_ring + warp * ring_stages(CHUNKS) * 2 * 32 * CHUNKS);"""),
        (LAUNCH, RING_LAUNCH + LAUNCH),
        (GRID, "<<<static_cast<unsigned>(groups * splits), kThreads, ring_smem<HEADS, CHUNKS>(),"),
    ],
    "two_launch": [
        ("  if (splits == 1) return;", "  return;  // decode_combine_kernel merges the splits"),
        (LAUNCH, COMBINE + LAUNCH),
        (LAUNCH_END, """  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_combine_kernel<<<static_cast<unsigned>(groups), kThreads, 0, stream>>>(work, out, H, KV,
                                                                                D, splits, HEADS);
  return cudaGetLastError();
}

template <int CHUNKS, typename Elt>"""),
    ],
}
# B, H, KV, D, W, mask
CASES = ((8, 20, 20, 128, 256, "ragged"), (8, 20, 20, 128, 256, "ring"),
         (8, 40, 8, 128, 4096, "ragged"), (8, 40, 8, 128, 1000, "shared"))
SPLITS = (0, 1, 2, 4, 8)  # 0: decode_splits' choice
TOL = 1e-5


def _build(name: str, edits: list) -> ctypes.CDLL:
    text = (build.CSRC_DIR / "decode_attention.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"decode_attention.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"decode_{name}.cu"
    lib_path = build.BUILD_DIR / f"libdecode_{name}.so"
    src.write_text(text)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.decode_attention_launch.argtypes = build._SIGNATURES["decode_attention_launch"]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _mask(B: int, W: int, mode: str, g: torch.Generator) -> torch.Tensor:
    """"ragged": lane b holds slots [0, len_b); "ring": a ring buffer that
    has wrapped, slots [start_b, start_b + len_b) mod W; "empty_row":
    ragged, lane 1 holds no slot; "shared": one [W] mask, the first
    W - W // 7 slots."""
    pos = torch.arange(W, device="cuda")
    if mode == "shared":
        return pos < W - W // 7
    lens = torch.randint(1, W + 1, (B,), generator=g, device="cuda")
    if mode in ("ragged", "empty_row"):
        valid = pos[None] < lens[:, None]
        if mode == "empty_row":
            valid[1] = False
        return valid
    start = torch.randint(0, W, (B,), generator=g, device="cuda")
    return (pos[None] - start[:, None]) % W < lens[:, None]


def _case(libs: dict, B: int, H: int, KV: int, D: int, W: int, mode: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(W + H)
    q = torch.randn((B, 1, H, D), generator=g, device="cuda")
    kc, vc = (torch.randn((B, W, KV, D), generator=g, device="cuda") for _ in range(2))
    valid = _mask(B, W, mode, g)
    want = decode_attention_plain(q, kc, vc, valid)
    stride = 0 if valid.dim() == 1 else W
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(B * H, dtype=torch.int32, device="cuda")
    out = {}
    for name, lib in libs.items():
        for asked in SPLITS:
            splits = asked or decode_splits(B, KV, H // KV, D, W)
            o = torch.empty_like(q)
            work = torch.empty(B * KV * splits * (H // KV) * (D + 2), device="cuda")

            def launch(o=o, work=work, splits=splits):
                build.check(lib, lib.decode_attention_launch(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), valid.data_ptr(), o.data_ptr(),
                    work.data_ptr(), tickets.data_ptr(), B, W, H, KV, D, stride, splits,
                    1.0 / math.sqrt(D), stream), name)

            def call(splits=splits):
                o = torch.empty_like(q)
                work = torch.empty((B, KV, splits, H // KV, D + 2), device="cuda")
                launch(o, work, splits)
                return o

            launch()
            first = o.clone()
            launch()
            torch.cuda.synchronize()
            key = f"{name} splits={'auto ' if not asked else ''}{splits}"
            out[key] = {
                "err": float((o - want).abs().max()),
                "within_tol": bool(torch.allclose(o, want, atol=TOL, rtol=TOL)),
                "bitwise_repeatable": bool(torch.equal(first, o)),
                "ms": _ms(launch), "call_ms": _ms(call),
            }
    return out


# The bf16 shapes (B, H, KV, D, W, mask): chip_smoke.py's phase-3 bf16
# decode cases, the serve steps of Jamba and Nemotron-4 first, then the
# decode steps of Qwen1.5-32B, MusicGen and LLaVA-NeXT.
_SERVE_W = 512 + 16
BF16_CASES = ((2, 32, 8, 128, _SERVE_W, "shared"), (2, 48, 8, 128, _SERVE_W, "shared"),
              (8, 20, 20, 128, 256, "ragged"), (8, 40, 8, 128, 4096, "ragged"),
              (4, 20, 20, 128, 256, "empty_row"), (8, 40, 8, 128, 1000, "shared"),
              (8, 20, 20, 128, 256, "ring"), (2, 40, 40, 128, _SERVE_W, "shared"),
              (2, 32, 32, 64, _SERVE_W, "shared"), (2, 56, 8, 128, 2880 + _SERVE_W, "shared"))
BF16_ROW_TOL = 2.0 ** -7
SIMT_SOURCE = Path(__file__).resolve().parent / "variants" / "decode_attention_bf16_simt.cu"
SIMT_ENTRY = "decode_attention_bf16_simt_launch"
SWEEP_CLUSTERS = (1, 2, 4, 8, 16)


def _build_simt():
    """The replaced bf16 design's library, bound with the float32 entry
    point's ctypes signature (its parameter list)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libdecode_bf16_simt.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(SIMT_SOURCE),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the SIMT variant:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, SIMT_ENTRY)
    fn.argtypes = build._SIGNATURES["decode_attention_launch"]
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, fn


def simt_wrapper(simt):
    """``decode_attention_cuda`` as it was for the SIMT design: the same
    operand checks (``_operands``), the output and, past one split, the
    splits' workspace allocated and the tickets zeroed per device and
    stream, then one launch of the SIMT kernel."""
    simt_lib, simt_fn = simt

    def call(q, k_cache, v_cache, valid):
        B, W, H, KV, D, row_stride = _operands(q, k_cache, v_cache, valid)
        out = torch.empty_like(q)
        if B == 0 or W == 0:
            return out.zero_()
        g = H // KV
        splits = decode_splits(B, KV, g, D, W)
        device = q.device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            work_ptr = tickets_ptr = None
            if splits > 1:
                work = torch.empty((B, KV, splits, g, D + 2), dtype=torch.float32, device=device)
                work_ptr = work.data_ptr()
                tickets_ptr = build.zeroed_tickets(device, stream, B * H).data_ptr()
            rc = simt_fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                         out.data_ptr(), work_ptr, tickets_ptr, B, W, H, KV, D, row_stride, splits,
                         1.0 / math.sqrt(D), stream)
        build.check(simt_lib, rc, SIMT_ENTRY)
        return out
    return call


def _device_ms(fn, iters: int = 50) -> float:
    """Device ms a call by the profiler: the device time of every kernel
    ``fn`` launches over ``iters`` calls, after a short spin kernel (the
    primer of chip_smoke.py's ``_DeviceProfile``: without it the session
    loses its first kernel's record), which is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(1000)
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    prof.stop()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
             and "spin_kernel" not in e.key)
    return us / iters / 1e3


def _host_us(fn, iters: int = 100) -> float:
    """Host microseconds a call: the host clock over ``iters`` calls that
    only enqueue (the device runs behind), synchronised after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def _row_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over chip_smoke.py's per-row gate for an attention
    output: BF16_ROW_TOL x (min(the row's largest |want|, 1) + |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    m = want.abs().amax(-1, keepdim=True).clamp(max=1.0)
    limit = BF16_ROW_TOL * (m + want.abs())
    return float(torch.where(err > 0, err / limit, torch.zeros_like(err)).max())


def _bf16_case(simt, B: int, H: int, KV: int, D: int, W: int, mode: str, sweep: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(W + H + D)
    q = torch.randn((B, 1, H, D), generator=g, device="cuda").bfloat16()
    kc, vc = (torch.randn((B, W, KV, D), generator=g, device="cuda").bfloat16() for _ in range(2))
    valid = _mask(B, W, mode, g)
    want = decode_attention_plain(q, kc, vc, valid)
    stride = 0 if valid.dim() == 1 else W
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    lib = build.load_library()
    gq = H // KV
    launches, calls, meta = {}, {}, {}

    def shipped(cluster=None):
        plan = bf16_decode_plan(B, KV, gq, D, W, cluster)
        o = torch.empty_like(q)

        def launch():
            build.check(lib, lib.decode_attention_bf16_launch(
                q.data_ptr(), kc.data_ptr(), vc.data_ptr(), valid.data_ptr(), o.data_ptr(), B, W,
                H, KV, D, stride, plan.cluster, plan.stages, scale, stream), "shipped")
            return o
        return plan, launch

    plan, launches["shipped"] = shipped()
    calls["shipped"] = lambda: decode_attention_cuda(q, kc, vc, valid)
    meta["shipped"] = plan._asdict()
    if sweep:
        for c in SWEEP_CLUSTERS:
            name = f"cluster {c}"
            plan_c, launches[name] = shipped(c)
            meta[name] = plan_c._asdict()
    simt_lib, simt_fn = simt
    splits = decode_splits(B, KV, gq, D, W)
    tickets = torch.zeros(B * H, dtype=torch.int32, device="cuda")
    o_simt = torch.empty_like(q)
    work = torch.empty((B, KV, splits, gq, D + 2), device="cuda")

    def simt_launch(o=o_simt, work=work):
        build.check(simt_lib, simt_fn(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), valid.data_ptr(), o.data_ptr(),
            work.data_ptr(), tickets.data_ptr(), B, W, H, KV, D, stride, splits, scale, stream),
            "simt")
        return o

    simt_call = simt_wrapper(simt)
    launches["simt"], calls["simt"] = simt_launch, lambda: simt_call(q, kc, vc, valid)
    meta["simt"] = {"splits": splits}
    mask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    launches["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                               enable_gqa=True)
    out = {}
    for name, launch in launches.items():
        first = launch().clone()
        again = launch()
        torch.cuda.synchronize()
        got = first.transpose(1, 2) if name == "sdpa" else first
        r = {"err": float((got.float() - want.float()).abs().max()), "ms": [], "call_ms": [],
             "device_ms": _device_ms(launch), "launch_host_us": _host_us(launch),
             **meta.get(name, {})}
        if name in calls:
            r["call_host_us"] = _host_us(calls[name])
        if name != "sdpa" or mode != "empty_row":  # SDPA's softmax over an empty row is NaN
            r["err_over_gate"] = _row_ratio(got, want)
        if name != "sdpa":
            r["bitwise_repeatable"] = bool(torch.equal(first, again))
        out[name] = r
    for order in (list(launches), list(launches)[::-1]):
        for name in order:
            out[name]["ms"].append(_ms(launches[name]))
            if name in calls:
                out[name]["call_ms"].append(_ms(calls[name]))
    return out


def main_bf16(smi: str, sweep: bool) -> dict:
    simt = _build_simt()
    results = {}
    for B, H, KV, D, W, mode in BF16_CASES:
        shape = f"[{B}, 1, {H}/{KV}, {D}] W={W} {mode}"
        results[shape] = _bf16_case(simt, B, H, KV, D, W, mode, sweep)
        for name, r in results[shape].items():
            extra = ", ".join(f"{k} {v}" for k, v in r.items()
                              if k in ("cluster", "stages", "blocks", "smem", "splits"))
            gate = f", over the gate {r['err_over_gate']:.3f}" if "err_over_gate" in r else ""
            rep = (f", bitwise repeatable {r['bitwise_repeatable']}"
                   if "bitwise_repeatable" in r else "")
            host = (f", host us a launch {r['launch_host_us']:.2f}"
                    + (f", a wrapper call {r['call_host_us']:.2f}" if "call_host_us" in r else ""))
            print(f"decode bf16 {shape} [{smi}] {name}: device ms {r['device_ms']:.5f}, ms "
                  f"{', '.join(f'{t:.5f}' for t in r['ms'])}"
                  + (f", call_ms {', '.join(f'{t:.5f}' for t in r['call_ms'])}" if r["call_ms"] else "")
                  + f"{host}, err {r['err']:.3e}{gate}{rep}" + (f" ({extra})" if extra else ""),
                  flush=True)
    return results


# The bf16 serve cases whose decode steps run the bf16 decode kernel, as
# chip_smoke.py's phase 21e runs them: 2 layers, MoE at capacity factor 8,
# random bf16 weights from seed 0, a 2 x 512 prompt, then 16 decode steps.
SERVE_MODELS = ("jamba-v0.1-52b", "nemotron-4-15b")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_LAYERS, SERVE_CAPACITY = 2, 512, 16, 2, 8.0
SERVE_TURNS = ("shipped", "simt", "simt", "shipped") * 2


def _profiled_step(step) -> tuple:
    """(device busy ms, ms of the bf16 decode kernels) of one call of
    ``step``, by the profiler, after a short spin kernel that is left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(1000)
    step()
    torch.cuda.synchronize()
    prof.stop()
    busy = attn = 0.0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                and "spin_kernel" not in e.key):
            busy += e.self_device_time_total
            if "decode_bf16_kernel" in e.key or "decode_attention_bf16_simt_kernel" in e.key:
                attn += e.self_device_time_total
    return busy / 1e3, attn / 1e3


def serve_steps(smi: str) -> dict:
    """The bf16 decode step of ``SERVE_MODELS`` with the shipped kernel and
    with the SIMT design routed in (``ops.decode_attention_cuda`` patched so
    that bf16 calls take ``simt_wrapper``), from one prefill, in the turns
    ``SERVE_TURNS`` after one warm run of each: the host ms a step over the
    16 steps (synchronised at both ends), the device busy ms of one
    profiled step (the last) and its decode kernels' ms, the launches of the
    shipped kernel's counter (the SIMT route counts none), and the largest
    difference of the two designs' step logits over max |logits|."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import Model, make_decode_step, make_prefill_step

    routed_simt = simt_wrapper(_build_simt())

    def simt_route(q, k_cache, v_cache, valid):
        if q.dtype == torch.bfloat16:
            return routed_simt(q, k_cache, v_cache, valid)
        return decode_attention_cuda(q, k_cache, v_cache, valid)

    results = {}
    for arch in SERVE_MODELS:
        cfg, _ = cut_layers(get_config(arch), SERVE_LAYERS)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=SERVE_CAPACITY))
        model = Model(cfg)
        g = torch.Generator(device="cuda").manual_seed(0)
        S, steps = SERVE_PROMPT, SERVE_STEPS
        with torch.no_grad():
            params = model.init_params(g)
            tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, S + steps), generator=g,
                                   device="cuda")
            prefill = make_prefill_step(model, window=S + steps)
            decode = make_decode_step(model)
            _, cache0 = prefill(params, {"tokens": tokens[:, :S]})

            def run(design: str, profile_last: bool = False):
                patch = (mock.patch.object(ops, "decode_attention_cuda", simt_route)
                         if design == "simt" else mock.patch.object(ops, "decode_attention_cuda",
                                                                    decode_attention_cuda))
                logits, cache, busy = [], cache0, None
                with patch:
                    before = DECODE_ATTENTION_BF16_LAUNCHES.value
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for i in range(steps - 1):
                        step_logits, cache = decode(params, cache,
                                                    {"tokens": tokens[:, S + i:S + i + 1]})
                        logits.append(step_logits[:, 0])
                    last = {"tokens": tokens[:, S + steps - 1:S + steps]}
                    if profile_last:
                        box = {}

                        def step():
                            box["out"] = decode(params, cache, last)
                        busy = _profiled_step(step)
                        step_logits = box["out"][0]
                    else:
                        step_logits, _ = decode(params, cache, last)
                    logits.append(step_logits[:, 0])
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    launched = DECODE_ATTENTION_BF16_LAUNCHES.value - before
                return torch.stack(logits, 1), seconds / steps * 1e3, busy, launched

            ref = {d: run(d)[0] for d in ("shipped", "simt")}  # warm runs
            scale = float(ref["shipped"].float().abs().max())
            diff = float((ref["shipped"].float() - ref["simt"].float()).abs().max()) / scale
            r = {d: {"step_ms": [], "launches": None} for d in ("shipped", "simt")}
            for design in SERVE_TURNS:
                _, ms, _, launched = run(design)
                r[design]["step_ms"].append(ms)
                r[design]["launches"] = launched
            for design in ("shipped", "simt"):
                _, _, (busy, attn), _ = run(design, profile_last=True)
                r[design].update(device_busy_ms=busy, decode_kernel_ms=attn,
                                 mean_step_ms=sum(r[design]["step_ms"]) / len(r[design]["step_ms"]))
                print(f"serve {arch} bf16 [{smi}] {design}: ms a step "
                      f"{', '.join(f'{t:.4f}' for t in r[design]['step_ms'])} (mean "
                      f"{r[design]['mean_step_ms']:.4f}); one profiled step: device busy "
                      f"{busy:.4f} ms, the decode kernel {attn:.4f} ms; shipped-kernel launches "
                      f"a run {r[design]['launches']}", flush=True)
            print(f"serve {arch} bf16: the designs' step logits differ by at most "
                  f"{diff:.3e} x max |logits| ({scale:.3f})", flush=True)
            results[arch] = {**r, "logits_diff_rel": diff}
        del params, model, cache0, ref
        torch.cuda.empty_cache()
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    ap.add_argument("--bf16", action="store_true", help="time the bf16 designs instead")
    ap.add_argument("--sweep", action="store_true",
                    help="with --bf16, also the shipped kernel at clusters of 1-16 blocks")
    ap.add_argument("--serve", action="store_true",
                    help="with --bf16, also the bf16 serve steps with each design routed in")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    if args.bf16:
        results = main_bf16(smi.stdout.strip(), args.sweep)
        if args.serve:
            results["serve"] = serve_steps(smi.stdout.strip())
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                                 indent=1))
        return
    libs = {name: _build(name, edits) for name, edits in VARIANTS.items()}
    results = {}
    for B, H, KV, D, W, mode in CASES:
        shape = f"[{B}, 1, {H}/{KV}, {D}] W={W} {mode}"
        results[shape] = _case(libs, B, H, KV, D, W, mode)
        for key, r in results[shape].items():
            print(f"decode {shape} {key}: ms {r['ms']:.5f}, call_ms {r['call_ms']:.5f}, "
                  f"err {r['err']:.3e}, within tolerance {r['within_tol']}, "
                  f"bitwise repeatable {r['bitwise_repeatable']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
