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

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention_plain, decode_splits

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
# The variants build the float32 kernel alone: the source up to its bf16
# entry point.
BF16_ENTRY = "// The same with q, k/v and out bf16"
# B, H, KV, D, W, mask
CASES = ((8, 20, 20, 128, 256, "ragged"), (8, 20, 20, 128, 256, "ring"),
         (8, 40, 8, 128, 4096, "ragged"), (8, 40, 8, 128, 1000, "shared"))
SPLITS = (0, 1, 2, 4, 8)  # 0: decode_splits' choice
TOL = 1e-5


def _build(name: str, edits: list) -> ctypes.CDLL:
    text = (build.CSRC_DIR / "decode_attention.cu").read_text()
    text = text[:text.index(BF16_ENTRY)]
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
    has wrapped, slots [start_b, start_b + len_b) mod W; "shared": one [W]
    mask, the first W - W // 7 slots."""
    pos = torch.arange(W, device="cuda")
    if mode == "shared":
        return pos < W - W // 7
    lens = torch.randint(1, W + 1, (B,), generator=g, device="cuda")
    if mode == "ragged":
        return pos[None] < lens[:, None]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
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
