"""Time the PPO surrogate kernels' variants on the GPU.

``csrc/surrogate.cu`` picks one thread per row for ``A < kRowsMinA`` (RL
action spaces) and, above it (a language model's vocabulary), tiles [B, A]
in chunks of columns of one row in both directions: the forward keeps a
chunk in registers, writes its partial max and exp sums, and the last block
of each row merges them (an atomic ticket); the backward takes the
forward's saved row logsumexp and entropy and so reads the logits once.
This script builds

* ``shipped``: the source as it is, with the designs it replaced:
  ``variants/surrogate_fwd_rows.cu``'s forward (``block_per_row``: one block
  of 1024 threads per row, a pass for the max and one for the exp sums) and
  ``variants/surrogate_bwd_rows.cu``'s backwards (one block per row
  recomputing the row's statistics): ``three_read`` (a pass for the max,
  one for the exp sums, then the write) and ``two_read`` (one online pass,
  then the write);
* ``fwd_cols_2048`` and ``fwd_cols_8192``: the forward's chunk at 2,048 and
  8,192 columns (the shipped 4,096: ``kFwdVec`` float4s a thread);
* ``fwd_two_launch``: the forward's rows merged by a second kernel instead
  of the last block of each row;
* ``fwd_chunk_major``: the forward's blocks in a one-dimensional grid with a
  row's chunks adjacent, so that neighbouring blocks read neighbouring bytes
  (the shipped grid (B, chunks) starts a chunk of every row first);
* ``fwd_8_blocks_an_sm``: the forward's registers capped for 8 resident
  blocks an SM (``__launch_bounds__(256, 8)``);
* ``thread_per_row`` and ``vocab_design``: the source with the threshold
  forced each way;

runs each at [128, 151936] (the RLHF learner's minibatch at Qwen1.5-4B's
vocabulary), [16, 151937] (rows not 16-byte aligned), [65536, 18], [256, 2]
and [512, 2] (the PPO and APPO learners' minibatches), and prints each
variant's max error against the plain version (forward terms) and autograd
through it (backward, all five gradients), whether two forward calls agree
bitwise, and its forward and backward milliseconds per call: CUDA events
over 20 calls queued behind a spin kernel (so the host's launch rate does
not pace them) after 3 warm-up calls, every variant timed twice, in turns
(shipped first, then the others, then back in reverse order), with the
card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.surrogate_variants [--out f.json]

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.surrogate import ppo_surrogate_plain

THRESHOLD = "constexpr int kRowsMinA = 1024;"
FWD_VEC = "constexpr int kFwdVec = kMapVec;"
TICKET = """    // The last block of the row to finish merges; every block has taken its
    // ticket once the count reaches chunks, so the last resets it.
    __threadfence();
    s_last = atomicAdd(tickets + i, 1u) == static_cast<unsigned>(chunks - 1);
    if (s_last) tickets[i] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
"""
MERGE_KERNEL = """// The variant's second kernel: block i merges row i.
__global__ void __launch_bounds__(kMapThreads) surrogate_fwd_merge_kernel(
    const int64_t* __restrict__ actions, const float* __restrict__ values,
    const float* __restrict__ blp, const float* __restrict__ adv, const float* __restrict__ ret,
    float* __restrict__ pg, float* __restrict__ vf, float* __restrict__ ent,
    float* __restrict__ kl, float* __restrict__ lse, const float* __restrict__ work, int B,
    int A, int chunks, float lo, float hi) {
  __shared__ MergeScratch s_merge;
  const int i = blockIdx.x;
  merge_row(i, A, chunks, work + static_cast<size_t>(i) * chunks * 3,
            work + static_cast<size_t>(B) * chunks * 3 + i, actions, values, blp, adv, ret, pg,
            vf, ent, kl, lse, lo, hi, s_merge);
}

}  // namespace

// Chunks of a row"""
MAP_LAUNCH = """        static_cast<unsigned*>(tickets), A, lo, hi);
  } else {"""
GRID_INDEX = """  const int i = blockIdx.x;  // the row
  const int k = blockIdx.y;  // its chunk
  const int B = gridDim.x;
  const int chunks = gridDim.y;
"""
# Each variant: (text in csrc/surrogate.cu, its replacement) pairs; None
# builds variants/surrogate_bwd_rows.cu, which includes the source as it is.
VARIANTS = {
    "shipped": None,
    "fwd_cols_2048": [(FWD_VEC, "constexpr int kFwdVec = 2;")],
    "fwd_cols_8192": [(FWD_VEC, "constexpr int kFwdVec = 8;")],
    "fwd_two_launch": [
        (TICKET, "  }\n  return;  // surrogate_fwd_merge_kernel merges the rows\n"),
        ("}  // namespace\n\n// Chunks of a row", MERGE_KERNEL),
        (MAP_LAUNCH, """        static_cast<unsigned*>(tickets), A, lo, hi);
    surrogate_fwd_merge_kernel<<<B, kMapThreads, 0, st>>>(
        ac, va, bl, ad, re, o_pg, o_vf, o_ent, o_kl, o_lse, static_cast<const float*>(work), B,
        A, chunks, lo, hi);
  } else {"""),
    ],
    "fwd_chunk_major": [
        (GRID_INDEX, "  const int chunks = (A + kFwdCols - 1) / kFwdCols;\n"
                     "  const int i = blockIdx.x / chunks;\n"
                     "  const int k = blockIdx.x % chunks;\n"
                     "  const int B = gridDim.x / chunks;\n"),
        ("surrogate_fwd_map_kernel<<<dim3(B, chunks), kMapThreads, 0, st>>>(",
         "surrogate_fwd_map_kernel<<<B * chunks, kMapThreads, 0, st>>>("),
    ],
    "fwd_8_blocks_an_sm": [
        ("__global__ void __launch_bounds__(kMapThreads) surrogate_fwd_map_kernel(",
         "__global__ void __launch_bounds__(kMapThreads, 8) surrogate_fwd_map_kernel("),
    ],
    "thread_per_row": [(THRESHOLD, "constexpr int kRowsMinA = 1 << 30;")],
    "vocab_design": [(THRESHOLD, "constexpr int kRowsMinA = 1;")],
}
ROWS_SOURCE = Path(__file__).resolve().parent / "variants" / "surrogate_bwd_rows.cu"
ROWS_DESIGNS = {"three_read": 0, "two_read": 1}
SHAPES = ((128, 151936), (16, 151937), (65536, 18), (256, 2), (512, 2))
CLIP = 0.2
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's clock: longer than enqueueing a round


def _build(name: str, edits) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / f"libsurrogate_{name}.so"
    if edits is None:
        src = ROWS_SOURCE
    else:
        text = (build.CSRC_DIR / "surrogate.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"surrogate.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        src = build.BUILD_DIR / f"surrogate_{name}.cu"
        src.write_text(text)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ppo_surrogate_fwd_launch", "ppo_surrogate_bwd_launch", "ppo_surrogate_fwd_chunks"):
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    if edits is None:
        # The fwd signature without work and tickets; the bwd signature
        # without lse and ent, then `online`.
        lib.ppo_surrogate_fwd_rows_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_void_p])
        lib.ppo_surrogate_bwd_rows_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_void_p])
        lib.ppo_surrogate_fwd_rows_launch.restype = ctypes.c_int
        lib.ppo_surrogate_bwd_rows_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, iters: int = 20) -> float:
    """Milliseconds per call by CUDA events, the calls queued behind a spin
    kernel so that they run back to back on the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _launchers(libs: dict, B: int, A: int, logits, actions, values, blp, adv, ret, cots) -> dict:
    """name -> (forward, backward or None, output tensors): each launches one
    design on preallocated buffers."""
    ins = [t.data_ptr() for t in (logits, actions, values, blp, adv, ret)]
    cot_ptrs = [t.data_ptr() for t in cots]
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(B, dtype=torch.int32, device="cuda")
    out = {}
    for name, lib in libs.items():
        terms = torch.empty((5, B), device="cuda")  # pg, vf, ent, kl, lse
        dlogits, drows = torch.empty_like(logits), torch.empty((4, B), device="cuda")
        grads = [dlogits, *drows]
        stats = [terms[4].data_ptr(), terms[2].data_ptr()]  # lse, ent
        work = torch.empty(max(1, B * (3 * lib.ppo_surrogate_fwd_chunks(A) + 1)), device="cuda")

        def fwd(lib=lib, name=name, terms=terms, work=work):
            build.check(lib, lib.ppo_surrogate_fwd_launch(
                *ins, *(t.data_ptr() for t in terms), work.data_ptr(), tickets.data_ptr(), B, A,
                1 - CLIP, 1 + CLIP, stream), name)

        def bwd(lib=lib, name=name, grads=grads, stats=stats):
            build.check(lib, lib.ppo_surrogate_bwd_launch(
                *ins, *stats, *cot_ptrs, *(t.data_ptr() for t in grads), B, A, 1 - CLIP,
                1 + CLIP, stream), name)

        out[name] = (fwd, bwd, terms, grads)
        if VARIANTS[name] is not None:
            continue

        def rows_fwd(lib=lib, terms=terms):
            build.check(lib, lib.ppo_surrogate_fwd_rows_launch(
                *ins, *(t.data_ptr() for t in terms), B, A, 1 - CLIP, 1 + CLIP, stream),
                "block_per_row")

        out["block_per_row"] = (rows_fwd, None, terms, grads)
        for design, online in ROWS_DESIGNS.items():
            def rows_bwd(lib=lib, online=online, design=design, grads=grads):
                build.check(lib, lib.ppo_surrogate_bwd_rows_launch(
                    *ins, *cot_ptrs, *(t.data_ptr() for t in grads), B, A, 1 - CLIP, 1 + CLIP,
                    online, stream), design)

            out[design] = (None, rows_bwd, terms, grads)
    return out


def _shape(libs: dict, B: int, A: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(B + A)
    logits = torch.randn((B, A), generator=g, device="cuda")
    actions = torch.randint(0, A, (B,), generator=g, device="cuda")
    rows = [torch.randn((B,), generator=g, device="cuda") for _ in range(8)]
    values, blp, adv, ret = rows[:4]
    cots = rows[4:]
    xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
    want = ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=CLIP)
    want_grads = torch.autograd.grad(want, xs, grad_outputs=cots)
    want = [t.detach() for t in want]
    runs = _launchers(libs, B, A, logits, actions, values, blp, adv, ret, cots)
    out = {}
    for name, (fwd, bwd, terms, grads) in runs.items():
        r = out[name] = {}
        if fwd is not None:
            fwd()
            first = terms.clone()
            fwd()
            torch.cuda.synchronize()
            r.update(fwd_err=_err(terms[:4], want), fwd_ms=[],
                     fwd_bitwise_repeatable=torch.equal(first, terms))
        if bwd is not None:
            bwd()
            torch.cuda.synchronize()
            r.update(bwd_err=_err(grads, want_grads), bwd_ms=[])
    names = list(runs)
    for order in (names, names[::-1]):
        for name in order:
            fwd, bwd = runs[name][:2]
            if fwd is not None:
                out[name]["fwd_ms"].append(_ms(fwd))
            if bwd is not None:
                out[name]["bwd_ms"].append(_ms(bwd))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("surrogate_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {name: _build(name, edits) for name, edits in VARIANTS.items()}
    results = {}
    for B, A in SHAPES:
        results[f"[{B}, {A}]"] = res = _shape(libs, B, A)
        chunks = libs["shipped"].ppo_surrogate_fwd_chunks(A)
        print(f"surrogate [{B}, {A}]: shipped forward chunks a row {chunks}")
        for name, r in res.items():
            parts = []
            if "fwd_ms" in r:
                parts.append(f"forward {', '.join(f'{t:.5f}' for t in r['fwd_ms'])} ms (err "
                             f"{r['fwd_err']:.3e}, bitwise repeatable "
                             f"{r['fwd_bitwise_repeatable']})")
            if "bwd_ms" in r:
                parts.append(f"backward {', '.join(f'{t:.5f}' for t in r['bwd_ms'])} ms "
                             f"(err {r['bwd_err']:.3e})")
            print(f"surrogate [{B}, {A}] {name}: " + "; ".join(parts))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
