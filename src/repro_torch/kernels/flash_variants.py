"""Measure the design choices of the flash-attention kernels against the
variants they replaced, on the GPU.

``csrc/flash_attention.cu`` splits each operand into a TF32 big part
(rounded with two integer operations) and an fp32 remainder, and each
product sums one tile in its own tensor-core accumulators before adding it
to the running sum in fp32.  This script builds two extra copies of the
source, each undoing one choice:

* ``cvt_split``: both parts by ``cvt.rna.tf32.f32`` (four SASS instructions
  each on an H100);
* ``one_accumulator``: every product sums its whole contraction, across
  tiles, in one tensor-core accumulator;

and runs them beside the shipped source at the learner's [128, 256, 20, 128]
and Phi-3.5-MoE's [2, 4096, 32/8, 128] causal shapes.  It prints, for each,
the forward and backward milliseconds per call (CUDA events, after 3
warm-up calls), the max abs error of the output and of dQ, dK, dV against the
plain version and autograd through it, and whether they are within the
port's tolerances (1e-5 and 1e-4, atol = rtol); then the same errors and
times for ``scaled_dot_product_attention``, for scale.

    PYTHONPATH=src python -m repro_torch.kernels.flash_variants [--out f.json]

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
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_plain

SPLIT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));"""
# Each variant: (text in the source, its replacement) pairs.
VARIANTS = {
    "shipped": [],
    "cvt_split": [(SPLIT, CVT_SPLIT)],
    "one_accumulator": [
        ("mma_3xtf32(s[n], small[n], ab, as, bb, bs);", "mma_3xtf32(s[n], s[n], ab, as, bb, bs);"),
        ("mma_3xtf32(big, small, ab[kk], as[kk], bb, bs);",
         "mma_3xtf32(acc[n], acc[n], ab[kk], as[kk], bb, bs);"),
    ],
}
SHAPES = ((128, 256, 20, 20, 128, 20, 10), (2, 4096, 32, 8, 128, 10, 4))  # B, S, H, KV, D, calls fwd, bwd
TOL, GRAD_TOL = 1e-5, 1e-4


def _build(name: str, edits: list) -> ctypes.CDLL:
    text = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_attention.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"flash_{name}.cu"
    lib_path = build.BUILD_DIR / f"libflash_{name}.so"
    src.write_text(text)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("flash_attention_fwd_launch", "flash_attention_bwd_launch"):
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(out, grads, want_out, want_grads) -> dict:
    return {
        "out_err": float((out - want_out).abs().max()),
        "grad_err": max(float((a - b).abs().max()) for a, b in zip(grads, want_grads)),
        "within_tol": bool(torch.allclose(out, want_out, atol=TOL, rtol=TOL))
        and all(torch.allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL) for a, b in zip(grads, want_grads)),
    }


def _case(libs: dict, B: int, S: int, H: int, KV: int, D: int, fwd_iters: int, bwd_iters: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for shape in
               ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    dout = torch.randn((B, S, H, D), generator=g, device="cuda")
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = flash_attention_plain(*xs, causal=True)
    want_grads = torch.autograd.grad(want_out, xs, dout)
    want_out = want_out.detach()
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    out = {}
    for name, lib in libs.items():
        o, lse = torch.empty_like(q), torch.empty((B, H, S), device="cuda")
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty((B, H, S), device="cuda")

        def fwd():
            build.check(lib, lib.flash_attention_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, S, S, H, KV, D, 1, 0, 0, scale, stream), name)

        def bwd():
            build.check(lib, lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads),
                B, S, S, H, KV, D, 1, 0, 0, scale, stream), name)

        fwd()
        bwd()
        torch.cuda.synchronize()
        out[name] = {**_errors(o, grads, want_out, want_grads),
                     "fwd_ms": _ms(fwd, fwd_iters), "bwd_ms": _ms(bwd, bwd_iters)}
    qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    sdpa_grads = torch.autograd.grad(sdpa, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True)
    out["sdpa"] = {
        **_errors(sdpa.transpose(1, 2), [t.transpose(1, 2) for t in sdpa_grads], want_out, want_grads),
        "fwd_ms": _ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True), fwd_iters),
        "bwd_ms": _ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dout.transpose(1, 2),
                                                  retain_graph=True), bwd_iters),
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {name: _build(name, edits) for name, edits in VARIANTS.items()}
    results = {}
    for B, S, H, KV, D, fwd_iters, bwd_iters in SHAPES:
        shape = f"[{B}, {S}, {H}/{KV}, {D}]"
        results[shape] = _case(libs, B, S, H, KV, D, fwd_iters, bwd_iters)
        for name, r in results[shape].items():
            print(f"flash {shape} {name}: forward {r['fwd_ms']:.4f} ms, backward {r['bwd_ms']:.4f} ms, "
                  f"out err {r['out_err']:.3e}, grad err {r['grad_err']:.3e}, "
                  f"within tolerance {r['within_tol']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results}, indent=1))


if __name__ == "__main__":
    main()
