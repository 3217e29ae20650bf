"""Measure the design choices of the grouped-matmul kernels against the
variants they were chosen over, on the GPU.

``csrc/moe_gmm.cu`` multiplies in 3xTF32 with wgmma, sums each K tile of 32
from zero before adding it to an fp32 running sum, and stages K tiles in a
ring of 4 shared-memory buffers.  This script builds extra copies of the
source, each changing one choice:

* ``one_accumulator``: every product sums its whole contraction in the
  wgmma accumulator (no running sum);
* ``stages3``: a ring of 3 stages;
* ``one_tf32``: one TF32 product (big * big) instead of three, which the
  port's tolerance does not allow: the share of the time that the two
  extra products take;
* ``products_only``: no split of B and constant A fragments, so only the
  main loop's copies, barriers and products are left: what the tensor
  cores' wgmma rate in this loop allows (wrong results);

and runs each beside the shipped source on the Phi-3.5-MoE pretraining
path's products: the forward, dX and dW at [20480, 4096] x [16, 4096, 6400]
(up and gate) and the forward at [20480, 6400] x [16, 6400, 4096] (down),
16 groups of 1,280 rows.  It prints, for each, the milliseconds per call
(CUDA events, after 2 warm-up calls, in three rounds over the variants), the
max abs error against a float64 loop over the groups, and whether the
result is within the port's ``GMM_TOL`` (1e-4, atol = rtol) of the float32
loop over the groups, the plain version ``chip_smoke.py`` holds the kernels
to.

    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm_variants [--out f.json]

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``, one nvcc each, all at once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gmm import (
    _offsets,
    moe_gmm_dw_plain,
    moe_gmm_dx_plain,
    moe_gmm_plain,
)

PRODUCTS = """      wgmma_tf32(part, as[s], big, s);
      wgmma_tf32(part, ab[s], small, 1);
      wgmma_tf32(part, ab[s], big, 1);"""
# Each variant: (text in the source, its replacement) pairs.
VARIANTS = {
    "shipped": [],
    "one_accumulator": [
        (PRODUCTS, PRODUCTS.replace("part, ", "acc, ").replace("big, s);", "big, 1);")),
        ("for (int i = 0; i < 64; ++i) acc[i] += part[i];", "(void)0;"),
    ],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "one_tf32": [(PRODUCTS, "      wgmma_tf32(part, ab[s], big, s);")],
    "products_only": [
        ("for (int i = 0; i < kBN * kBK / 4 / kThreads; ++i) {", "for (int i = 0; i < 0; ++i) {"),
        ("split(As[TA::at(row + 8 * (c & 1), 8 * s + t + 4 * (c >> 1))], ab[s][c], as[s][c]);",
         "split(static_cast<float>(4 * s + c), ab[s][c], as[s][c]);"),
    ],
}
GROUPS, ROWS = 16, 1280  # the path's experts and rows per expert
SHAPES = (("forward", 4096, 6400), ("dx", 4096, 6400), ("dw", 4096, 6400), ("forward", 6400, 4096))
GMM_TOL = 1e-4
ITERS, ROUNDS = 5, 3


def _source(edits: list) -> str:
    text = (build.CSRC_DIR / "moe_gmm.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"moe_gmm.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def _build_all() -> dict:
    """Every variant's library, one nvcc each, all at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = build.BUILD_DIR / f"moe_gmm_{name}.cu"
        src.write_text(_source(edits))
        lib_path = build.BUILD_DIR / f"libmoe_gmm_{name}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
             str(build.CSRC_DIR / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"variant {name}: registers {regs}, spill stores {spills} (bytes, by kernel)")
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("moe_gmm_launch", "moe_gmm_dx_launch", "moe_gmm_dw_launch"):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _ms(fn) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _case(libs: dict, product: str, D: int, F: int) -> dict:
    """One product at [GROUPS * ROWS, D] x [GROUPS, D, F] for every variant:
    inputs as chip_smoke.py's (x, dy N(0, 1), w N(0, 1/D), dy scaled by
    1/sqrt(ROWS) for dW)."""
    T = GROUPS * ROWS
    g = torch.Generator(device="cuda").manual_seed(D + F)
    x = torch.randn((T, D), generator=g, device="cuda")
    dy = torch.randn((T, F), generator=g, device="cuda")
    w = torch.randn((GROUPS, D, F), generator=g, device="cuda") / math.sqrt(D)
    sizes = torch.full((GROUPS,), ROWS, dtype=torch.int32, device="cuda")
    ends, tile_ends = _offsets(sizes, T)
    stream = torch.cuda.current_stream().cuda_stream
    if product == "forward":
        plain, args = moe_gmm_plain, (x, w)
        out = torch.empty((T, F), device="cuda")
        launch = ("moe_gmm_launch", x, w, ends, tile_ends, out)
    elif product == "dx":
        plain, args = moe_gmm_dx_plain, (dy, w)
        out = torch.empty((T, D), device="cuda")
        launch = ("moe_gmm_dx_launch", dy, w, ends, tile_ends, out)
    else:
        dy = dy / math.sqrt(ROWS)
        plain, args = moe_gmm_dw_plain, (x, dy)
        out = torch.empty((GROUPS, D, F), device="cuda")
        launch = ("moe_gmm_dw_launch", x, dy, ends, out)
    want32 = plain(*args, sizes)
    want64 = plain(*(a.double() for a in args), sizes)
    fn_name, *tensors = launch
    ptrs = [t.data_ptr() for t in tensors]
    calls = {name: (lambda lib=lib, name=name: build.check(
        lib, getattr(lib, fn_name)(*ptrs, T, D, F, GROUPS, stream), name))
        for name, lib in libs.items()}
    results = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        results[name] = {
            "err_vs_fp64": float((out.double() - want64).abs().max()),
            "within_tol": bool(torch.allclose(out, want32, atol=GMM_TOL, rtol=GMM_TOL)),
            "ms": [],
        }
    results["plain_fp32"] = {"err_vs_fp64": float((want32.double() - want64).abs().max())}
    del want32, want64
    for _ in range(ROUNDS):
        for name, call in calls.items():
            results[name]["ms"].append(_ms(call))
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_gmm_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = _build_all()
    results = {}
    for product, D, F in SHAPES:
        shape = f"{product} [{GROUPS * ROWS}, {D}] x [{GROUPS}, {D}, {F}]"
        results[shape] = _case(libs, product, D, F)
        for name, r in results[shape].items():
            ms = r.get("ms")
            timing = f"{sum(ms) / len(ms):.4f} ms per call (rounds {ms}), " if ms else ""
            tol = f", within GMM_TOL of the fp32 loop {r['within_tol']}" if ms else ""
            print(f"moe_gmm {shape} {name}: {timing}err vs fp64 {r['err_vs_fp64']:.3e}{tol}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
