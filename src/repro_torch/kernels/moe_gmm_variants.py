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

With ``--small-variants`` it builds instead copies of
``csrc/moe_gmm_small.cu``, the small-group kernel, each changing one choice:

* ``five_blocks`` / ``six_blocks``: the kernels of at most 2 rows a chunk
  capped for 5 or 6 blocks an SM (48 or 40 registers) instead of 4 (64);
* ``unroll2``: the depth loop unrolled twice, two steps' loads in flight a
  warp;

and times each beside the shipped source at the four decode products below
(2-row groups, block_m 2), checking each within ``GMM_TOL`` of ``torch.bmm``.
As with ``VARIANTS``, the harness stays after its verdict (no variant won at
every product, PERF.md): it is what the recorded times came from, and what a
later redesign of the kernel is timed against.

    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm_variants --small-variants

With ``--sweep`` it runs instead the sweep that sets ``moe_gmm.SMALL_BLOCK_M``,
the largest ``block_m`` that takes the small-group kernel
(``csrc/moe_gmm_small.cu``): at DeepSeek-V2-Lite's and Jamba's decode
products, up [E * G, D] x [E, D, F] and down [E * G, F] x [E, F, D] (E, D, F
= 64, 2048, 1408 and 16, 4096, 14336), at groups of G = 1, 2, 4, ..., 128
rows, it times the small-group kernel at ``block_m`` = G, the 128-row-tile
kernel and ``torch.bmm`` on the same inputs (CUDA events, in three rounds),
checks both kernels within ``GMM_TOL`` of ``torch.bmm``, and prints the
largest G at which the small kernel is faster than the tile kernel at every
product (the crossover).

    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm_variants --sweep [--out f.json]

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
    moe_gmm_cuda,
    moe_gmm_dw_plain,
    moe_gmm_dx_plain,
    moe_gmm_plain,
    moe_gmm_small_cuda,
    small_rows,
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
SMALL_BOUNDS = "__launch_bounds__(kThreads, RMAX <= 2 ? 4 : RMAX <= 8 ? 3 : 2)"
SMALL_LOOP = "#pragma unroll 1\n  for (int d = E::kDepth * warp; d < D; d += kStep) {"
SMALL_VARIANTS = {
    "shipped": [],
    "five_blocks": [(SMALL_BOUNDS, SMALL_BOUNDS.replace("RMAX <= 2 ? 4", "RMAX <= 2 ? 5"))],
    "six_blocks": [(SMALL_BOUNDS, SMALL_BOUNDS.replace("RMAX <= 2 ? 4", "RMAX <= 2 ? 6"))],
    "unroll2": [(SMALL_LOOP, SMALL_LOOP.replace("unroll 1", "unroll 2"))],
}
GROUPS, ROWS = 16, 1280  # the path's experts and rows per expert
SHAPES = (("forward", 4096, 6400), ("dx", 4096, 6400), ("dw", 4096, 6400), ("forward", 6400, 4096))
GMM_TOL = 1e-4
ITERS, ROUNDS = 5, 3
# The sweep: the decode products' (E, D, F), up; down swaps D and F.
SWEEP_SHAPES = {"deepseek-v2-lite": (64, 2048, 1408), "jamba-v0.1": (16, 4096, 14336)}
SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64, 128)
SWEEP_ITERS = 20


def _source(edits: list, source: str = "moe_gmm.cu") -> str:
    text = (build.CSRC_DIR / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{source} no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


ENTRIES = ("moe_gmm_launch", "moe_gmm_dx_launch", "moe_gmm_dw_launch")


def _build_all(variants: dict = VARIANTS, source: str = "moe_gmm.cu",
               entries: tuple = ENTRIES) -> dict:
    """Every variant's library, one nvcc each, all at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = source[:-3]
    procs = {}
    for name, edits in variants.items():
        src = build.BUILD_DIR / f"{stem}_{name}.cu"
        src.write_text(_source(edits, source))
        lib_path = build.BUILD_DIR / f"lib{stem}_{name}.so"
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
        for fn in entries:
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _ms(fn, iters: int = ITERS) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def _sweep_case(E: int, D: int, F: int, rows: int) -> dict:
    """The small-group kernel (block_m = ``rows``), the tile kernel and
    ``torch.bmm`` at [E * rows, D] x [E, D, F], groups of ``rows``: inputs as
    ``_case``'s, ms per call by CUDA events in ``ROUNDS`` rounds, and each
    kernel's max abs error against ``torch.bmm``.  Beside them ``w.sum()``
    (``read_w``), one streamed read of w's bytes, the read rate the card
    reaches on these bytes without a product."""
    g = torch.Generator(device="cuda").manual_seed(rows + D)
    x = torch.randn((E * rows, D), generator=g, device="cuda")
    w = torch.randn((E, D, F), generator=g, device="cuda") / math.sqrt(D)
    sizes = torch.full((E,), rows, dtype=torch.int32, device="cuda")
    calls = {"small": lambda: moe_gmm_small_cuda(x, w, sizes, block_m=rows),
             "tile": lambda: moe_gmm_cuda(x, w, sizes, block_m=128),
             "bmm": lambda: torch.bmm(x.view(E, rows, D), w),
             "read_w": lambda: w.sum()}
    want = calls["bmm"]().view(E * rows, F)
    out = {"shape": [E * rows, D, F, E], "rows": rows,
           "bytes_bound_ms": 4 * (E * rows * (D + F) + E * D * F) / 3.35e12 * 1e3}
    for name in ("small", "tile"):
        got = calls[name]()
        torch.cuda.synchronize()
        out[f"{name}_err"] = float((got - want).abs().max())
        out[f"{name}_within_tol"] = bool(torch.allclose(got, want, atol=GMM_TOL, rtol=GMM_TOL))
    del want, got
    ms = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, call in calls.items():
            ms[name].append(_ms(call, SWEEP_ITERS))
    out.update({f"{name}_ms": sum(v) / len(v) for name, v in ms.items()},
               rounds_ms=ms)
    return out


def small_variants() -> dict:
    """Each of ``SMALL_VARIANTS`` at the four decode products (block_m 2),
    ms per call by CUDA events in ``ROUNDS`` rounds over the variants, and
    its max abs error against ``torch.bmm``."""
    libs = _build_all(SMALL_VARIANTS, "moe_gmm_small.cu", ("moe_gmm_small_launch",))
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for model, (E, D, F) in SWEEP_SHAPES.items():
        for product, (d, f) in (("up", (D, F)), ("down", (F, D))):
            g = torch.Generator(device="cuda").manual_seed(d + f)
            x = torch.randn((2 * E, d), generator=g, device="cuda")
            w = torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)
            ends = torch.arange(2, 2 * E + 1, 2, dtype=torch.int32, device="cuda")
            want = torch.bmm(x.view(E, 2, d), w).view(2 * E, f)
            out = torch.empty_like(want)
            args = (x.data_ptr(), w.data_ptr(), ends.data_ptr(), out.data_ptr(), 2 * E, d, f, E,
                    small_rows(2), stream)
            calls = {name: (lambda lib=lib, name=name: build.check(
                lib, lib.moe_gmm_small_launch(*args), name)) for name, lib in libs.items()}
            case = {}
            for name, call in calls.items():
                call()
                torch.cuda.synchronize()
                case[name] = {"err_vs_bmm": float((out - want).abs().max()), "ms": []}
            for _ in range(ROUNDS):
                for name, call in calls.items():
                    case[name]["ms"].append(_ms(call, SWEEP_ITERS))
            shape = f"{model} {product} [{2 * E}, {d}] x [{E}, {d}, {f}]"
            for name, r in case.items():
                print(f"small variant {name} at {shape}: {sum(r['ms']) / ROUNDS:.4f} ms per call "
                      f"(rounds {r['ms']}), err vs bmm {r['err_vs_bmm']:.2e}", flush=True)
            results[shape] = case
    return results


def sweep() -> dict:
    """``_sweep_case`` at every product and group size, and the crossover:
    the largest group size at which the small kernel beats the tile kernel
    at every product."""
    cases = []
    for model, (E, D, F) in SWEEP_SHAPES.items():
        for product, (d, f) in (("up", (D, F)), ("down", (F, D))):
            for rows in SWEEP_ROWS:
                c = {"model": model, "product": product, **_sweep_case(E, d, f, rows)}
                cases.append(c)
                print(f"sweep {model} {product} {c['shape']} groups of {rows}: small "
                      f"{c['small_ms']:.4f} ms, tile {c['tile_ms']:.4f}, bmm {c['bmm_ms']:.4f}, "
                      f"w.sum() {c['read_w_ms']:.4f}, bytes bound {c['bytes_bound_ms']:.4f}; "
                      f"err vs bmm small "
                      f"{c['small_err']:.2e} tile {c['tile_err']:.2e} (within GMM_TOL "
                      f"{c['small_within_tol']}/{c['tile_within_tol']}); rounds {c['rounds_ms']}",
                      flush=True)
    wins = [rows for rows in SWEEP_ROWS
            if all(c["small_ms"] < c["tile_ms"] for c in cases if c["rows"] == rows)]
    crossover = max((r for r in wins if all(q in wins for q in SWEEP_ROWS if q <= r)), default=0)
    print(f"sweep: the small kernel beats the tile kernel at every product up to groups of "
          f"{crossover} rows (faster at {wins})")
    return {"cases": cases, "small_faster_at": wins, "crossover_rows": crossover}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="run the group-size sweep of the two forward kernels instead")
    ap.add_argument("--small-variants", action="store_true",
                    help="time the small-group kernel's variants instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_gmm_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    if args.sweep or args.small_variants:
        result = sweep() if args.sweep else {"small_variants": small_variants()}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), **result},
                                                 indent=1))
        return
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
