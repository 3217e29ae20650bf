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

With ``--small-split`` it times the float32 small-group kernel at the four
decode products, groups of 1, 2 and 4 rows: D whole and split into the
chunks that fill the last wave (``small_chunks(..., bf16=False)``, the rule
the wrapper takes), and D whole in a second library built from the source
with the split path compiled out of the float32 kernels (``no_f32_split``:
the float32 kernel as it was before it could split), beside ``torch.bmm``,
in rounds of turns, each within ``GMM_TOL`` of ``moe_gmm_plain`` and
bitwise repeatable.

    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm_variants --small-split [--out f.json]

With ``--bf16`` it times the bf16 kernels instead, each design's library
built by its own nvcc, all at once, and none linked into the package's:

* the tile kernel (``csrc/moe_gmm_bf16.cu``: warp-specialised ``wgmma`` on
  TMA-fed, 128-byte-swizzled tiles) as shipped and with 3 or 5 stages or a
  block a tile instead of a persistent grid (``BF16_TILE_VARIANTS``), beside the design it
  replaced, ``variants/moe_gmm_bf16_core_matrices.cu`` (w's tile rewritten
  into core matrices each K tile), and ``torch.bmm``, at DeepSeek-V2-Lite's
  prefill and learner products, Phi-3.5-MoE's and Jamba's prefill products,
  up and down;
* the small-group kernel (``csrc/moe_gmm_small.cu``'s bf16 kernel: the
  full waves' (group, slab) pairs whole, the last wave's split into the
  chunks of D that fill it), the same with the last wave's pairs in 1-4
  chunks, and a persistent grid of equal shares of all the steps
  (``variants/moe_gmm_small_bf16_persistent.cu``, run at its own grid),
  beside the grid it replaced,
  ``variants/moe_gmm_small_bf16_slab_grid.cu`` (a block for each 128-column
  slab and expert), and ``torch.bmm``, at the four decode products
  (2-row groups).

For each it prints the milliseconds a call (CUDA events over back-to-back
calls after warm-up, the designs in turns, ``ROUNDS`` rounds), the max abs
error against ``moe_gmm_plain`` (fp32 sums of the widened operands, rounded
once) and whether it is within the phase-3 gate (2^-7, atol = rtol), and
whether two calls agree bitwise, with the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm_variants --bf16 [--out f.json]

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``, one nvcc each, all at once.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
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
    small_chunks,
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
SMALL_LOOP = "#pragma unroll 1\n  for (int d = d0 + E::kDepth * warp; d < d1; d += kStep) {"
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
            args = (x.data_ptr(), w.data_ptr(), ends.data_ptr(), out.data_ptr(), None, None,
                    2 * E, d, f, E, small_rows(2), 1, stream)
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


# The float32 small-group kernel with its split path compiled out.
NO_F32_SPLIT = {"no_f32_split": [("std::is_same_v<Elt, bf16> || RMAX <= 4;",
                                  "std::is_same_v<Elt, bf16>;")]}
SPLIT_ROWS = (1, 2, 4)


def small_split_times() -> dict:
    """The float32 small-group kernel at the four decode products, groups
    of ``SPLIT_ROWS`` rows (block_m the same): D whole (``unsplit``), split
    into the chunks that fill the last wave (``small_chunks(...,
    bf16=False)``) where there is more than one, and D whole in the library
    built with ``NO_F32_SPLIT``, beside ``torch.bmm``: ms a call by CUDA
    events in ``ROUNDS`` rounds of turns, the max abs error against
    ``moe_gmm_plain`` and whether it is within ``GMM_TOL``, and whether two
    calls agree bitwise."""
    lib = build.load_library()
    no_split = _build_all(NO_F32_SPLIT, "moe_gmm_small.cu", ("moe_gmm_small_launch",))["no_f32_split"]
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for model, (E, D, F) in SWEEP_SHAPES.items():
        for product, (d, f) in (("up", (D, F)), ("down", (F, D))):
            for rows in SPLIT_ROWS:
                g = torch.Generator(device="cuda").manual_seed(d + f + rows)
                x = torch.randn((rows * E, d), generator=g, device="cuda")
                w = torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)
                sizes = torch.full((E,), rows, dtype=torch.int32, device="cuda")
                ends = torch.arange(rows, rows * E + 1, rows, dtype=torch.int32, device="cuda")
                want = moe_gmm_plain(x, w, sizes)
                res = torch.empty_like(want)
                rmax = small_rows(rows)
                picked = small_chunks(x.device, d, f, E, rmax, bf16=False)
                work = torch.empty(picked * rows * E * f, dtype=torch.float32, device="cuda")
                tickets = torch.zeros(E * -(-f // 128), dtype=torch.int32, device="cuda")

                def launch(chunks, lib=lib, x=x, w=w, ends=ends, res=res, work=work,
                           tickets=tickets, d=d, f=f, rows=rows, rmax=rmax):
                    build.check(lib, lib.moe_gmm_small_launch(
                        x.data_ptr(), w.data_ptr(), ends.data_ptr(), res.data_ptr(),
                        work.data_ptr(), tickets.data_ptr(), rows * E, d, f, E, rmax, chunks,
                        stream), "moe_gmm_small_launch")

                calls = {"unsplit": functools.partial(launch, 1),
                         "no_f32_split": functools.partial(launch, 1, lib=no_split)}
                if picked > 1:
                    calls[f"split ({picked} chunks)"] = functools.partial(launch, picked)
                calls["bmm"] = lambda x=x, w=w, rows=rows, d=d: torch.bmm(x.view(E, rows, d), w)
                shape = f"{model} decode {product} [{rows * E}, {d}] x [{E}, {d}, {f}]"
                r = _bf16_case(calls, want, res, SWEEP_ITERS, GMM_TOL)
                bound = 4 * (rows * E * d + E * d * f + rows * E * f) / 3.35e12 * 1e3
                results[shape] = {"bound_ms": bound, "chunks": picked, "rows": rows, "designs": r}
                _print_bf16("small float32", f"{shape} (bound {bound:.6f} ms)", r)
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


_VARIANT_DIR = Path(__file__).resolve().parent / "variants"
TILE_BF16 = build.CSRC_DIR / "moe_gmm_bf16.cu"
SMALL_BF16 = build.CSRC_DIR / "moe_gmm_small.cu"
# The bf16 tile kernel's designs: name -> (source, entry point, edits of the
# source), each entry point taking moe_gmm_bf16_launch's arguments.
BF16_TILE_VARIANTS = {
    "shipped": (TILE_BF16, "moe_gmm_bf16_launch", []),
    "stages3": (TILE_BF16, "moe_gmm_bf16_launch",
                [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]),
    "stages5": (TILE_BF16, "moe_gmm_bf16_launch",
                [("constexpr int kStages = 4;", "constexpr int kStages = 5;")]),
    "block_a_tile": (TILE_BF16, "moe_gmm_bf16_launch",
                     [("const int64_t grid = tiles < sms ? tiles : sms;",
                       "const int64_t grid = tiles;")]),
    "core_matrices": (_VARIANT_DIR / "moe_gmm_bf16_core_matrices.cu",
                      "moe_gmm_bf16_core_matrices_launch", []),
}
# The bf16 small-group kernel's designs, each entry point taking
# moe_gmm_small_bf16_launch's arguments.
BF16_SMALL_VARIANTS = {
    "shipped": (SMALL_BF16, "moe_gmm_small_bf16_launch", []),
    "persistent": (_VARIANT_DIR / "moe_gmm_small_bf16_persistent.cu",
                   "moe_gmm_small_bf16_persistent_launch", []),
    "slab_grid": (_VARIANT_DIR / "moe_gmm_small_bf16_slab_grid.cu",
                  "moe_gmm_small_bf16_slab_grid_launch", []),
}
BF16_ENTRY = {"tile": "moe_gmm_bf16_launch", "small": "moe_gmm_small_bf16_launch"}
# The tile kernel's path products, [T, D] x [E, D, F] (up; down swaps D, F).
BF16_TILE_SHAPES = {"deepseek prefill": (49152, 2048, 1408, 64),
                    "deepseek learner": (61440, 2048, 1408, 64),
                    "phi learner": (20480, 4096, 6400, 16),
                    "jamba prefill": (16384, 4096, 14336, 16)}
BF16_TOL = 2.0 ** -7
BF16_ITERS = {"tile": 10, "small": 50}


def _build_bf16(variants: dict, like: str) -> dict:
    """Every design's library, one nvcc each, all at once; prints each
    one's registers and spills."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, entry, edits) in variants.items():
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{src.name} no longer holds {old!r} once")
            text = text.replace(old, new)
        path = build.BUILD_DIR / f"{src.stem}_bf16_{name}.cu"
        path.write_text(text)
        lib_path = build.BUILD_DIR / f"lib{src.stem}_bf16_{name}.so"
        procs[name] = (entry, lib_path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(path),
             str(build.CSRC_DIR / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (entry, lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        usage = re.findall(r"Compiling entry function '(\w*bf16\w*)'[\s\S]*?"
                           r"(\d+) bytes stack frame, (\d+) bytes spill stores[\s\S]*?"
                           r"Used (\d+) registers", log)
        print(f"variant {name}: " + "; ".join(f"{k[:48]} regs {r} stack {st} spills {sp}"
                                              for k, st, sp, r in usage)
              + (" (ptxas: wgmma serialized)" if "serialized" in log else ""), flush=True)
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, entry)
        fn.argtypes = build._SIGNATURES[like]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, fn)
    return libs


def _bf16_case(calls: dict, want, out, iters: int, tol: float = BF16_TOL) -> dict:
    """Each call of ``calls`` (name -> fn writing ``out``) against ``want``:
    max abs error, within the gate (``tol``, atol = rtol), bitwise equal
    across two calls, and ms a call in ``ROUNDS`` rounds of turns."""
    results = {}
    for name, call in calls.items():
        if name == "bmm":
            results[name] = {"ms": []}
            continue
        out.zero_()
        call()
        first = out.clone()
        call()
        torch.cuda.synchronize()
        results[name] = {
            "max_abs_err": float((first.float() - want.float()).abs().max()),
            "within_gate": bool(torch.allclose(first.float(), want.float(), atol=tol, rtol=tol)),
            "bitwise_repeatable": bool(torch.equal(first, out)), "ms": []}
        del first
    for _ in range(ROUNDS):
        for name, call in calls.items():
            results[name]["ms"].append(_ms(call, iters))
    for r in results.values():
        r["mean_ms"] = sum(r["ms"]) / len(r["ms"])
    return results


def _print_bf16(kind: str, shape: str, results: dict) -> None:
    for name, r in results.items():
        gate = (f", err {r['max_abs_err']:.3e} within gate {r['within_gate']} bitwise "
                f"{r['bitwise_repeatable']}" if "max_abs_err" in r else "")
        print(f"{kind} {shape} {name}: {r['mean_ms']:.5f} ms (rounds "
              f"{[round(m, 5) for m in r['ms']]}){gate}", flush=True)


def bf16_variants() -> dict:
    """The bf16 tile and small-group kernels beside their variants and
    ``torch.bmm`` (see the module's note)."""
    tile_libs = _build_bf16(BF16_TILE_VARIANTS, BF16_ENTRY["tile"])
    small_libs = _build_bf16(BF16_SMALL_VARIANTS, BF16_ENTRY["small"])
    stream = torch.cuda.current_stream().cuda_stream
    out = {"tile": {}, "small": {}}
    for label, (T, D, F, E) in BF16_TILE_SHAPES.items():
        for product, (d, f) in (("up", (D, F)), ("down", (F, D))):
            g = torch.Generator(device="cuda").manual_seed(d + f + T)
            x = torch.randn((T, d), generator=g, device="cuda").bfloat16()
            w = (torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)).bfloat16()
            sizes = torch.full((E,), T // E, dtype=torch.int32, device="cuda")
            ends, tile_ends = _offsets(sizes, T)
            want = moe_gmm_plain(x, w, sizes)
            res = torch.empty_like(want)
            args = (x.data_ptr(), w.data_ptr(), ends.data_ptr(), tile_ends.data_ptr(),
                    res.data_ptr(), T, d, f, E, stream)
            calls = {name: (lambda fn=fn, lib=lib, name=name: build.check(lib, fn(*args), name))
                     for name, (lib, fn) in tile_libs.items()}
            calls["bmm"] = lambda: torch.bmm(x.view(E, T // E, d), w)
            shape = f"{label} {product} [{T}, {d}] x [{E}, {d}, {f}]"
            r = _bf16_case(calls, want, res, BF16_ITERS["tile"])
            bound = max(2 * T * d * f / 989e12, 2 * (T * d + E * d * f + T * f) / 3.35e12) * 1e3
            out["tile"][shape] = {"bound_ms": bound, "designs": r}
            _print_bf16("tile", f"{shape} (bound {bound:.6f} ms)", r)
            del x, w, want, res
    for model, (E, D, F) in SWEEP_SHAPES.items():
        for product, (d, f) in (("up", (D, F)), ("down", (F, D))):
            g = torch.Generator(device="cuda").manual_seed(d + f)
            x = torch.randn((2 * E, d), generator=g, device="cuda").bfloat16()
            w = (torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)).bfloat16()
            sizes = torch.full((E,), 2, dtype=torch.int32, device="cuda")
            ends = torch.arange(2, 2 * E + 1, 2, dtype=torch.int32, device="cuda")
            want = moe_gmm_plain(x, w, sizes)
            res = torch.empty_like(want)
            picked = small_chunks(x.device, d, f, E, small_rows(2), bf16=True)
            work = torch.empty(max(4, picked) * 2 * E * f, dtype=torch.float32, device="cuda")
            tickets = torch.zeros(E * -(-f // 128), dtype=torch.int32, device="cuda")

            def launch(fn, lib, name, chunks):
                build.check(lib, fn(x.data_ptr(), w.data_ptr(), ends.data_ptr(), res.data_ptr(),
                                    work.data_ptr(), tickets.data_ptr(), 2 * E, d, f, E,
                                    small_rows(2), chunks, stream), name)

            lib, fn = small_libs["shipped"]
            calls = {f"shipped ({picked} chunks)": functools.partial(launch, fn, lib, "shipped", picked)}
            calls.update({f"{c} chunks": functools.partial(launch, fn, lib, "shipped", c)
                          for c in (1, 2, 3, 4) if c != picked})
            lib, fn = small_libs["persistent"]
            calls["persistent"] = functools.partial(launch, fn, lib, "persistent", picked)
            lib, fn = small_libs["slab_grid"]
            calls["slab_grid"] = functools.partial(launch, fn, lib, "slab_grid", 1)
            calls["bmm"] = lambda: torch.bmm(x.view(E, 2, d), w)
            shape = f"{model} decode {product} [{2 * E}, {d}] x [{E}, {d}, {f}]"
            r = _bf16_case(calls, want, res, BF16_ITERS["small"])
            bound = 2 * (2 * E * d + E * d * f + 2 * E * f) / 3.35e12 * 1e3
            out["small"][shape] = {"bound_ms": bound, "chunks": picked, "designs": r}
            _print_bf16("small", f"{shape} (bound {bound:.6f} ms)", r)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="run the group-size sweep of the two forward kernels instead")
    ap.add_argument("--small-variants", action="store_true",
                    help="time the small-group kernel's variants instead")
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 tile and small-group kernels' designs instead")
    ap.add_argument("--small-split", action="store_true",
                    help="time the float32 small-group kernel split and unsplit instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_gmm_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    if args.sweep or args.small_variants or args.bf16 or args.small_split:
        result = (sweep() if args.sweep else {"bf16": bf16_variants()} if args.bf16 else
                  {"small_split": small_split_times()} if args.small_split else
                  {"small_variants": small_variants()})
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
