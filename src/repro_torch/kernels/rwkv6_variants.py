"""Time the RWKV-6 kernels on the GPU: a checkout's shipped kernels at the
LM path's shape, the design choices of ``csrc/rwkv6.cu`` against variants,
and the RWKV-6 pretraining step against another checkout.

``csrc/rwkv6.cu`` spreads each (b, h) pair's state over a block of
N * N / 8 threads, stages the forward 32 steps at a time, and walks the
backward back over sub-chunks of 16 steps, recomputing their states 8 at a
time into registers from start states kept in shared memory.  This script:

* times ``rwkv6_fwd_cuda`` and ``rwkv6_bwd_cuda`` (training forward with
  chunk-start states, backward with a final-state gradient) at the RWKV-6
  7B pretraining path's [2, 4096, 64, 64], chunk 64, of the ``repro_torch``
  under ``--src`` (default: this checkout's), by CUDA events and by
  ``torch.profiler``, and tries to read each kernel's device-memory bytes
  from CUPTI's counters through the profiler (``not measured`` where the
  machine refuses them); with ``--src`` pointing at an older checkout's
  ``src/`` (run the script by its path then, so that ``repro_torch`` is
  imported from there) this times the kernels that were there;
* with ``--variants`` (and no ``--src``), builds copies of this checkout's
  source, each changing one choice, and times each beside the shipped one
  (three rounds): ``bwd_sub8`` (sub-chunks of 8 steps, not 16: twice the
  units, each with its barriers, staging and flush), ``bwd_reg4`` (the
  backward holds 4 recomputed states in registers at once, not 8,
  recomputing more of each sub-chunk), and three that give wrong results
  and measure a share of the backward's time: ``bwd_no_shuffle`` (the
  butterflies over lanes for dr, dk, dw and dv without their shuffles),
  ``bwd_no_recompute`` (a sub-chunk's states copied, not recomputed) and
  ``bwd_no_forward_pass`` (no forward pass over a chunk to find its
  sub-chunk start states);
* with ``--ab DIR``, runs ``chip_smoke.phase_pretrain("pretrain_rwkv6")``
  (4 steps of RWKV-6 7B at published widths cut to 2 layers, 2 x 4,096
  tokens) in the checkout DIR and in this one, one process each, in the
  order DIR, this, this, DIR, and prints each run's seconds per step, busy
  device time, peak memory and RWKV-6 kernel time.

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6_variants [--variants] [--ab DIR] \\
        [--out f.json]
    python src/repro_torch/kernels/rwkv6_variants.py --src DIR/src  # an older checkout's

Needs a CUDA device and nvcc; the variants' libraries are built under
``kernels/_build/``, one nvcc each, all at once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
SHAPE = (2, 4096, 64, 64)  # [B, T, H, N] of RWKV-6 7B pretraining, 2 x 4,096 tokens per step
CHUNK = 64
ITERS, ROUNDS = 20, 3
# Each variant: (text in the source, its replacement) pairs.
VARIANTS = {
    "shipped": [],
    "bwd_sub8": [("constexpr int kSub = 16;", "constexpr int kSub = 8;")],
    "bwd_reg4": [("constexpr int kReg = 8;", "constexpr int kReg = 4;")],
    "bwd_no_shuffle": [
        ("__shfl_xor_sync(0xffffffffu, select(upper, lo, hi), kMask)", "select(upper, lo, hi)"),
        ("v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);", "v[0] += v[0];")],
    "bwd_no_recompute": [("advance<N>(S[m], S[m - 1], bk, bw, bv, hs + m - 1, i0, j0);",
                          "copy_tile(S[m], S[m - 1]);")],
    "bwd_no_forward_pass": [("for (int m = 0; m < L; ++m) advance<N>(M, M,",
                             "for (int m = 0; m < 0; ++m) advance<N>(M, M,")],
}
METRICS = ["dram__bytes_read.sum", "dram__bytes_write.sum"]
AB_CODE = """
import json, sys
sys.path.insert(0, "src")
import torch
import chip_smoke
from repro_torch.kernels import advantages, decode_attention, flash_attention, moe_gmm, rwkv6
from repro_torch.kernels import surrogate
from repro_torch.kernels.build import LaunchCounter
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
counters = [x for m in (advantages, surrogate, decode_attention, flash_attention, rwkv6, moe_gmm)
            for x in vars(m).values() if isinstance(x, LaunchCounter)]
out = chip_smoke.phase_pretrain("pretrain_rwkv6", counters)
print("AB_RESULT " + json.dumps(out))
"""


def _inputs(seed: int = 0):
    """r, k, v ~ N(0, 0.25), decays by the model's law at its initial bias,
    u ~ N(0, 0.01), cotangents N(0, 1), as chip_smoke.py's RWKV-6 cases."""
    B, T, H, N = SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (0.5 * randn(B, T, H, N) for _ in range(3))
    w = torch.exp(-torch.exp(torch.clamp(-2.0 + 0.5 * randn(B, T, H, N), -8.0, 2.0)))
    u = 0.1 * randn(H, N)
    return r, k, v, w, u, randn(B, T, H, N), randn(B, H, N, N)


def _events_ms(fn, iters: int = ITERS) -> float:
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


def _profiled(fn, iters: int = ITERS) -> dict:
    """Device ms per record of each kernel ``fn`` launches, by the profiler,
    with a short spin kernel first (the profiler can drop a session's first
    device record; see chip_smoke.py's _DeviceProfile)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "spin_kernel" in e.key or not e.count:
            continue
        out[e.key] = {"ms_per_record": e.self_device_time_total / e.count / 1e3, "records": e.count}
    return out


def _dram_bytes(fn) -> dict:
    """Each kernel's device-memory bytes read and written over one call of
    ``fn``, by CUPTI's range profiler through ``torch.profiler``; a note
    where it gives none (on machines that refuse performance counters)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        cfg = _ExperimentalConfig(profiler_metrics=METRICS, profiler_measure_per_kernel=True)
        with profile(activities=[ProfilerActivity.CUDA], experimental_config=cfg) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
    except Exception as exc:  # the profiler's metric path is experimental
        return {"note": f"not measured: {type(exc).__name__}: {exc}"}
    found = {}
    for e in events:
        args = e.get("args", {})
        if any(m in args for m in METRICS):
            found.setdefault(e.get("name", "?"), []).append({m: args.get(m) for m in METRICS})
    return found or {"note": "not measured: the profiler returned no counter values"}


def _calls(fwd, bwd):
    """The timed calls: the training forward and the backward from its
    chunk-start states."""
    r, k, v, w, u, dout, ds = _inputs()
    _, _, ckpt = fwd(r, k, v, w, u, None, CHUNK, True)
    return (lambda: fwd(r, k, v, w, u, None, CHUNK, True),
            lambda: bwd(r, k, v, w, u, dout, ckpt, ds, CHUNK, False))


def time_shipped(src: Path) -> dict:
    """The kernels of the ``repro_torch`` under ``src`` at the path's shape."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels.rwkv6 import rwkv6_bwd_cuda, rwkv6_fwd_cuda

    fwd, bwd = _calls(rwkv6_fwd_cuda, rwkv6_bwd_cuda)
    out = {}
    for name, fn in (("fwd", fwd), ("bwd", bwd)):
        out[name] = {"call_ms": _events_ms(fn), "profiled": _profiled(fn),
                     "call_ms_after": _events_ms(fn), "dram": _dram_bytes(fn)}
        print(f"rwkv6 {name} {list(SHAPE)} ({src}): {json.dumps(out[name])}")
    return out


def _build_variants() -> dict:
    """Every variant's library, one nvcc each, all at once."""
    from repro_torch.kernels import build

    text = (build.CSRC_DIR / "rwkv6.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"rwkv6.cu no longer holds {old!r} once")
            src = src.replace(old, new)
        path = build.BUILD_DIR / f"rwkv6_{name}.cu"
        path.write_text(src)
        lib_path = build.BUILD_DIR / f"librwkv6_{name}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(path),
             str(build.CSRC_DIR / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        stack = [int(n) for n in re.findall(r"(\d+) bytes stack frame", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"variant {name}: registers {regs}, stack frame {stack}, spill stores {spills} "
              "(bytes, by kernel)")
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("rwkv6_fwd_launch", "rwkv6_bwd_launch"):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_variants() -> dict:
    """Each variant's forward and backward beside the shipped source's, the
    backward's largest distance from the shipped one's gradients."""
    from repro_torch.kernels import build

    libs = _build_variants()
    B, T, H, N = SHAPE
    r, k, v, w, u, dout, ds = _inputs()
    nc = -(-T // CHUNK)
    o, s_out = torch.empty_like(r), torch.empty((B, H, N, N), device="cuda")
    ckpt = torch.empty((B, H, nc, N, N), device="cuda")
    grads = [torch.empty_like(r) for _ in range(4)]
    du_part = torch.empty((B, H, N), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda x: x.data_ptr()  # noqa: E731

    def fwd(lib, name):
        return build.check(lib, lib.rwkv6_fwd_launch(
            *map(ptr, (r, k, v, w, u)), None, ptr(o), ptr(s_out), ptr(ckpt), B, T, H, N, CHUNK,
            stream), name)

    def bwd(lib, name):
        return build.check(lib, lib.rwkv6_bwd_launch(
            *map(ptr, (r, k, v, w, u, dout, ckpt, ds)), *map(ptr, grads), ptr(du_part), None,
            B, T, H, N, CHUNK, stream), name)

    fwd(libs["shipped"], "shipped")
    bwd(libs["shipped"], "shipped")
    torch.cuda.synchronize()
    want_o, want = o.clone(), [g.clone() for g in grads]
    results = {}
    for name, lib in libs.items():
        fwd(lib, name)
        bwd(lib, name)
        torch.cuda.synchronize()
        results[name] = {
            "fwd_err_vs_shipped": float((o - want_o).abs().max()),
            "bwd_err_vs_shipped": max(float((a - b).abs().max()) for a, b in zip(grads, want)),
            "fwd_ms": [], "bwd_ms": []}
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            results[name]["fwd_ms"].append(_events_ms(lambda: fwd(lib, name)))
            results[name]["bwd_ms"].append(_events_ms(lambda: bwd(lib, name)))
    for name, res in results.items():
        print(f"rwkv6 variant {name}: {json.dumps(res)}")
    return results


def ab(other: Path) -> list:
    """``phase_pretrain("pretrain_rwkv6")`` in ``other`` and here, in the
    order other, here, here, other; one process each."""
    runs = []
    for tree in (other, ROOT, ROOT, other):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", AB_CODE], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"pretrain_rwkv6 in {tree} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(line[len("AB_RESULT "):])
        kernels = {k: v for k, v in res["profile"]["port_kernels_ms"].items() if "rwkv6" in k}
        run = {"tree": "other" if tree == other else "this", "path": str(tree),
               "seconds_per_step": res["seconds_per_step"],
               "peak_memory_gib": res["peak_memory_bytes"] / 2**30,
               "device_busy_ms": res["profile"]["device_busy_ms"], "rwkv6_kernels_ms": kernels,
               "launches": res["launches"]}
        runs.append(run)
        print(f"ab {run['tree']}: {run['seconds_per_step']:.4f} s per step, "
              f"busy {run['device_busy_ms']:.1f} ms, peak {run['peak_memory_gib']:.2f} GiB, "
              f"RWKV-6 kernels {json.dumps(kernels)}")
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ whose kernels to time")
    ap.add_argument("--variants", action="store_true", help="also time this source's variants")
    ap.add_argument("--ab", default="", help="A/B the RWKV-6 pretraining step against this checkout")
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rwkv6_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    results = {"device": smi.stdout.strip(), "shipped": time_shipped(Path(args.src).resolve())}
    if args.variants:
        results["variants"] = time_variants()
    if args.ab:
        results["ab"] = ab(Path(args.ab).resolve())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
