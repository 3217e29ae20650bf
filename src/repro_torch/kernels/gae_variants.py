"""Time the GAE kernel's scan orders on the GPU.

``csrc/gae.cu`` stages a panel of columns in shared memory and scans each
column with a warp there (``csrc/reverse_scan.cuh``).  This script builds

* ``serial``: the same staging with one thread per column walking the rows
  in the reference's order (``variants/gae_serial_scan.cu``);
* ``warp``: ``csrc/gae.cu`` as it ships (a warp per column, each lane's
  piece of rows composed into an affine map, the maps scanned across the
  warp);
* ``thread_per_column``: the kernel the panels replaced
  (``variants/gae_thread_per_column.cu``: one thread per column loading
  r, v and d from global memory at every step);

runs each at the paths' shapes, CartPole's [64, 8], PPO-LM's [32, 8] and an
APPO rollout's [32, 4], and at [128, 4096] and [1000, 4], and prints each
one's max error against the plain version, whether two calls agree bitwise,
and its milliseconds per call: CUDA events over 200 calls queued behind a
spin kernel (so the host's launch rate does not pace them), each design
timed twice in turns (serial, warp, thread_per_column, then the reverse),
with the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.gae_variants [--out f.json]

Needs a CUDA device and nvcc; the libraries are built under
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
from repro_torch.rl.advantages import gae

_VARIANT_DIR = Path(__file__).resolve().parent / "variants"
# name -> (source, entry point); each entry point takes gae_launch's arguments.
VARIANTS = {
    "serial": (_VARIANT_DIR / "gae_serial_scan.cu", "gae_serial_scan_launch"),
    "warp": (build.CSRC_DIR / "gae.cu", "gae_launch"),
    "thread_per_column": (_VARIANT_DIR / "gae_thread_per_column.cu",
                          "gae_thread_per_column_launch"),
}
SHAPES = ((64, 8), (32, 8), (32, 4), (128, 4096), (1000, 4))
GAMMA, LAM = 0.99, 0.95
TOL = 1e-5
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's clock: longer than enqueueing 200 calls


def build_variant(name: str, src: Path, entry: str, like: str = "gae_launch") -> tuple:
    """The variant's library and its entry point, which takes the arguments
    of the library's entry point ``like``; prints ptxas's registers, stack
    and spills of its kernels."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / f"lib{like.removesuffix('_launch')}_{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-shared", "-o", str(lib_path),
         str(src), str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"{name} ptxas: {ln.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = build._SIGNATURES[like]
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, fn


def queued_ms(fn, iters: int = 200) -> float:
    """Milliseconds per call by CUDA events, the calls queued behind a spin
    kernel so that they run back to back on the device."""
    for _ in range(10):
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


def _shape(libs: dict, T: int, B: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(T * 10_000 + B)
    r = torch.randn((T, B), generator=g, device="cuda")
    v = torch.randn((T, B), generator=g, device="cuda")
    d = (torch.rand((T, B), generator=g, device="cuda") < 0.1).float()
    last = torch.randn((B,), generator=g, device="cuda")
    want = gae(r, v, d, last, gamma=GAMMA, lam=LAM)
    stream = torch.cuda.current_stream().cuda_stream
    runs, out = {}, {}
    for name, (lib, fn) in libs.items():
        adv, ret = torch.empty_like(r), torch.empty_like(r)

        def launch(lib=lib, fn=fn, name=name, adv=adv, ret=ret):
            build.check(lib, fn(r.data_ptr(), v.data_ptr(), d.data_ptr(), last.data_ptr(),
                                adv.data_ptr(), ret.data_ptr(), T, B, GAMMA, GAMMA * LAM, stream),
                        name)

        launch()
        first = (adv.clone(), ret.clone())
        launch()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip((adv, ret), want))
        out[name] = {
            "err": err,
            "within_tol": all(bool(torch.allclose(a, b, atol=TOL, rtol=TOL))
                              for a, b in zip((adv, ret), want)),
            "bitwise_repeatable": torch.equal(first[0], adv) and torch.equal(first[1], ret),
            "ms": [],
        }
        runs[name] = launch
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            out[name]["ms"].append(queued_ms(runs[name]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gae_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {name: build_variant(name, *spec) for name, spec in VARIANTS.items()}
    results = {}
    for T, B in SHAPES:
        results[f"[{T}, {B}]"] = res = _shape(libs, T, B)
        for name, r in res.items():
            print(f"gae [{T}, {B}] {name}: ms {', '.join(f'{t:.6f}' for t in r['ms'])}, "
                  f"err {r['err']:.3e}, within tolerance {r['within_tol']}, "
                  f"bitwise repeatable {r['bitwise_repeatable']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
