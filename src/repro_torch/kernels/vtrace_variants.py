"""Time the V-trace kernel's scan orders on the GPU.

``csrc/vtrace.cu`` stages a panel of columns in shared memory, scans each
column with a warp there (``csrc/reverse_scan.cuh``) and forms vs and pg_adv
in one write pass.  This script builds

* ``serial``: the same staging and write pass with one thread per column
  walking the rows in the reference's order (``variants/vtrace_serial_scan.cu``);
* ``warp``: ``csrc/vtrace.cu`` as it ships;
* ``thread_per_column``: the kernel the panels replaced
  (``variants/vtrace_thread_per_column.cu``: one thread per column loading
  the five series from global memory at every step);

runs each at the IMPALA learner's [32, 16], IMPALA with 256 lanes' [32, 512],
and at [64, 16], [128, 16], [128, 4096], [1000, 4] and [33, 1001] (clips
1.0 / 1.0), and at [1000, 4] with c_clip 1.5 (decays above 1), and prints
each one's max error against the plain version, whether it is within 1e-5,
whether two calls agree bitwise, and its milliseconds per call: CUDA events
over 200 calls queued behind a spin kernel (so the host's launch rate does
not pace them), each design timed twice in turns (serial, warp,
thread_per_column, then the reverse), with the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.vtrace_variants [--out f.json]

Needs a CUDA device and nvcc; the libraries are built under
``kernels/_build/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gae_variants import build_variant, queued_ms
from repro_torch.rl.advantages import vtrace

_VARIANT_DIR = Path(__file__).resolve().parent / "variants"
# name -> (source, entry point); each entry point takes vtrace_launch's arguments.
VARIANTS = {
    "serial": (_VARIANT_DIR / "vtrace_serial_scan.cu", "vtrace_serial_scan_launch"),
    "warp": (build.CSRC_DIR / "vtrace.cu", "vtrace_launch"),
    "thread_per_column": (_VARIANT_DIR / "vtrace_thread_per_column.cu",
                          "vtrace_thread_per_column_launch"),
}
# (T, B, c_clip); rho_clip 1.0 throughout.  [64, 16] and [128, 16]: longer
# rollouts of the IMPALA learner's width.
CASES = ((32, 16, 1.0), (32, 512, 1.0), (64, 16, 1.0), (128, 16, 1.0), (128, 4096, 1.0),
         (1000, 4, 1.0), (33, 1001, 1.0), (1000, 4, 1.5))
GAMMA, RHO_CLIP = 0.99, 1.0
TOL = 1e-5


def _case(libs: dict, T: int, B: int, c_clip: float) -> dict:
    g = torch.Generator(device="cuda").manual_seed(T * 10_000 + B)
    blp = -2.0 * torch.rand((T, B), generator=g, device="cuda") - 0.05
    tlp = blp + 0.8 * torch.randn((T, B), generator=g, device="cuda")
    tlp.view(-1)[::5] = blp.view(-1)[::5]
    r = torch.randn((T, B), generator=g, device="cuda")
    v = torch.randn((T, B), generator=g, device="cuda")
    d = (torch.rand((T, B), generator=g, device="cuda") < 0.1).float()
    last = torch.randn((B,), generator=g, device="cuda")
    want = vtrace(blp, tlp, r, v, d, last, gamma=GAMMA, rho_clip=RHO_CLIP, c_clip=c_clip)
    stream = torch.cuda.current_stream().cuda_stream
    runs, out = {}, {}
    for name, (lib, fn) in libs.items():
        vs, pg = torch.empty_like(r), torch.empty_like(r)

        def launch(lib=lib, fn=fn, name=name, vs=vs, pg=pg):
            build.check(lib, fn(blp.data_ptr(), tlp.data_ptr(), r.data_ptr(), v.data_ptr(),
                                d.data_ptr(), last.data_ptr(), vs.data_ptr(), pg.data_ptr(), T, B,
                                GAMMA, RHO_CLIP, c_clip, stream), name)

        launch()
        first = (vs.clone(), pg.clone())
        launch()
        torch.cuda.synchronize()
        out[name] = {
            "err": max(float((a - b).abs().max()) for a, b in zip((vs, pg), want)),
            "within_tol": all(bool(torch.allclose(a, b, atol=TOL, rtol=TOL))
                              for a, b in zip((vs, pg), want)),
            "bitwise_repeatable": torch.equal(first[0], vs) and torch.equal(first[1], pg),
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
        raise SystemExit("vtrace_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {name: build_variant(name, src, entry, like="vtrace_launch")
            for name, (src, entry) in VARIANTS.items()}
    results = {}
    for T, B, c_clip in CASES:
        key = f"[{T}, {B}] c_clip {c_clip}"
        results[key] = res = _case(libs, T, B, c_clip)
        for name, r in res.items():
            print(f"vtrace {key} {name}: ms {', '.join(f'{t:.6f}' for t in r['ms'])}, "
                  f"err {r['err']:.3e}, within tolerance {r['within_tol']}, "
                  f"bitwise repeatable {r['bitwise_repeatable']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
