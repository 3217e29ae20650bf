"""Time the PPO surrogate kernels' variants on the GPU.

``csrc/surrogate.cu`` picks one thread per row for ``A < kRowsMinA`` (RL
action spaces) and, above it (a language model's vocabulary), one block per
row for the forward and a map over [B, A] for the backward, which takes the
forward's saved row logsumexp and entropy and so reads the logits once.
This script builds

* ``shipped``: the source as it is, with the backward designs the map
  replaced (``variants/surrogate_bwd_rows.cu``, one block per row
  recomputing the row's statistics): ``three_read`` (a pass for the max,
  one for the exp sums, then the write) and ``two_read`` (one online pass,
  then the write);
* ``thread_per_row`` and ``block_per_row``: the source with the threshold
  forced each way;

runs each at [128, 151936] (the RLHF learner's minibatch at Qwen1.5-4B's
vocabulary), [65536, 18], [256, 2] and [512, 2] (the PPO and APPO learners'
minibatches), and prints each variant's max error against the plain version
(forward terms) and autograd through it (backward, all five gradients), and
its forward and backward milliseconds per call (CUDA events, 20 calls after
3 warm-up), with the card's name and power limit.

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
VARIANTS = {"shipped": None, "thread_per_row": "1 << 30", "block_per_row": "1"}
ROWS_SOURCE = Path(__file__).resolve().parent / "variants" / "surrogate_bwd_rows.cu"
ROWS_DESIGNS = {"three_read": 0, "two_read": 1}
SHAPES = ((128, 151936), (65536, 18), (256, 2), (512, 2))
CLIP = 0.2


def _build(name: str, threshold) -> ctypes.CDLL:
    text = (build.CSRC_DIR / "surrogate.cu").read_text()
    if THRESHOLD not in text:
        raise RuntimeError(f"surrogate.cu no longer holds {THRESHOLD!r}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / f"libsurrogate_{name}.so"
    if threshold is None:
        src = ROWS_SOURCE
    else:
        src = build.BUILD_DIR / f"surrogate_{name}.cu"
        src.write_text(text.replace(THRESHOLD, f"constexpr int kRowsMinA = {threshold};"))
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ppo_surrogate_fwd_launch", "ppo_surrogate_bwd_launch"):
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    if threshold is None:
        # The bwd signature without lse and ent, then `online`.
        lib.ppo_surrogate_bwd_rows_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_void_p])
        lib.ppo_surrogate_bwd_rows_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, iters: int = 20) -> float:
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


def _err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


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
    ins = [t.data_ptr() for t in (logits, actions, values, blp, adv, ret)]
    cot_ptrs = [t.data_ptr() for t in cots]
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        terms = torch.empty((5, B), device="cuda")  # pg, vf, ent, kl, lse
        dlogits, drows = torch.empty_like(logits), torch.empty((4, B), device="cuda")
        grads = [dlogits, *drows]
        stats = [terms[4].data_ptr(), terms[2].data_ptr()]  # lse, ent

        def fwd():
            build.check(lib, lib.ppo_surrogate_fwd_launch(
                *ins, *(t.data_ptr() for t in terms), B, A, 1 - CLIP, 1 + CLIP, stream), name)

        def bwd():
            build.check(lib, lib.ppo_surrogate_bwd_launch(
                *ins, *stats, *cot_ptrs, *(t.data_ptr() for t in grads), B, A, 1 - CLIP,
                1 + CLIP, stream), name)

        fwd()
        bwd()
        torch.cuda.synchronize()
        out[name] = {"fwd_err": _err(terms[:4], want), "bwd_err": _err(grads, want_grads),
                     "fwd_ms": _ms(fwd), "bwd_ms": _ms(bwd)}
        if name != "shipped":
            continue
        for design, online in ROWS_DESIGNS.items():
            def rows_bwd():
                build.check(lib, lib.ppo_surrogate_bwd_rows_launch(
                    *ins, *cot_ptrs, *(t.data_ptr() for t in grads), B, A, 1 - CLIP, 1 + CLIP,
                    online, stream), design)

            rows_bwd()
            torch.cuda.synchronize()
            out[design] = {"bwd_err": _err(grads, want_grads), "bwd_ms": _ms(rows_bwd)}
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
    libs = {name: _build(name, t) for name, t in VARIANTS.items()}
    results = {}
    for B, A in SHAPES:
        results[f"[{B}, {A}]"] = res = _shape(libs, B, A)
        for name, r in res.items():
            fwd = (f"forward {r['fwd_ms']:.5f} ms (err {r['fwd_err']:.3e}), "
                   if "fwd_ms" in r else "")
            print(f"surrogate [{B}, {A}] {name}: {fwd}backward {r['bwd_ms']:.5f} ms "
                  f"(err {r['bwd_err']:.3e})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi.stdout.strip(), "results": results},
                                             indent=1))


if __name__ == "__main__":
    main()
