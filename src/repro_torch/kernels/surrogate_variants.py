"""Time both variants of the PPO surrogate kernels on both sides of their
selection threshold, on the GPU.

``csrc/surrogate.cu`` picks one thread per row for ``A < kRowsMinA`` (RL
action spaces) and one block per row above it (a language model's
vocabulary).  This script builds two extra copies of the source with the
threshold forced each way, runs each at [128, 151936] (the RLHF learner's
minibatch at Qwen1.5-4B's vocabulary), [65536, 18] and [256, 2], and prints
each variant's max error against the plain version and its forward and
backward milliseconds per call (CUDA events, 20 calls after 3 warm-up).

    PYTHONPATH=src python -m repro_torch.kernels.surrogate_variants

Needs a CUDA device and nvcc; the extra libraries are built under
``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.surrogate import ppo_surrogate_plain

THRESHOLD = "constexpr int kRowsMinA = 1024;"
VARIANTS = {"thread_per_row": "1 << 30", "block_per_row": "1"}
SHAPES = ((128, 151936), (65536, 18), (256, 2))


def _build(name: str, threshold: str) -> ctypes.CDLL:
    text = (build.CSRC_DIR / "surrogate.cu").read_text()
    if THRESHOLD not in text:
        raise RuntimeError(f"surrogate.cu no longer holds {THRESHOLD!r}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"surrogate_{name}.cu"
    lib_path = build.BUILD_DIR / f"libsurrogate_{name}.so"
    src.write_text(text.replace(THRESHOLD, f"constexpr int kRowsMinA = {threshold};"))
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src),
         str(build.CSRC_DIR / "errors.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ppo_surrogate_fwd_launch", "ppo_surrogate_bwd_launch"):
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("surrogate_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {name: _build(name, t) for name, t in VARIANTS.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, A in SHAPES:
        logits = torch.randn((B, A), generator=g, device="cuda")
        actions = torch.randint(0, A, (B,), generator=g, device="cuda")
        rows = [torch.randn((B,), generator=g, device="cuda") for _ in range(8)]
        values, blp, adv, ret = rows[:4]
        cots = rows[4:]
        want = ppo_surrogate_plain(logits, values, actions, blp, adv, ret)
        ptrs = [t.data_ptr() for t in (logits, actions, values, blp, adv, ret)]
        for name, lib in libs.items():
            terms = torch.empty((4, B), device="cuda")
            dlogits, drows = torch.empty_like(logits), torch.empty((4, B), device="cuda")

            def fwd():
                return lib.ppo_surrogate_fwd_launch(
                    *ptrs, *(t.data_ptr() for t in terms), B, A, 0.8, 1.2, stream)

            def bwd():
                return lib.ppo_surrogate_bwd_launch(
                    *ptrs, *(t.data_ptr() for t in cots), dlogits.data_ptr(),
                    *(t.data_ptr() for t in drows), B, A, 0.8, 1.2, stream)

            build.check(lib, fwd(), name)
            torch.cuda.synchronize()
            err = max(float((got - w).abs().max()) for got, w in zip(terms, want))
            print(f"surrogate [{B}, {A}] {name}: forward max abs err {err:.3e}, "
                  f"forward {_ms(fwd):.5f} ms, backward {_ms(bwd):.5f} ms")


if __name__ == "__main__":
    main()
