"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
sources include no PyTorch header, so a build takes seconds, not the
minutes a ``torch.utils.cpp_extension`` build would.  The library is named
by a hash of the sources and flags and cached under ``kernels/_build/``
(listed in ``.gitignore``); the first launch of any kernel builds it.

Each C entry point takes device pointers, sizes, scalars and the CUDA stream
as ``void*``/``int``/``float``, launches on that stream, and returns
``cudaGetLastError()`` so the Python wrapper can raise on a refused launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = [
    "BUILD_DIR",
    "CSRC_DIR",
    "LaunchCounter",
    "NVCC_FLAGS",
    "build_info",
    "check",
    "load_library",
    "zeroed_tickets",
]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points in csrc/ (see each source's header note).
_SIGNATURES = {
    # r, v, d, last, adv, ret, T, B, gamma, gamma*lam, stream
    "gae_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # blp, tlp, r, v, d, last, vs, pg, T, B, gamma, rho_clip, c_clip, stream
    "vtrace_launch": [_P] * 8 + [_I, _I, _F, _F, _F, _P],
    # logits, actions, values, blp, adv, ret, pg, vf, ent, kl, lse, work,
    # tickets, B, A, lo, hi, stream
    "ppo_surrogate_fwd_launch": [_P] * 13 + [_I, _I, _F, _F, _P],
    # A -> chunks of a row in the forward's work buffer
    "ppo_surrogate_fwd_chunks": [_I],
    # logits, actions, values, blp, adv, ret, lse, ent, gpg, gvf, gent, gkl,
    # dlogits, dv, dblp, dadv, dret, B, A, lo, hi, stream
    "ppo_surrogate_bwd_launch": [_P] * 17 + [_I, _I, _F, _F, _P],
    # q, k, v, valid, out, work, tickets, B, W, H, KV, D, valid_row_stride,
    # splits, scale, stream
    "decode_attention_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
    # q, k, v, o, lse, B, Sq, Sk, H, KV, D, causal, window, q_offset, scale, stream
    "flash_attention_fwd_launch": [_P] * 5 + [_I] * 9 + [_F, _P],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, D, causal,
    # window, q_offset, scale, stream
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 9 + [_F, _P],
    # r, k, v, w, u, s0, o, s_out, ckpt, B, T, H, N, chunk, stream
    "rwkv6_fwd_launch": [_P] * 9 + [_I] * 5 + [_P],
    # r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, B, T,
    # H, N, chunk, stream
    "rwkv6_bwd_launch": [_P] * 14 + [_I] * 5 + [_P],
    # x, w, ends, tile_ends, out, T, D, F, E, stream
    "moe_gmm_launch": [_P] * 5 + [_I] * 4 + [_P],
    # dy, w, ends, tile_ends, dx, T, D, F, E, stream
    "moe_gmm_dx_launch": [_P] * 5 + [_I] * 4 + [_P],
    # x, dy, ends, dw, T, D, F, E, stream
    "moe_gmm_dw_launch": [_P] * 4 + [_I] * 4 + [_P],
    # x, w, ends, out, work, tickets, T, D, F, E, rmax, chunks, stream
    "moe_gmm_small_launch": [_P] * 6 + [_I] * 6 + [_P],
    # D, F, E, rmax -> the chunks of D that fill a float32 call's last wave
    "moe_gmm_small_chunks": [_I] * 4 + [_P],
    # The bf16 kernels take the arguments of their float32 counterparts.
    "flash_attention_bf16_fwd_launch": [_P] * 5 + [_I] * 9 + [_F, _P],
    "moe_gmm_bf16_launch": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, valid, out, B, W, H, KV, D, valid_row_stride, cluster,
    # stages, scale, stream
    "decode_attention_bf16_launch": [_P] * 5 + [_I] * 8 + [_F, _P],
    # x, w, ends, out, work, tickets, T, D, F, E, rmax, chunks, stream
    "moe_gmm_small_bf16_launch": [_P] * 6 + [_I] * 6 + [_P],
    # D, F, E, rmax -> the chunks of D of a bf16 call, into an int
    "moe_gmm_small_bf16_chunks": [_I] * 4 + [_P],
    "flash_attention_bf16_bwd_launch": [_P] * 10 + [_I] * 9 + [_F, _P],
    "rwkv6_bf16_fwd_launch": [_P] * 9 + [_I] * 5 + [_P],
    "rwkv6_bf16_bwd_launch": [_P] * 14 + [_I] * 5 + [_P],
    # keys, key_stride, lanes, n, out, xor_words, stream
    "threefry_counts_launch": [_P, _L, _L, _L, _P, _I, _P],
    # keys, key_stride, data, data_stride, lanes, out, stream
    "threefry_fold_in_launch": [_P, _L, _P, _L, _L, _P, _P],
    # stream: an empty kernel, the shortest launch of the library
    "empty_launch": [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
            "of repro_torch build only where the CUDA toolkit is installed"
        )
    return str(path)


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list, target: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``target``; returns the compilers' output (ptxas register counts)."""
    nvcc = _nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" + "".join(logs))
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                          capture_output=True, text=True)
    logs.append(link.stdout + link.stderr)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{logs[-1]}")
    os.replace(tmp, target)
    for obj in objects:
        obj.unlink()
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"librepro_torch_kernels-{_digest(sources)}.so"
        t0 = time.perf_counter()
        log = ""
        if not target.exists():
            log = _compile(sources, target)
            (BUILD_DIR / "build.log").write_text(log)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _info.update(path=str(target), seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def build_info() -> dict:
    """Library path, build seconds (0-ish when cached) and the nvcc log."""
    return dict(_info)


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        text = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {rc} ({text})")


_tickets_lock = threading.Lock()
_tickets_by_stream: dict = {}


def zeroed_tickets(device, stream: int, n: int):
    """At least ``n`` zeroed int32 tickets for the kernels whose last block
    to finish a group merges it (decode attention, the surrogate forward),
    one buffer per (device, stream), grown on demand: launches on one stream
    run in order, and each leaves its tickets at 0."""
    import torch

    key = (device.index, stream)
    with _tickets_lock:
        tickets = _tickets_by_stream.get(key)
        if tickets is None or tickets.numel() < n:
            tickets = _tickets_by_stream[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return tickets


class LaunchCounter:
    """Number of launches of one kernel, safe across rollout threads.

    A wrapper calls ``add()`` right where it launches its kernel and nowhere
    else, so a run can show that its main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
