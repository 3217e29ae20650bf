"""Threefry-2x32 over per-lane keys: the hand-written CUDA kernel
(``csrc/threefry.cu``) and its plain PyTorch version.

Port-only: the JAX package hashes inside XLA, where ``jax.random`` fuses;
the plain version here is threefry as int64 tensor ops holding uint32 words
(every sum masked with ``& 0xFFFFFFFF``), some 140 elementwise launches a
hash on the card.  ``repro_torch.prng`` builds ``split``, ``fold_in`` and
``random_bits`` on the two functions below, which dispatch by device as
``kernels/ops.py`` does: a CUDA tensor goes to the kernel (one launch a
hash) or raises, a CPU tensor to the plain version.  Both give the same
bits, which equal ``jax.random``'s (JAX 0.9, partitionable counters).

    hash_counts(keys [..., 2], n, xor)  counters 0 .. n-1 under every lane
        key: both words as keys [..., n, 2] (``split``), or their xor
        [..., n] (``random_bits``);
    fold_in(keys [..., 2], data [...])  the hash of (0, data): keys [..., 2].
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import hlo_cost as _cost
from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = [
    "MASK",
    "THREEFRY_LAUNCHES",
    "threefry_plain",
    "hash_counts",
    "hash_counts_plain",
    "hash_counts_cuda",
    "fold_in",
    "fold_in_plain",
    "fold_in_cuda",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

THREEFRY_LAUNCHES = LaunchCounter("threefry")


def _u32(x: Any, device: Any = None) -> torch.Tensor:
    """Integers (tensor, array or int) as int64 holding uint32 words."""
    t = torch.as_tensor(x, device=device)
    if t.dtype != torch.int64:
        t = t.to(torch.int64)
    return t & MASK


# ----------------------------------------------------------- plain version
def threefry_plain(
    k1: torch.Tensor, k2: torch.Tensor, x1: Any, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; all four broadcast together.

    The masks are as few as the arithmetic allows: ``x2`` is masked after
    every update, since its rotation must see 32 bits; ``x1`` only adds and
    feeds ``x2`` through the masked xor, so its low word stays right as it
    grows (under 2^37 after 25 additions) and it is masked once at the end."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1 & MASK, x2


def hash_counts_plain(keys: torch.Tensor, n: int, xor: bool) -> torch.Tensor:
    """Counters ``0 .. n-1`` hashed under every lane key ``[..., 2]``:
    ``[..., n, 2]`` (both words) or, with ``xor``, ``[..., n]``."""
    keys = _u32(keys)
    lead = tuple(keys.shape[:-1])
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = (0, counts) if n <= MASK + 1 else (counts >> 32, counts & MASK)
    pad = (1,) * len(lead)
    if not isinstance(hi, int):
        hi = hi.reshape(pad + (n,))
    b1, b2 = threefry_plain(
        keys[..., 0].reshape(lead + (1,)), keys[..., 1].reshape(lead + (1,)), hi,
        lo.reshape(pad + (n,)),
    )
    b1, b2 = b1.expand(lead + (n,)), b2.expand(lead + (n,))
    return b1 ^ b2 if xor else torch.stack([b1, b2], dim=-1)


def fold_in_plain(keys: torch.Tensor, data: Any) -> torch.Tensor:
    """``keys [..., 2]`` and integer ``data`` broadcast together -> the
    hash of ``(0, data)``, keys ``[..., 2]``."""
    keys = _u32(keys)
    data = _u32(data, keys.device)
    b1, b2 = threefry_plain(keys[..., 0], keys[..., 1], 0, data)
    b1, b2 = torch.broadcast_tensors(b1, b2)
    return torch.stack([b1, b2], dim=-1)


# ----------------------------------------------------------------- kernel
def _rows(name: str, x: torch.Tensor, width: int) -> Tuple[torch.Tensor, int]:
    """``x`` as rows of ``width`` int64 words whose words are adjacent (a
    view where the strides allow one, else a copy) and the row stride."""
    if x.dtype != torch.int64:
        raise ValueError(f"threefry: {name} must be int64 (uint32 words), got {x.dtype}")
    rows = x.reshape(-1, width)
    if width > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    return rows, rows.stride(0)


def _require_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"threefry: {name} must be on a CUDA device, got {x.device}")


def hash_counts_cuda(keys: torch.Tensor, n: int, xor: bool) -> torch.Tensor:
    """``hash_counts`` in one launch of ``threefry_counts_kernel``; keys
    ``[..., 2]`` int64 on a CUDA device, any row stride."""
    _require_cuda("keys", keys)
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"threefry: keys must be [..., 2], got {tuple(keys.shape)}")
    n = int(n)
    if n < 0:
        raise ValueError(f"threefry: counter count {n} < 0")
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + ((n,) if xor else (n, 2)), dtype=torch.int64, device=keys.device)
    if out.numel() == 0:
        return out
    rows, stride = _rows("keys", keys, 2)
    lib = load_library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.threefry_counts_launch(
            rows.data_ptr(), stride, rows.shape[0], n, out.data_ptr(), int(xor), stream
        )
    check(lib, rc, "threefry_counts")
    THREEFRY_LAUNCHES.add()
    return out


def fold_in_cuda(keys: torch.Tensor, data: Any) -> torch.Tensor:
    """``fold_in`` in one launch of ``threefry_fold_in_kernel``.  ``keys
    [..., 2]`` and ``data`` broadcast: either side may be a single key or
    word; other broadcasts are expanded into a copy first."""
    _require_cuda("keys", keys)
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"threefry: keys must be [..., 2], got {tuple(keys.shape)}")
    data = torch.as_tensor(data, device=keys.device)
    _require_cuda("data", data)
    if data.dtype != torch.int64:
        if data.is_floating_point() or data.dtype == torch.bool:
            raise ValueError(f"threefry: data must be integers, got {data.dtype}")
        data = data.to(torch.int64)
    lead = torch.broadcast_shapes(tuple(keys.shape[:-1]), tuple(data.shape))
    out = torch.empty(lead + (2,), dtype=torch.int64, device=keys.device)
    lanes = out.numel() // 2
    if lanes == 0:
        return out
    if keys[..., 0].numel() == 1:
        key_rows, key_stride = _rows("keys", keys, 2)[0], 0
    else:
        key_rows, key_stride = _rows("keys", keys.expand(lead + (2,)), 2)
    if data.numel() == 1:
        data_rows, data_stride = data.reshape(1, 1), 0
    else:
        data_rows, data_stride = _rows("data", data.expand(lead), 1)
    lib = load_library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.threefry_fold_in_launch(
            key_rows.data_ptr(), key_stride, data_rows.data_ptr(), data_stride, lanes,
            out.data_ptr(), stream,
        )
    check(lib, rc, "threefry_fold_in")
    THREEFRY_LAUNCHES.add()
    return out


# --------------------------------------------------------------- dispatch
def hash_counts(keys: torch.Tensor, n: int, xor: bool) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("threefry_counts", keys, n, xor)
    if isinstance(keys, torch.Tensor) and keys.device.type == "cuda":
        return hash_counts_cuda(keys, n, xor)
    return hash_counts_plain(keys, n, xor)


def fold_in(keys: torch.Tensor, data: Any) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if _cost.LOCAL.walker is not None:
        return _cost.LOCAL.walker.kernel("threefry_fold_in", keys, data)
    if isinstance(keys, torch.Tensor) and keys.device.type == "cuda":
        return fold_in_cuda(keys, data)
    return fold_in_plain(keys, data)
