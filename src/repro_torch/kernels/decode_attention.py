"""Single-token decode attention on the GPU: wrapper of the hand-written CUDA
kernel ``csrc/decode_attention.cu`` (the port of
``repro/kernels/decode_attention.py::decode_attention_pallas``) and its
plain PyTorch version (the port of ``repro/kernels/ref.py::
decode_attention_ref``).

The kernel takes float32 ``q`` ``[B, 1, H, D]``, caches ``[B, W, KV, D]``
and a bool ``valid`` mask ``[W]`` (shared) or ``[B, W]`` (per sequence),
contiguous on one CUDA device, with ``H % KV == 0`` and ``D`` a multiple of
4 up to 256.  Anything else raises: CPU tensors take the plain version in
``repro_torch.kernels.ops.decode_attention``.  A row with no valid slot
gives exact zeros on both paths.

bfloat16 ``q`` and caches (the zoo's default dtype) take the same source's
bf16 kernel, the same design reading the cache as bf16, half the bytes: scores, softmax and sums in fp32, the output rounded
to bf16 once, as the TPU kernel widens its operands and rounds its output
(``decode_attention.py:78``).  The plain version computes the same in
float32 and rounds once.  Mixed dtypes raise.

The kernel splits the window over blocks (flash-decoding): ``decode_splits``
picks the number of splits from the shape, and with more than one the
splits' softmax states go through a workspace ``[B, KV, splits, g, D + 2]``
that each call allocates, and are merged in a fixed order.  The merge's
tickets are kept zeroed per device and stream (``build.zeroed_tickets``).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library, zeroed_tickets

__all__ = [
    "decode_attention_cuda",
    "decode_attention_plain",
    "decode_splits",
    "heads_per_block",
    "resident_blocks",
    "DECODE_ATTENTION_LAUNCHES",
    "DECODE_ATTENTION_BF16_LAUNCHES",
]

# One count per wrapper call, one CUDA launch: the splits are merged inside it.
DECODE_ATTENTION_LAUNCHES = LaunchCounter("decode_attention")
DECODE_ATTENTION_BF16_LAUNCHES = LaunchCounter("decode_attention_bf16")

SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_SPLIT_SLOTS = 64  # a split is at least 8 slots for each of a block's 8 warps


def heads_per_block(g: int) -> int:
    """Query heads of a group that one block carries (``launch_heads`` in
    ``csrc/decode_attention.cu``)."""
    return 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8


def resident_blocks(g: int, D: int) -> int:
    """Blocks an SM holds at once: the kernel's registers are capped for 3
    with one head of float4 accumulators a lane, 2 with up to eight
    (``min_blocks`` in ``csrc/decode_attention.cu``)."""
    width = heads_per_block(g) * (1 if D <= 128 else 2)
    return 3 if width == 1 else 2 if width <= 8 else 1


@functools.lru_cache(maxsize=1024)
def decode_splits(B: int, KV: int, g: int, D: int, W: int) -> int:
    """Number of splits of the window W: as many as one wave of resident
    blocks on every SM holds (a second, partial wave would leave most SMs
    idle while it runs), each split at least ``MIN_SPLIT_SLOTS`` slots long;
    so 1 for a short window or a grid that already fills the card, and never
    more than W."""
    groups = B * KV * -(-g // heads_per_block(g))
    return max(1, min(SMS * resident_blocks(g, D) // groups, W // MIN_SPLIT_SLOTS))


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """q: [B,1,H,D]; caches: [B,W,KV,D]; valid: [W] or [B,W] bool -> [B,1,H,D].
    bfloat16 inputs are widened to float32 and the output rounded back once."""
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, k_cache, v_cache = q.float(), k_cache.float(), v_cache.float()
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    if valid.dim() == 1:
        valid = valid[None].expand(B, W)
    qg = q.reshape(B, KV, g, D)
    scores = torch.einsum("bhgd,bwhd->bhgw", qg, k_cache) / math.sqrt(D)
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    # An all-invalid row is a uniform softmax over -1e30; re-masking makes
    # the empty-cache output exactly zero instead.
    p = torch.where(vmask, p, torch.zeros_like(p))
    out = torch.einsum("bhgw,bwhd->bhgd", p, v_cache)
    return out.reshape(B, 1, H, D).to(dtype)


def _check(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype, device) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(
            f"decode_attention_cuda: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"decode_attention_cuda: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"decode_attention_cuda: {name} must be contiguous")


def decode_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Decode attention kernel; same contract as ``decode_attention_plain``."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors must be on a CUDA device, got {device}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(
            "decode_attention_cuda: want q [B, 1, H, D] and caches [B, W, KV, D], got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    if KV < 1 or H % KV or D % 4 or not 4 <= D <= 256:
        raise ValueError(
            f"decode_attention_cuda: needs H % KV == 0 and D a multiple of 4 in [4, 256], "
            f"got H={H} KV={KV} D={D}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention_cuda: q must be float32 or bfloat16, got {q.dtype}")
    _check("q", q, (B, 1, H, D), q.dtype, device)
    _check("k_cache", k_cache, (B, W, KV, D), q.dtype, device)
    _check("v_cache", v_cache, (B, W, KV, D), q.dtype, device)
    if valid.dim() == 1:
        _check("valid", valid, (W,), torch.bool, device)
        row_stride = 0
    else:
        _check("valid", valid, (B, W), torch.bool, device)
        row_stride = W
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention_cuda: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or W == 0:
        return out.zero_()
    g = H // KV
    splits = decode_splits(B, KV, g, D, W)
    bf16 = q.dtype == torch.bfloat16
    name = "decode_attention_bf16_launch" if bf16 else "decode_attention_launch"
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        work_ptr = tickets_ptr = None
        if splits > 1:
            work = torch.empty((B, KV, splits, g, D + 2), dtype=torch.float32, device=device)
            work_ptr = work.data_ptr()
            tickets_ptr = zeroed_tickets(device, stream, B * H).data_ptr()
        rc = getattr(lib, name)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), work_ptr, tickets_ptr, B, W, H, KV, D, row_stride, splits,
            1.0 / math.sqrt(D), stream,
        )
    check(lib, rc, name)
    (DECODE_ATTENTION_BF16_LAUNCHES if bf16 else DECODE_ATTENTION_LAUNCHES).add()
    return out
