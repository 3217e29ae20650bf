"""Single-token decode attention on the GPU: wrappers of the hand-written CUDA
kernels ``csrc/decode_attention.cu`` (float32) and
``csrc/decode_attention_bf16.cu`` (bfloat16), the ports of
``repro/kernels/decode_attention.py::decode_attention_pallas`` at each
dtype, and their plain PyTorch version (the port of
``repro/kernels/ref.py::decode_attention_ref``).

The float32 kernel takes ``q`` ``[B, 1, H, D]``, caches ``[B, W, KV, D]``
and a bool ``valid`` mask ``[W]`` (shared) or ``[B, W]`` (per sequence),
contiguous on one CUDA device, with ``H % KV == 0`` and ``D`` a multiple of
4 up to 256.  Anything else raises: CPU tensors take the plain version in
``repro_torch.kernels.ops.decode_attention``.  A row with no valid slot
gives exact zeros on both paths.

The float32 kernel splits the window over blocks (flash-decoding):
``decode_splits`` picks the number of splits from the shape, and with more
than one the splits' softmax states go through a workspace
``[B, KV, splits, g, D + 2]`` that each call allocates, and are merged in a
fixed order.  The merge's tickets are kept zeroed per device and stream
(``build.zeroed_tickets``).

bfloat16 ``q`` and caches (the zoo's default dtype) take the kernel of
``csrc/decode_attention_bf16.cu``, designed for Hopper: a cluster of blocks
a (sequence, kv head) group, each rank a run of the window's 64-slot tiles
landed by TMA, the group's heads' scores and P V on the tensor cores
(``mma.sync``), the ranks' softmax states merged through the cluster's
shared memory, so the wrapper allocates only the output.  D must be a
multiple of 8 from 64 to 128; anything else raises.  ``bf16_decode_plan``
picks the cluster size and the ring's stages from the shape.  Scores,
softmax and sums are fp32, P is rounded to bf16 for its product and the
output to bf16 once, as the TPU kernel widens its operands and rounds its
output (``decode_attention.py:78``).  The plain version computes the same
in float32 and rounds once.  Mixed dtypes raise.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library, zeroed_tickets

__all__ = [
    "decode_attention_cuda",
    "decode_attention_plain",
    "bf16_decode_plan",
    "bf16_decode_smem",
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


# The bf16 kernel (csrc/decode_attention_bf16.cu): tiles of 64 slots, a
# chunk of up to 16 query heads of a group a cluster, 160 threads a block
# (four consumer warps and a producer warp), a ring of at most 8 stages.
BF16_TILE = 64
BF16_ROWS = 16
BF16_MAX_STAGES = 8
BF16_MAX_CLUSTER = 16
BF16_CLUSTERS = (1, 2, 4, 8)  # the portable sizes the plan picks from
SM_SMEM = 233472  # bytes of shared memory an H100 SM gives its blocks (228 KB)
BLOCK_SMEM = 232448  # the most one block may ask for (227 KB)


def bf16_decode_smem(dp: int, stages: int, per_rank: int) -> int:
    """Dynamic shared memory of a block of the bf16 kernel (``Layout::bytes``
    in ``csrc/decode_attention_bf16.cu``): 1 KB of alignment slack, the ring
    (a K and a V tile of [64, dp] bf16 a stage), the block's merged fp32 acc
    [16, dp], the warps' and the block's m and l, Q [16, dp + 8] bf16, one
    mask word a tile of the rank's share and two mbarriers a stage."""
    return (1024 + stages * 2 * BF16_TILE * dp * 2 + BF16_ROWS * dp * 4 + 10 * BF16_ROWS * 4
            + BF16_ROWS * (dp + 8) * 2 + 8 * per_rank + 16 * stages)


class DecodePlan(NamedTuple):
    cluster: int  # blocks of a cluster: the ranks a group's window is cut into
    stages: int  # the ring's stages of a block
    tiles: int  # 64-slot tiles of the window
    per_rank: int  # the most tiles a rank holds
    groups: int  # clusters: (b, kv head, chunk of up to 16 query heads)
    blocks: int
    smem: int  # dynamic shared memory of a block, bytes
    dp: int  # D padded to the 64-column boxes: 64 or 128


def _plan(B: int, KV: int, g: int, D: int, W: int, cluster: int) -> DecodePlan:
    dp = 64 if D <= 64 else 128
    groups = B * KV * -(-g // BF16_ROWS)
    tiles = -(-W // BF16_TILE)
    per_rank = -(-tiles // cluster)
    blocks = groups * cluster
    room = min(SM_SMEM // -(-blocks // SMS) - 1024, BLOCK_SMEM)
    fit = (room - bf16_decode_smem(dp, 0, per_rank)) // (2 * BF16_TILE * dp * 2)
    stages = max(1, min(per_rank, BF16_MAX_STAGES, fit))
    return DecodePlan(cluster, stages, tiles, per_rank, groups, blocks,
                      bf16_decode_smem(dp, stages, per_rank), dp)


@functools.lru_cache(maxsize=1024)
def bf16_decode_plan(B: int, KV: int, g: int, D: int, W: int,
                     cluster: Optional[int] = None) -> DecodePlan:
    """The bf16 kernel's launch at a shape: the cluster size (1, 2, 4 or 8
    blocks, the portable sizes) and the stages of each block's ring, as
    many as the rank's share of tiles needs, at most 8 and as many as the
    shared memory that the grid's blocks an SM leave a block holds.  The
    cluster grows while every rank keeps a tile and the grid stays within
    one block an SM of an H100 (132), or within two where one block an SM
    leaves a third of the SMs idle and each rank's tiles then still fit its
    ring at once; past 4 blocks only while a block takes at most half an
    SM's shared memory (clusters of 8 blocks that each fill an SM did not
    all fit one wave: LLaVA's step at 1.4x its time at 4, ``decode_variants
    --bf16 --sweep``, PERF.md).  ``cluster`` forces the size (1-16)."""
    if cluster is not None:
        if not 1 <= cluster <= BF16_MAX_CLUSTER:
            raise ValueError(f"bf16_decode_plan: a cluster of 1 to {BF16_MAX_CLUSTER}, got {cluster}")
        return _plan(B, KV, g, D, W, cluster)
    best = _plan(B, KV, g, D, W, 1)
    for c in BF16_CLUSTERS[1:]:
        plan = _plan(B, KV, g, D, W, c)
        if c > plan.tiles:
            break
        if plan.blocks > SMS and not (best.blocks < 2 * SMS // 3 and plan.blocks <= 2 * SMS
                                      and plan.stages == plan.per_rank):
            break
        if c > 4 and plan.smem > SM_SMEM // 2 - 1024:
            break
        best = plan
    return best


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


def _operands(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              valid: torch.Tensor) -> tuple:
    """(B, W, H, KV, D, the mask's row stride) of a kernel call's valid
    operands; raises on anything the kernels do not take."""
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
    if q.dtype == torch.bfloat16 and (D % 8 or not 64 <= D <= 128):
        raise ValueError(f"decode_attention_cuda: the bf16 kernel needs D a multiple of 8 in "
                         f"[64, 128], got D={D}")
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
    return B, W, H, KV, D, row_stride


def decode_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Decode attention kernel; same contract as ``decode_attention_plain``."""
    B, W, H, KV, D, row_stride = _operands(q, k_cache, v_cache, valid)
    device, bf16 = q.device, q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    if B == 0 or W == 0:
        return out.zero_()
    g = H // KV
    lib = load_library()
    if bf16:
        plan = bf16_decode_plan(B, KV, g, D, W)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.decode_attention_bf16_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                out.data_ptr(), B, W, H, KV, D, row_stride, plan.cluster, plan.stages,
                1.0 / math.sqrt(D), stream,
            )
        check(lib, rc, "decode_attention_bf16_launch")
        DECODE_ATTENTION_BF16_LAUNCHES.add()
        return out
    splits = decode_splits(B, KV, g, D, W)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        work_ptr = tickets_ptr = None
        if splits > 1:
            work = torch.empty((B, KV, splits, g, D + 2), dtype=torch.float32, device=device)
            work_ptr = work.data_ptr()
            tickets_ptr = zeroed_tickets(device, stream, B * H).data_ptr()
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), work_ptr, tickets_ptr, B, W, H, KV, D, row_stride, splits,
            1.0 / math.sqrt(D), stream,
        )
    check(lib, rc, "decode_attention_launch")
    DECODE_ATTENTION_LAUNCHES.add()
    return out
