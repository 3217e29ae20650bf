"""Grouped matrix product (the MoE expert FFN) on the GPU: the wrapper of
the hand-written CUDA kernel ``csrc/moe_gmm.cu`` (the port of
``repro/kernels/moe_gmm.py::moe_gmm_pallas``) and its plain PyTorch version.

``moe_gmm_plain`` computes what ``repro/kernels/ref.py::moe_gmm_ref`` does,
as a loop over the groups of ``x[group] @ w[e]``: the reference's oracle form
gathers ``w[eid]`` for every row, which at the LM path's shape would take
2 TB.

The kernel takes float32 ``x [T, D]`` whose rows are sorted into
expert-contiguous groups, ``w [E, D, F]`` and ``group_sizes [E]`` (integer,
on the same device), contiguous, 16-byte aligned, with D and F multiples of
4; anything else raises.  The groups need no alignment to any block size.
Rows past ``sum(group_sizes)`` come out zero in both versions.  CPU tensors
take the plain version through ``repro_torch.kernels.ops.moe_gmm``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = ["moe_gmm_cuda", "moe_gmm_plain", "MOE_GMM_LAUNCHES"]

MOE_GMM_LAUNCHES = LaunchCounter("moe_gmm")

ROW_TILE = 128  # rows per output tile of the kernel (kBM in moe_gmm.cu)


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: [T, D] rows grouped by expert (sorted order); w: [E, D, F];
    group_sizes: [E] rows per expert. Returns [T, F] in x's dtype."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            out[start:start + size] = x[start:start + size] @ w[e]
        start += size
    return out


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"moe_gmm_cuda: {name} must be float32 on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != shape:
        raise ValueError(f"moe_gmm_cuda: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"moe_gmm_cuda: {name} must be contiguous and 16-byte aligned")


def moe_gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel; same contract as ``moe_gmm_plain``."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"moe_gmm_cuda: tensors must be on a CUDA device, got {device}")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"moe_gmm_cuda: want x [T, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    T, D = x.shape
    E, _, F = w.shape
    if D % 4 or F % 4:
        raise ValueError(f"moe_gmm_cuda: D and F must be multiples of 4, got D={D} F={F}")
    if -(-F // 128) > 65535:
        raise ValueError(f"moe_gmm_cuda: F={F} is too wide for the grid")
    _check("x", x, (T, D), device)
    _check("w", w, (E, D, F), device)
    if group_sizes.device != device or group_sizes.shape != (E,) or group_sizes.is_floating_point():
        raise ValueError(f"moe_gmm_cuda: group_sizes must be an integer [{E}] tensor on {device}")
    out = torch.zeros((T, F), dtype=torch.float32, device=device)
    if T == 0:
        return out
    # Computed on the device, so the launch never waits for it.
    sizes = group_sizes.to(torch.int32)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    tile_ends = torch.cumsum(torch.div(sizes + (ROW_TILE - 1), ROW_TILE, rounding_mode="floor"),
                             0, dtype=torch.int32)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.moe_gmm_launch(
            x.data_ptr(), w.data_ptr(), ends.data_ptr(), tile_ends.data_ptr(), out.data_ptr(),
            T, D, F, E, torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "moe_gmm")
    MOE_GMM_LAUNCHES.add()
    return out
