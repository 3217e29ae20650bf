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
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = ["decode_attention_cuda", "decode_attention_plain", "DECODE_ATTENTION_LAUNCHES"]

DECODE_ATTENTION_LAUNCHES = LaunchCounter("decode_attention")


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """q: [B,1,H,D]; caches: [B,W,KV,D]; valid: [W] or [B,W] bool -> [B,1,H,D]."""
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
    return out.reshape(B, 1, H, D)


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
    _check("q", q, (B, 1, H, D), torch.float32, device)
    _check("k_cache", k_cache, (B, W, KV, D), torch.float32, device)
    _check("v_cache", v_cache, (B, W, KV, D), torch.float32, device)
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
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, W, H, KV, D, row_stride, 1.0 / math.sqrt(D),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "decode_attention")
    DECODE_ATTENTION_LAUNCHES.add()
    return out
