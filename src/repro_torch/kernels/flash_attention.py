"""Flash attention on the GPU, forward and backward: wrappers of the
hand-written CUDA kernels ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py::flash_attention_pallas``, plus the
backward the TPU kernel lacks), their ``torch.autograd.Function`` and the
plain PyTorch version.

``flash_attention_plain`` is the port of ``repro/kernels/ref.py::
chunked_attention`` with one change the kernels share: the probabilities are
re-masked after the softmax, so a query row that sees no key gives zeros
(the reference gives a uniform average there).  Every row sees a key on the
paths the port runs (causal attention with ``q_offset >= 0``), where the two
agree.

The kernels take float32 ``q`` ``[B, Sq, H, D]`` and ``k``/``v``
``[B, Sk, KV, D]``, contiguous on one CUDA device, with ``H % KV == 0`` and
``D`` in {32, 64, 128}; anything else raises.  They multiply on the tensor
cores in 3xTF32 (each operand split into two TF32 parts, three products
summed in fp32), which keeps them within 1e-5 of the plain version forward
and 1e-4 in the gradients.  CPU tensors take the plain version in
``repro_torch.kernels.ops.flash_attention``.

bfloat16 ``q``, ``k`` and ``v`` (the zoo's default dtype) take the kernels
of ``csrc/flash_attention_bf16.cu``: one bf16 tensor-core pass for each
product, fp32 softmax and sums, the output rounded to bf16 once, as the TPU
kernel widens its bf16 operands and rounds its output
(``flash_attention.py:73-75,95``).  Its backward recomputes P from the
forward's fp32 logsumexp, rounds P and dS to bf16 for their products (the
reference's ``chunked_attention`` rounds P to v's dtype and differentiates
through it), sums in fp32 and rounds each gradient to bf16 once.  The plain
version is the same function computed in float32 and rounded once, and
autograd through it is the backward's plain version: exact fp32 gradients,
each rounded once to bf16.  Operands of mixed dtypes raise.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = [
    "flash_attention_cuda",
    "flash_attention_plain",
    "FlashAttention",
    "FLASH_FWD_LAUNCHES",
    "FLASH_FWD_BF16_LAUNCHES",
    "FLASH_BWD_LAUNCHES",
    "FLASH_BWD_BF16_LAUNCHES",
]

FLASH_FWD_LAUNCHES = LaunchCounter("flash_attention_fwd")
FLASH_FWD_BF16_LAUNCHES = LaunchCounter("flash_attention_fwd_bf16")
FLASH_BWD_LAUNCHES = LaunchCounter("flash_attention_bwd")
FLASH_BWD_BF16_LAUNCHES = LaunchCounter("flash_attention_bwd_bf16")

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _mask(Sq: int, Sk: int, causal: bool, window: int, q_offset: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Sk,KV,D] -> [B,Sq,H,D]; query head h reads kv
    head h // (H // KV).  bfloat16 inputs are widened to float32 and the
    output rounded back once, as the TPU kernel does."""
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(D))
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, H, v.shape[-1]).to(dtype)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, ...]:
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors must be on a CUDA device, got {device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            "flash_attention_cuda: want q [B, Sq, H, D] and k, v [B, Sk, KV, D], got "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV or D not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_cuda: needs H % KV == 0 and D in {HEAD_DIMS}, "
            f"got H={H} KV={KV} D={D}"
        )
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_cuda: B={B} and H={H} must be at most 65535")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_cuda: q must be float32 or bfloat16, got {q.dtype}")
    for name, x, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Sk, KV, D)), ("v", v, (B, Sk, KV, D))):
        _check_tensor(name, x, shape, device, q.dtype)
    return B, Sq, Sk, H, KV, D


def _check_tensor(name: str, x: torch.Tensor, shape: tuple, device, dtype) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(
            f"flash_attention_cuda: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"flash_attention_cuda: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"flash_attention_cuda: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention_cuda: {name} must be 16-byte aligned")


def flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int, q_offset: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel launch: (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq]
    float32); the bf16 kernel for bfloat16 operands."""
    B, Sq, Sk, H, KV, D = _check_inputs(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or Sk == 0:
        o.zero_()
        lse.fill_(float("inf"))
        return o, lse
    lib = load_library()
    name = "flash_attention_bf16_fwd_launch" if bf16 else "flash_attention_fwd_launch"
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, H, KV, D, int(causal), int(window), int(q_offset), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(lib, rc, name)
    (FLASH_FWD_BF16_LAUNCHES if bf16 else FLASH_FWD_LAUNCHES).add()
    return o, lse


def flash_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    causal: bool,
    window: int,
    q_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernel launches (row sums, dK/dV, dQ): (dq, dk, dv) in q's
    dtype; the bf16 kernels for bfloat16 operands (o and dout in q's dtype,
    lse float32)."""
    B, Sq, Sk, H, KV, D = _check_inputs(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    _check_tensor("o", o, tuple(q.shape), q.device, q.dtype)
    _check_tensor("dout", dout, tuple(q.shape), q.device, q.dtype)
    _check_tensor("lse", lse, (B, H, Sq), q.device, torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = load_library()
    name = "flash_attention_bf16_bwd_launch" if bf16 else "flash_attention_bwd_launch"
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Sk, H, KV, D, int(causal), int(window), int(q_offset), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(lib, rc, name)
    (FLASH_BWD_BF16_LAUNCHES if bf16 else FLASH_BWD_LAUNCHES).add()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is the hand-written backward kernels; the
    counterpart of ``jax.grad`` through the reference's attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_fwd_cuda(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention kernel; same contract as ``flash_attention_plain``,
    differentiable in q, k and v through the backward kernels."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window), int(q_offset))
