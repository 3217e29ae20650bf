"""RWKV-6 WKV recurrence on the GPU, forward and backward: wrappers of the
hand-written CUDA kernels ``csrc/rwkv6.cu`` (the port of
``repro/kernels/rwkv6.py::rwkv6_pallas``, plus the backward the TPU kernel
lacks), their ``torch.autograd.Function`` and the plain PyTorch version.

``rwkv6_plain`` is the port of ``repro/kernels/ref.py::rwkv6_ref``: the
exact step-by-step recurrence (chunk-checkpointed as the reference's), which
autograd differentiates on the CPU as ``jax.grad`` differentiates the
reference's.

The kernels take float32 r, k, v, w ``[B, T, H, N]`` and u ``[H, N]``,
contiguous on one CUDA device, with N in {16, 32, 64}, any T >= 1, an
optional float32 start state ``[B, H, N, N]`` and a remat chunk of 1 to 64
steps; anything else raises.  Unlike the Pallas kernel, which starts from a
zero state only (and for which the reference routes a nonzero state to its
oracle), the CUDA kernel takes the start state, so ``ops.rwkv6`` sends every
CUDA call to it.  CPU tensors take the plain version.

bfloat16 r, k, v and w with float32 u and state (the dtypes a bf16 model
passes: ``models/ssm.py`` widens ``bonus_u``, as the reference's
``transformer.py`` does) take the bf16 kernels of the same source: the
float32 kernels' arithmetic on the widened operands, the states fp32, each
output (out; dr, dk, dv, dw) rounded to bf16 once and du float32, as the
Pallas kernel widens its operands and writes its output in r's dtype
(``rwkv6.py:50-54,68``).  The plain version computes the same in float32
and rounds once.  Any other mix of dtypes raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = [
    "rwkv6_cuda",
    "rwkv6_plain",
    "RWKV6",
    "RWKV6_FWD_LAUNCHES",
    "RWKV6_BWD_LAUNCHES",
    "RWKV6_FWD_BF16_LAUNCHES",
    "RWKV6_BWD_BF16_LAUNCHES",
]

RWKV6_FWD_LAUNCHES = LaunchCounter("rwkv6_fwd")
RWKV6_BWD_LAUNCHES = LaunchCounter("rwkv6_bwd")
RWKV6_FWD_BF16_LAUNCHES = LaunchCounter("rwkv6_fwd_bf16")
RWKV6_BWD_BF16_LAUNCHES = LaunchCounter("rwkv6_bwd_bf16")

HEAD_SIZES = (16, 32, 64)
MAX_CHUNK = 64
DTYPES = (torch.float32, torch.bfloat16)


def _steps(r, k, v, w, u, S):
    """The recurrence over r, k, v, w [B, T', H, N] from S; (out, final S)."""
    dtype = S.dtype
    rs, ks, vs, ws = (x.transpose(0, 1).to(dtype) for x in (r, k, v, w))  # [T', B, H, N]
    outs = []
    for t in range(r.shape[1]):
        kv = ks[t][..., :, None] * vs[t][..., None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", rs[t], S + u[None, :, :, None] * kv))
        S = ws[t][..., :, None] * S + kv
    return torch.stack(outs, dim=1), S


def rwkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    chunk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: [B, T, H, N]; u: [H, N]; state: [B, H, N, N] (key x
    value). Returns (out [B, T, H, N] in r's dtype, final state).  Computes
    in float32 (float64 for float64 inputs).  With ``chunk`` and a gradient
    to take, the loop runs chunk by chunk under activation checkpointing,
    keeping one state per chunk: the reference oracle's chunked remat
    (``rwkv6_ref(chunk=...)``), the same numbers in less memory."""
    B, T, H, N = r.shape
    dtype = torch.float64 if r.dtype == torch.float64 else torch.float32
    S = torch.zeros((B, H, N, N), dtype=dtype, device=r.device) if state is None else state
    if T == 0:
        return torch.zeros_like(r), S
    if not (0 < chunk < T and torch.is_grad_enabled()):
        out, S = _steps(r, k, v, w, u, S)
        return out.to(r.dtype), S
    outs = []
    for t0 in range(0, T, chunk):
        part = [x[:, t0:t0 + chunk] for x in (r, k, v, w)]
        out, S = torch.utils.checkpoint.checkpoint(_steps, *part, u, S, use_reentrant=False)
        outs.append(out)
    return torch.cat(outs, dim=1).to(r.dtype), S


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(
            f"rwkv6_cuda: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"rwkv6_cuda: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"rwkv6_cuda: {name} must be contiguous")
    if x.data_ptr() % 4:  # the bf16 kernels copy pairs of elements
        raise ValueError(f"rwkv6_cuda: {name} must be 4-byte aligned")


def _check_inputs(r, k, v, w, u, state, chunk) -> Tuple[int, int, int, int]:
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"rwkv6_cuda: tensors must be on a CUDA device, got {device}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_cuda: want r, k, v, w [B, T, H, N], got {tuple(r.shape)}")
    B, T, H, N = r.shape
    if N not in HEAD_SIZES or not 1 <= B <= 65535 or T < 1 or H < 1:
        raise ValueError(
            f"rwkv6_cuda: needs N in {HEAD_SIZES}, 1 <= B <= 65535 and T, H >= 1, "
            f"got {tuple(r.shape)}"
        )
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_cuda: chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if r.dtype not in DTYPES:
        raise ValueError(f"rwkv6_cuda: r must be float32 or bfloat16, got {r.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, (B, T, H, N), device, r.dtype)
    _check("u", u, (H, N), device)
    if state is not None:
        _check("state", state, (B, H, N, N), device)
    return B, T, H, N


def rwkv6_fwd_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor],
    chunk: int,
    save: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Forward kernel launch: (out in r's dtype, final state, chunk-start
    states or None); the bf16 kernel for bfloat16 r, k, v, w."""
    B, T, H, N = _check_inputs(r, k, v, w, u, state, chunk)
    bf16 = r.dtype == torch.bfloat16
    out = torch.empty_like(r)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    nc = -(-T // chunk)
    ckpt = torch.empty((B, H, nc, N, N), dtype=torch.float32, device=r.device) if save else None
    lib = load_library()
    name = "rwkv6_bf16_fwd_launch" if bf16 else "rwkv6_fwd_launch"
    with torch.cuda.device(r.device):
        rc = getattr(lib, name)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state.data_ptr() if state is not None else None, out.data_ptr(), s_out.data_ptr(),
            ckpt.data_ptr() if ckpt is not None else None, B, T, H, N, chunk,
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    check(lib, rc, name)
    (RWKV6_FWD_BF16_LAUNCHES if bf16 else RWKV6_FWD_LAUNCHES).add()
    return out, s_out, ckpt


def rwkv6_bwd_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    dout: torch.Tensor,
    ckpt: torch.Tensor,
    ds_final: Optional[torch.Tensor],
    chunk: int,
    want_ds0: bool,
):
    """Backward kernel launch: (dr, dk, dv, dw in r's dtype, du [H, N] and
    the start state's gradient or None in float32)."""
    B, T, H, N = _check_inputs(r, k, v, w, u, ds_final, chunk)
    bf16 = r.dtype == torch.bfloat16
    _check("dout", dout, (B, T, H, N), r.device, r.dtype)
    _check("ckpt", ckpt, (B, H, -(-T // chunk), N, N), r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device) if want_ds0 else None
    lib = load_library()
    name = "rwkv6_bf16_bwd_launch" if bf16 else "rwkv6_bwd_launch"
    with torch.cuda.device(r.device):
        rc = getattr(lib, name)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            dout.data_ptr(), ckpt.data_ptr(),
            ds_final.data_ptr() if ds_final is not None else None,
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
            ds0.data_ptr() if ds0 is not None else None, B, T, H, N, chunk,
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    check(lib, rc, name)
    (RWKV6_BWD_BF16_LAUNCHES if bf16 else RWKV6_BWD_LAUNCHES).add()
    # Summed over the batch here, in a fixed order, so du is the same from
    # run to run.
    return dr, dk, dv, dw, du_part.sum(dim=0), ds0


class RWKV6(torch.autograd.Function):
    """The recurrence with the backward kernel as its gradient; the
    counterpart of ``jax.grad`` through the reference's ``rwkv6_ref``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk, save):
        out, s_out, ckpt = rwkv6_fwd_cuda(r, k, v, w, u, state, chunk, save)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.chunk = chunk
        ctx.has_state = state is not None
        ctx.set_materialize_grads(False)
        return out, s_out

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dout = torch.zeros_like(r) if dout is None else dout.contiguous()
        ds_final = None if ds_final is None else ds_final.contiguous()
        dr, dk, dv, dw, du, ds0 = rwkv6_bwd_cuda(
            r, k, v, w, u, dout, ckpt, ds_final, ctx.chunk, ctx.has_state
        )
        return dr, dk, dv, dw, du, ds0, None, None


def rwkv6_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel; same contract as ``rwkv6_plain`` (plus the remat
    ``chunk``), differentiable in r, k, v, w, u and the start state through
    the backward kernel.  The chunk-start states are saved only when a
    gradient can flow."""
    inputs = (r, k, v, w, u) + ((state,) if state is not None else ())
    save = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    return RWKV6.apply(r, k, v, w, u, state, int(chunk), save)
