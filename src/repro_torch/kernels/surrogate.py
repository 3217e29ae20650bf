"""Fused PPO surrogate terms on the GPU: wrappers of the hand-written CUDA
kernels ``csrc/surrogate.cu`` (the port of
``repro/kernels/surrogate.py::ppo_surrogate_pallas``, forward and backward),
their ``torch.autograd.Function``, and the plain PyTorch version.

``ppo_surrogate_plain`` is the port of ``repro/kernels/ref.py::
ppo_surrogate_ref``.  Its clip is ``torch.minimum(torch.maximum(ratio, lo),
hi)``, not ``torch.clamp``: ``clamp``'s backward passes a gradient of 1 at
the boundary, while JAX's ``jnp.clip`` (a max then a min) splits ties
0.5/0.5, and ``torch.minimum``/``torch.maximum`` split them the same way.
The backward kernel implements that rule explicitly.

The kernels take float32 logits ``[B, A]``, int64 actions ``[B]`` and
float32 values, behaviour logp, advantages and returns ``[B]``, contiguous on
one CUDA device; anything else raises.  CPU tensors take the plain version
in ``repro_torch.kernels.ops.fused_ppo_loss``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library, zeroed_tickets

__all__ = [
    "ppo_surrogate_cuda",
    "ppo_surrogate_plain",
    "SurrogateTerms",
    "SURROGATE_FWD_LAUNCHES",
    "SURROGATE_BWD_LAUNCHES",
]

SURROGATE_FWD_LAUNCHES = LaunchCounter("ppo_surrogate_fwd")
SURROGATE_BWD_LAUNCHES = LaunchCounter("ppo_surrogate_bwd")

Terms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def ppo_surrogate_plain(
    logits: torch.Tensor,          # [B, A]
    values: torch.Tensor,          # [B]
    actions: torch.Tensor,         # [B] int
    behaviour_logp: torch.Tensor,  # [B]
    advantages: torch.Tensor,      # [B]
    returns: torch.Tensor,         # [B]
    clip_eps: float = 0.2,
) -> Terms:
    """Per-row PPO surrogate terms (pg_i, vf_i, ent_i, kl_i), each [B]."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions.long()[:, None])[:, 0]
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    ratio = torch.exp(logp - behaviour_logp)
    unclipped = ratio * advantages
    lo, hi = ratio.new_tensor(1 - clip_eps), ratio.new_tensor(1 + clip_eps)
    clipped = torch.minimum(torch.maximum(ratio, lo), hi) * advantages
    pg = -torch.minimum(unclipped, clipped)
    vf = torch.square(values - returns)
    kl = behaviour_logp - logp
    return pg, vf, entropy, kl


def _check_rows(device: torch.device, B: int, **rows: torch.Tensor) -> None:
    for name, x in rows.items():
        dtype = torch.int64 if name == "actions" else torch.float32
        if x.device != device or x.dtype != dtype:
            raise ValueError(
                f"ppo_surrogate_cuda: {name} must be {dtype} on {device}, "
                f"got {x.dtype} on {x.device}"
            )
        if tuple(x.shape) != (B,):
            raise ValueError(
                f"ppo_surrogate_cuda: {name} has shape {tuple(x.shape)}, expected ({B},)"
            )
        if not x.is_contiguous():
            raise ValueError(f"ppo_surrogate_cuda: {name} must be contiguous")


def _check_logits(logits: torch.Tensor) -> Tuple[int, int]:
    if logits.device.type != "cuda":
        raise ValueError(
            f"ppo_surrogate_cuda: tensors must be on a CUDA device, got {logits.device}"
        )
    if logits.dtype != torch.float32 or logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(
            "ppo_surrogate_cuda: logits must be contiguous float32 [B, A], got "
            f"{logits.dtype} {tuple(logits.shape)} contiguous={logits.is_contiguous()}"
        )
    B, A = logits.shape
    if A < 1:
        raise ValueError("ppo_surrogate_cuda: logits need at least one action column")
    return B, A


def surrogate_fwd_cuda(
    logits: torch.Tensor,
    actions: torch.Tensor,
    values: torch.Tensor,
    blp: torch.Tensor,
    adv: torch.Tensor,
    ret: torch.Tensor,
    clip_eps: float,
) -> Tuple[torch.Tensor, ...]:
    """Forward kernel launch: per-row (pg, vf, ent, kl) and the row
    logsumexp ``lse`` the backward takes.  At a vocabulary's width each row
    is split over blocks whose partial sums go through a work buffer that
    each call allocates; the last block of a row merges them."""
    B, A = _check_logits(logits)
    _check_rows(logits.device, B, actions=actions, values=values, blp=blp, adv=adv, ret=ret)
    pg, vf, ent, kl, lse = torch.empty((5, B), dtype=torch.float32, device=logits.device)
    if B == 0:
        return pg, vf, ent, kl, lse
    lib = load_library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        work_ptr = tickets_ptr = None
        chunks = lib.ppo_surrogate_fwd_chunks(A)
        if chunks:
            work = torch.empty(B * (3 * chunks + 1), dtype=torch.float32, device=logits.device)
            work_ptr = work.data_ptr()
            tickets_ptr = zeroed_tickets(logits.device, stream, B).data_ptr()
        rc = lib.ppo_surrogate_fwd_launch(
            logits.data_ptr(), actions.data_ptr(), values.data_ptr(), blp.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), pg.data_ptr(), vf.data_ptr(), ent.data_ptr(),
            kl.data_ptr(), lse.data_ptr(), work_ptr, tickets_ptr, B, A, 1.0 - clip_eps,
            1.0 + clip_eps, stream,
        )
    check(lib, rc, "ppo_surrogate_fwd")
    SURROGATE_FWD_LAUNCHES.add()
    return pg, vf, ent, kl, lse


def surrogate_bwd_cuda(
    logits: torch.Tensor,
    actions: torch.Tensor,
    values: torch.Tensor,
    blp: torch.Tensor,
    adv: torch.Tensor,
    ret: torch.Tensor,
    lse: torch.Tensor,
    ent: torch.Tensor,
    gpg: torch.Tensor,
    gvf: torch.Tensor,
    gent: torch.Tensor,
    gkl: torch.Tensor,
    clip_eps: float,
) -> Tuple[torch.Tensor, ...]:
    """Backward kernel launch from the forward's saved row logsumexp ``lse``
    and entropy ``ent``: (d logits, d values, d blp, d adv, d ret)."""
    B, A = _check_logits(logits)
    _check_rows(
        logits.device, B, actions=actions, values=values, blp=blp, adv=adv, ret=ret,
        lse=lse, ent=ent, gpg=gpg, gvf=gvf, gent=gent, gkl=gkl,
    )
    dlogits = torch.empty_like(logits)
    dv, dblp, dadv, dret = torch.empty((4, B), dtype=torch.float32, device=logits.device)
    if B == 0:
        return dlogits, dv, dblp, dadv, dret
    lib = load_library()
    with torch.cuda.device(logits.device):
        rc = lib.ppo_surrogate_bwd_launch(
            logits.data_ptr(), actions.data_ptr(), values.data_ptr(), blp.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), lse.data_ptr(), ent.data_ptr(), gpg.data_ptr(),
            gvf.data_ptr(), gent.data_ptr(), gkl.data_ptr(), dlogits.data_ptr(), dv.data_ptr(),
            dblp.data_ptr(), dadv.data_ptr(), dret.data_ptr(), B, A, 1.0 - clip_eps, 1.0 + clip_eps,
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    check(lib, rc, "ppo_surrogate_bwd")
    SURROGATE_BWD_LAUNCHES.add()
    return dlogits, dv, dblp, dadv, dret


class SurrogateTerms(torch.autograd.Function):
    """Per-row surrogate terms with the hand-written backward kernel; the
    counterpart of the reference's ``jax.custom_vjp`` ``_surrogate_terms``.
    The forward's row logsumexp and entropy are saved, so the backward reads
    the logits once.  Gradients flow to every float input; the int actions
    get none."""

    @staticmethod
    def forward(ctx, logits, values, blp, adv, ret, actions, clip_eps):
        pg, vf, ent, kl, lse = surrogate_fwd_cuda(logits, actions, values, blp, adv, ret, clip_eps)
        ctx.save_for_backward(logits, actions, values, blp, adv, ret, lse, ent)
        ctx.clip_eps = clip_eps
        return pg, vf, ent, kl

    @staticmethod
    def backward(ctx, gpg, gvf, gent, gkl):
        logits, actions, values, blp, adv, ret, lse, ent = ctx.saved_tensors

        def _cot(g: Optional[torch.Tensor]) -> torch.Tensor:
            # Cotangents of a mean arrive as stride-0 expansions; the kernel
            # takes dense rows.
            return torch.zeros_like(values) if g is None else g.contiguous()

        grads = surrogate_bwd_cuda(
            logits, actions, values, blp, adv, ret, lse, ent,
            _cot(gpg), _cot(gvf), _cot(gent), _cot(gkl), ctx.clip_eps,
        )
        return (*grads, None, None)


def ppo_surrogate_cuda(
    logits: torch.Tensor,          # [B, A]
    values: torch.Tensor,          # [B]
    actions: torch.Tensor,         # [B] int64
    behaviour_logp: torch.Tensor,  # [B]
    advantages: torch.Tensor,      # [B]
    returns: torch.Tensor,         # [B]
    clip_eps: float = 0.2,
) -> Terms:
    """Fused per-row PPO surrogate terms; same math as
    ``ppo_surrogate_plain``.  Returns (pg, vf, ent, kl), each [B];
    differentiable through the backward kernel."""
    return SurrogateTerms.apply(
        logits, values, behaviour_logp, advantages, returns, actions, float(clip_eps)
    )
