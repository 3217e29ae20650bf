"""Fused GAE and V-trace on the GPU: wrappers of the hand-written CUDA
kernels ``csrc/gae.cu`` and ``csrc/vtrace.cu`` (the ports of
``repro/kernels/advantages.py::gae_pallas`` and ``vtrace_pallas``).

The kernels take time-major float32 ``[T, ...]`` inputs and a ``[...]``
bootstrap value, contiguous on one CUDA device; trailing dims beyond T are
flattened into B, as in the reference.  Anything else raises: the plain
versions (``repro_torch.rl.advantages.gae`` / ``vtrace``) serve CPU tensors
through ``repro_torch.kernels.ops.fused_gae`` / ``fused_vtrace``, never a
CUDA call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = ["gae_cuda", "vtrace_cuda", "GAE_LAUNCHES", "VTRACE_LAUNCHES"]

GAE_LAUNCHES = LaunchCounter("gae")
VTRACE_LAUNCHES = LaunchCounter("vtrace")


def _require(kernel: str, name: str, x: torch.Tensor, shape: Tuple[int, ...],
             device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(
            f"{kernel}: {name} must be float32 on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _check_time_major(kernel: str, series: dict, last_value: torch.Tensor) -> Tuple[int, int]:
    """Validate time-major ``[T, ...]`` series and the ``[...]`` bootstrap;
    returns (T, B) with B the product of the trailing dims."""
    first = next(iter(series.values()))
    device = first.device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on a CUDA device, got {device}")
    shape = tuple(first.shape)
    if len(shape) < 1 or shape[0] < 1:
        raise ValueError(f"{kernel}: inputs must be time-major [T, ...] with T >= 1, got {shape}")
    for name, x in series.items():
        _require(kernel, name, x, shape, device)
    _require(kernel, "last_value", last_value, shape[1:], device)
    return shape[0], first[0].numel()


def gae_cuda(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused GAE; same contract as ``repro_torch.rl.advantages.gae``."""
    T, B = _check_time_major(
        "gae_cuda", {"rewards": rewards, "values": values, "dones": dones}, last_value
    )
    device = rewards.device
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    if B == 0:
        return adv, ret
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gae_launch(
            rewards.data_ptr(), values.data_ptr(), dones.data_ptr(), last_value.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), T, B, gamma, gamma * lam, stream,
        )
    check(lib, rc, "gae_cuda")
    GAE_LAUNCHES.add()
    return adv, ret


def vtrace_cuda(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused V-trace; same contract as ``repro_torch.rl.advantages.vtrace``.

    Returns (vs, pg_advantages).  The kernel has no backward: V-trace
    targets are stop-gradient in the reference's loss, so an input that
    requires grad raises instead of silently losing its gradient."""
    series = {"behaviour_logp": behaviour_logp, "target_logp": target_logp,
              "rewards": rewards, "values": values, "dones": dones}
    T, B = _check_time_major("vtrace_cuda", series, last_value)
    for name, x in (*series.items(), ("last_value", last_value)):
        if x.requires_grad:
            raise ValueError(f"vtrace_cuda: {name} requires grad; detach it (stop-gradient)")
    device = rewards.device
    vs = torch.empty_like(rewards)
    pg = torch.empty_like(rewards)
    if B == 0:
        return vs, pg
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.vtrace_launch(
            behaviour_logp.data_ptr(), target_logp.data_ptr(), rewards.data_ptr(),
            values.data_ptr(), dones.data_ptr(), last_value.data_ptr(), vs.data_ptr(),
            pg.data_ptr(), T, B, gamma, rho_clip, c_clip, stream,
        )
    check(lib, rc, "vtrace_cuda")
    VTRACE_LAUNCHES.add()
    return vs, pg
