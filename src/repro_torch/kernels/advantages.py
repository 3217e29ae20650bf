"""Fused GAE on the GPU: wrapper of the hand-written CUDA kernel
``csrc/gae.cu`` (the port of ``repro/kernels/advantages.py::gae_pallas``).

The kernel takes time-major float32 ``[T, B]`` rewards, values and dones and
a ``[B]`` bootstrap value, contiguous on one CUDA device; trailing dims
beyond T are flattened into B, as in the reference.  Anything else raises:
the plain version (``repro_torch.rl.advantages.gae``) serves CPU tensors
through ``repro_torch.kernels.ops.fused_gae``, never a CUDA call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library

__all__ = ["gae_cuda", "GAE_LAUNCHES"]

GAE_LAUNCHES = LaunchCounter("gae")


def _require(name: str, x: torch.Tensor, shape: Tuple[int, ...], device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(
            f"gae_cuda: {name} must be float32 on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"gae_cuda: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"gae_cuda: {name} must be contiguous")


def gae_cuda(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused GAE; same contract as ``repro_torch.rl.advantages.gae``."""
    device = rewards.device
    if device.type != "cuda":
        raise ValueError(f"gae_cuda: tensors must be on a CUDA device, got {device}")
    shape = tuple(rewards.shape)
    if len(shape) < 1 or shape[0] < 1:
        raise ValueError(f"gae_cuda: rewards must be time-major [T, ...] with T >= 1, got {shape}")
    for name, x in (("rewards", rewards), ("values", values), ("dones", dones)):
        _require(name, x, shape, device)
    _require("last_value", last_value, shape[1:], device)
    T = shape[0]
    B = rewards[0].numel()
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
