"""Meshes for the dry run and for one card (PyTorch port of
``repro/launch/mesh.py``).

Defined as functions (never module-level constants), so importing this
module touches no process group and no device.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.sharding import make_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu") -> Any:
    """16 x 16 = 256 devices per pod; 2 pods = 512 with a 'pod' axis.

    It needs a default process group of 256 or 512 ranks: on one machine
    that exists only under the dry run's ``"fake"`` backend
    (``repro_torch.launch.dryrun``), whose collectives move nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(device: Any = "cuda") -> Any:
    """A (1, 1) ``('data', 'model')`` mesh on the caller's device (the card
    unless the caller passes ``device="cpu"``): every placement on it is
    ``Replicate()``."""
    return make_mesh((1, 1), ("data", "model"), torch.device(device).type)
