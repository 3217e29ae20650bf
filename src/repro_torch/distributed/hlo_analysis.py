"""Roofline terms from a step's counted cost (PyTorch port of
``repro/distributed/hlo_analysis.py``).

The port has no HLO: ``hlo_cost.analyze_step`` counts the FLOPs, bytes and
collectives of the aten ops a step dispatches.  ``collective_bytes`` sums
the collectives it recorded by kind (the §Roofline collective term's
numerator) and ``roofline`` combines them with the FLOP and byte counts
into the three roofline terms at a ``Hardware``'s peak rates.

``HW_H100`` holds the rates of NVIDIA's H100 SXM5 80GB data sheet: 67
TFLOP/s fp32 on the CUDA cores (the compute peak here, since every path of
the port is float32; dense TF32 on the tensor cores is 495 TFLOP/s, kept as
``tf32_flops``), 3.35 TB/s of HBM3, and 900 GB/s of NVLink 4 a GPU.  They
are the rates ``chip_smoke.py`` holds its kernels' bounds to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["collective_bytes", "roofline", "Hardware", "Roofline", "HW_H100", "COLLECTIVES"]

# The collective kinds the cost walker records, named as the reference's HLO
# collectives are.
COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def collective_bytes(cost: Any) -> Dict[str, int]:
    """Bytes moved per collective kind (result-buffer sizes), from a
    walker's ``coll_by_kind`` (an ``OpCost`` or a plain dict)."""
    by_kind = getattr(cost, "coll_by_kind", cost) or {}
    out: Dict[str, int] = {k: int(by_kind.get(k, 0)) for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per device, at the paths' precision
    hbm_bw: float            # bytes/s per device
    ici_bw: float            # bytes/s per link per device (NVLink here)
    tf32_flops: float = 0.0  # tensor-core peak, dense TF32 (informational)
    bf16_flops: float = 0.0  # tensor-core peak, dense bf16 (the bf16 kernels' bounds)

    @property
    def ridge(self) -> float:
        """FLOPs a byte at which compute and memory time are equal."""
        return self.peak_flops / self.hbm_bw


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 80GB column.
HW_H100 = Hardware(
    "nvidia-h100-sxm", peak_flops=67e12, hbm_bw=3.35e12, ici_bw=900e9, tf32_flops=495e12,
    bf16_flops=989e12,
)


@dataclasses.dataclass
class Roofline:
    """The three roofline terms of one step.  ``op_flops`` / ``op_bytes``
    are the walker's counts over aten ops (the reference's ``hlo_flops`` /
    ``hlo_bytes`` counted HLO instructions)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    op_flops: float
    op_bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    bytes_per_device: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.op_flops if self.op_flops else 0.0

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "op_flops": self.op_flops,
            "op_bytes": self.op_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
        }


def roofline(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    coll: Dict[str, int],
    model_flops: float,
    hw: Hardware = HW_H100,
    bytes_per_device: Optional[float] = None,
) -> Roofline:
    """cost: {"flops", "bytes accessed"}; coll: ``collective_bytes()`` output.

    The flops and bytes are *global* (whole program, all shards); divide by
    chips for per-device time.  Collective bytes likewise are summed over
    the program; link time uses per-device link bandwidth.
    """
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total", 0))
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        op_flops=flops,
        op_bytes=byts,
        coll_bytes=cbytes,
        compute_s=flops / (chips * hw.peak_flops),
        memory_s=byts / (chips * hw.hbm_bw),
        collective_s=cbytes / (chips * hw.ici_bw),
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
    )
