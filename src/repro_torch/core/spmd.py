"""The LM learner as one synchronous dataflow fragment (PyTorch port of
``repro/core/spmd.py``).

In the reference, a synchronous fragment (data -> transform -> barrier ->
train -> weight broadcast) lowers to one SPMD step: ``SPMDTrainContext``
binds a model and an optimizer to a mesh and sharding rules and jit-compiles
the step, and ``SPMDLearnerWorker`` plugs it into the host dataflow as the
``learn_on_batch`` of a worker.  The port runs the same fragment on one
explicit device, with no mesh and no sharding rules (those wait for the
sharded-learner slice).  The reference donates the parameter and optimizer
buffers to its step; the port's step updates them in place
(``Optimizer.apply_``), which is what lets a 2.9 B-parameter model and its
AdamW moments train on one 80 GB card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, make_train_step
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["SPMDTrainContext", "SPMDLearnerWorker"]


def _resolve_device(device: Any) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SPMDTrainContext(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return device


class SPMDTrainContext:
    def __init__(self, cfg: ModelConfig, optimizer: Optimizer, device: Any = "cuda"):
        if optimizer.inplace is None:
            raise ValueError("SPMDTrainContext needs an optimizer with an in-place step")
        self.cfg = cfg
        self.model = Model(cfg)
        self.optimizer = optimizer
        self.device = _resolve_device(device)
        self._train_step: Optional[Callable] = None

    def init(self, seed: int = 0) -> Tuple[PyTree, PyTree]:
        """Random parameters (requiring grad) and the optimizer state, made
        on the device from ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init_params(generator)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        with torch.no_grad():
            opt_state = self.optimizer.init(params)
        return params, opt_state

    def train_step(self) -> Callable:
        """The fused sync-fragment step: loss, gradients and the in-place apply."""
        if self._train_step is None:
            self._train_step = make_train_step(self.model, self.optimizer)
        return self._train_step

    def __call__(self, params, opt_state, batch):
        device_batch = {
            k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()
        }
        return self.train_step()(params, opt_state, device_batch)


class SPMDLearnerWorker:
    """Worker-protocol adapter: plugs the step into the dataflow's
    ``TrainOneStep``-shaped stage.  As every worker of the port,
    ``get_weights`` returns detached clones and ``set_weights`` copies into
    the worker's own tensors (the learner updates them in place)."""

    def __init__(self, ctx: SPMDTrainContext, seed: int = 0):
        self.ctx = ctx
        self.params, self.opt_state = ctx.init(seed)
        self.steps = 0

    def learn_on_batch(self, batch: Any, policy_id: Optional[str] = None) -> Dict[str, Any]:
        self.params, self.opt_state, metrics = self.ctx(self.params, self.opt_state, dict(batch))
        self.steps += 1
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self) -> PyTree:
        return tree_map(lambda p: p.detach().clone(), self.params)

    def set_weights(self, weights: PyTree) -> None:
        def copy_in(p: torch.Tensor, w: Any) -> None:
            p.copy_(w if torch.is_tensor(w) else torch.from_numpy(np.array(w)))

        with torch.no_grad():
            tree_map(copy_in, self.params, weights)

    def episode_stats(self) -> Dict[str, Any]:
        return {"episodes": 0, "episode_reward_mean": float("nan")}
