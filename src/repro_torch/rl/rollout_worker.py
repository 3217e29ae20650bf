"""RolloutWorker: the actor target of the dataflow plans (PyTorch port of
``repro/rl/rollout_worker.py``).

Owns a batched env, a policy, its parameters and optimizer state, and a
``torch.Generator``, all on one device.  Where the reference compiles the
T-step rollout into one ``lax.scan``, the port runs it as a loop of eager
batched steps on the device and ends it with the GAE kernel; the learner
step is autograd through the surrogate kernels plus the hand-written Adam.
The dataflow layer composes workers through the same protocol as the
reference (sample / get_weights / set_weights / compute_gradients /
apply_gradients / learn_on_batch / episode_stats / get_state / set_state).

Weights cross workers by value: ``get_weights`` returns detached clones and
``set_weights`` copies into the worker's own tensors.  The reference can
share one weights object between workers because JAX arrays are immutable;
here a shared tensor would let one worker see another's update mid-rollout.

The worker runs on the GPU unless the caller asks for the CPU
(``device="cpu"``); with ``device="cuda"`` and no CUDA device it raises.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import fused_gae as gae
from repro_torch.optim import Optimizer, adam
from repro_torch.rl.env import Env
from repro_torch.rl.sample_batch import SampleBatch
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["RolloutWorker"]


def _to_numpy_batch(cols: Dict[str, torch.Tensor]) -> SampleBatch:
    """[T, B, ...] device tensors -> batch-major flattened numpy SampleBatch.

    Batch-major flattening keeps each env's length-T trace contiguous.
    """
    out = {}
    for k, v in cols.items():
        v = v.detach().cpu().numpy().swapaxes(0, 1)  # [B, T, ...]
        out[k] = np.ascontiguousarray(v.reshape((-1,) + v.shape[2:]))
    return SampleBatch(out)


def _resolve_device(device: Any) -> torch.device:
    """The worker's device; a CUDA request without a CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "RolloutWorker(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return device


class RolloutWorker:
    def __init__(
        self,
        env: Env,
        policy: Any,
        algo: str = "pg",  # pg | ppo
        num_envs: int = 4,
        rollout_len: int = 64,
        optimizer: Optional[Optimizer] = None,
        gamma: float = 0.99,
        lam: float = 0.95,
        seed: int = 0,
        worker_index: int = 0,
        device: Any = "cuda",
    ):
        if algo not in ("pg", "ppo"):
            raise NotImplementedError(
                f"algo={algo!r}: the port's RolloutWorker runs 'pg' and 'ppo'"
            )
        self.env = env
        self.policy = policy
        self.algo = algo
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.worker_index = worker_index
        self.device = _resolve_device(device)

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed * 10007 + worker_index)
        self.params = policy.init_params(self._gen)
        self.optimizer = optimizer or adam(3e-4)
        self.opt_state = self.optimizer.init(self.params)

        self._completed: deque = deque(maxlen=100)
        self.env_state, self.obs = env.reset(num_envs, self._gen, self.device)
        self._ep_returns = torch.zeros((num_envs,), dtype=torch.float32, device=self.device)

    # --------------------------------------------------------------- rollout
    @torch.no_grad()
    def _rollout(self) -> Dict[str, torch.Tensor]:
        params, env_state, obs, ep_ret = self.params, self.env_state, self.obs, self._ep_returns
        steps = []
        for _ in range(self.rollout_len):
            action, logp, value, _ = self.policy.act(params, obs, self._gen)
            env_state, next_obs, reward, done = self.env.step(env_state, action, self._gen)
            new_ret = ep_ret + reward
            completed = torch.where(done, new_ret, 0.0)
            ep_ret = torch.where(done, 0.0, new_ret)
            steps.append({
                "obs": obs,
                "actions": action,
                "rewards": reward,
                "dones": done.float(),
                "logp": logp,
                "values": value,
                "next_obs": next_obs,
                "completed": completed,
            })
            obs = next_obs
        cols = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        last_value = self.policy.value(params, obs)
        adv, ret = gae(
            cols["rewards"], cols["values"], cols["dones"], last_value, self.gamma, self.lam
        )
        cols["advantages"] = adv
        cols["returns"] = ret
        self.env_state, self.obs, self._ep_returns = env_state, obs, ep_ret
        return cols

    def sample(self) -> SampleBatch:
        cols = self._rollout()
        completed = cols.pop("completed").cpu().numpy()
        for r in completed[completed != 0.0]:
            self._completed.append(float(r))
        return _to_numpy_batch(cols)

    # ----------------------------------------------------------------- learn
    # Host-side metadata columns that never enter the loss.
    _HOST_COLUMNS = frozenset({"batch_indices", "eps_id"})

    def _device_batch(self, batch: SampleBatch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v, device=self.device)
            for k, v in batch.items()
            if k not in self._HOST_COLUMNS
        }

    def _loss_for(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return self.policy.loss(params, batch)

    def _grads(self, batch: Dict[str, torch.Tensor]):
        with torch.enable_grad():
            params = tree_map(lambda p: p.detach().requires_grad_(True), self.params)
            loss, aux = self._loss_for(params, batch)
            leaves = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
        it = iter(leaves)

        def _grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
            g = next(it)  # tree_map visits leaves in tree_leaves order
            return torch.zeros_like(p) if g is None else g

        grads = tree_map(_grad_or_zeros, params)
        return grads, loss.detach(), {k: v.detach() for k, v in aux.items()}

    @staticmethod
    def _info(loss: torch.Tensor, aux: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        # One device-to-host copy for every scalar of the step.
        values = torch.stack([loss, *aux.values()]).tolist()
        return dict(zip(["loss", *aux], values))

    def learn_on_batch(self, batch: SampleBatch, policy_id: Optional[str] = None) -> Dict[str, Any]:
        grads, loss, aux = self._grads(self._device_batch(batch))
        self.params, self.opt_state = self.optimizer.apply(self.params, grads, self.opt_state)
        return self._info(loss, aux)

    def compute_gradients(self, batch: SampleBatch) -> Tuple[PyTree, Dict[str, Any]]:
        grads, loss, _ = self._grads(self._device_batch(batch))
        return grads, {"loss": float(loss), "batch_count": batch.count}

    def apply_gradients(self, grads: PyTree) -> None:
        self.params, self.opt_state = self.optimizer.apply(self.params, grads, self.opt_state)

    # ------------------------------------------------------------- messaging
    def get_weights(self) -> PyTree:
        return tree_map(lambda p: p.detach().clone(), self.params)

    @torch.no_grad()
    def set_weights(self, weights: PyTree) -> None:
        """Copy ``weights`` (tensors, or numpy arrays as ``interop`` gives
        them) into this worker's own parameter tensors."""

        def _copy(p: torch.Tensor, w: Any) -> None:
            p.copy_(w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w)))

        tree_map(_copy, self.params, weights)

    def episode_stats(self) -> Dict[str, float]:
        if not self._completed:
            return {"episode_reward_mean": float("nan"), "episodes": 0}
        return {
            "episode_reward_mean": float(np.mean(self._completed)),
            "episodes": len(self._completed),
        }

    # ------------------------------------------------------------ durability
    def get_state(self) -> Dict[str, Any]:
        """Resumable rollout-side state (weights travel separately): env
        auto-reset state, generator state, episode stats."""
        return {
            "generator": self._gen.get_state().numpy(),
            "env_state": [np.asarray(x.cpu()) for x in self.env_state],
            "obs": self.obs.cpu().numpy(),
            "ep_returns": self._ep_returns.cpu().numpy(),
            "completed": list(self._completed),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self._gen.set_state(torch.as_tensor(state["generator"]))
        self.env_state = type(self.env_state)(
            *(torch.as_tensor(x, device=self.device) for x in state["env_state"])
        )
        self.obs = torch.as_tensor(state["obs"], device=self.device)
        self._ep_returns = torch.as_tensor(state["ep_returns"], device=self.device)
        self._completed = deque(state["completed"], maxlen=100)
