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

``VectorizedRolloutWorker`` is the vectorized engine over a ``VectorEnv``:
one batched policy dispatch per step, per-episode fragments with globally
unique ``eps_id`` labels, truncation-aware GAE, and the cached-decode path
(``decode="cache"``) that carries an LM's per-lane KV cache through the
rollout.

The workers run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with ``device="cuda"`` and no CUDA device they raise.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import fused_gae as gae
from repro_torch.optim import Optimizer, adam
from repro_torch.rl.env import Env, VectorEnv
from repro_torch.rl.sample_batch import SampleBatch
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["RolloutWorker", "VectorizedRolloutWorker", "assemble_fragments", "MAX_LANES", "EPS_STRIDE"]

# Episode-id layout: eps_id = (worker_index * MAX_LANES + lane) * EPS_STRIDE
# + per-lane episode counter.  int64 gives ~2^43 worker-lanes' headroom.
MAX_LANES = 4096
EPS_STRIDE = 1 << 20


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_numpy_batch(cols: Dict[str, Any]) -> SampleBatch:
    """[T, B, ...] device tensors -> batch-major flattened numpy SampleBatch.

    Batch-major flattening keeps each env's length-T trace contiguous.
    """
    out = {}
    for k, v in cols.items():
        v = _host(v).swapaxes(0, 1)  # [B, T, ...]
        out[k] = np.ascontiguousarray(v.reshape((-1,) + v.shape[2:]))
    return SampleBatch(out)


def assemble_fragments(cols: Dict[str, Any], lane_base: np.ndarray) -> SampleBatch:
    """[T, B, ...] rollout columns -> one batch-major SampleBatch whose rows
    carry globally unique int64 ``eps_id`` episode-fragment labels.

    The ``eps_count`` column (each step's per-lane episode index, int32) is
    consumed and replaced by ``eps_id = lane_base[lane] * EPS_STRIDE +
    eps_count``; ``lane_base`` must be globally unique per (worker, lane)
    (see ``MAX_LANES``).  Row order is batch-major, so every lane's length-T
    trace stays contiguous and, within a lane, episode fragments are
    contiguous runs.
    """
    cols = dict(cols)
    eps_count = _host(cols.pop("eps_count"))  # [T, B]
    batch = _to_numpy_batch(cols)
    lane_base = np.asarray(lane_base, np.int64)
    if lane_base.shape != (eps_count.shape[1],):
        raise ValueError(
            f"lane_base shape {lane_base.shape} != (num_lanes,)={eps_count.shape[1:2]}"
        )
    eps_id = lane_base[:, None] * EPS_STRIDE + eps_count.T.astype(np.int64)  # [B, T]
    batch["eps_id"] = eps_id.reshape(-1)
    return batch


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
        self._init_env_state()

    def _init_env_state(self) -> None:
        """Build the worker's env-side state (subclass hook: the vectorized
        engine keeps a ``VectorEnv`` state instead)."""
        self.env_state, self.obs = self.env.reset(self.num_envs, self._gen, self.device)
        self._ep_returns = torch.zeros((self.num_envs,), dtype=torch.float32, device=self.device)

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


def _child_generator(parent: torch.Generator, device: torch.device) -> torch.Generator:
    """A new generator on ``device`` seeded by a draw from ``parent``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=parent, device=parent.device).item())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class VectorizedRolloutWorker(RolloutWorker):
    """Vectorized rollout engine: a ``VectorEnv`` stepped with one batched
    policy dispatch per step (PyTorch port of the reference's
    ``VectorizedRolloutWorker``, local inference).

      * env auto-reset and episode accounting live in a ``VectorEnvState``
        with its own generator; acting draws from ``act_rng``.  Both, and
        the lane state, are part of ``get_state``/``set_state``;
      * batches are per-episode fragments: every row carries a globally
        unique int64 ``eps_id``, plus ``terminateds``/``truncateds``;
      * GAE runs through ``ops.fused_gae`` with truncation-aware bootstrap:
        at a truncated step the value of the TRUE pre-reset next obs is
        folded into the reward;
      * ``decode="cache"``: a policy with the stateful protocol
        (``init_lane_state``/``compute_actions_stateful``) carries per-lane
        model state, an LM's KV cache, through the rollout, so acting is one
        decode step per token instead of a full forward.

    The reference's decoupled inference (``inference="server"``) is not
    ported yet and raises ``NotImplementedError``.
    """

    def __init__(
        self,
        env: Env,
        policy: Any,
        algo: str = "pg",
        num_envs: int = 8,
        rollout_len: int = 64,
        inference: str = "local",
        decode: str = "forward",
        **kwargs: Any,
    ):
        if inference == "server":
            raise NotImplementedError(
                "inference='server' needs rl/inference.py, which is not ported to repro_torch yet"
            )
        if inference != "local":
            raise ValueError(f"unknown inference mode {inference!r}")
        if decode not in ("forward", "cache"):
            raise ValueError(f"unknown decode mode {decode!r}")
        if decode == "cache" and not hasattr(policy, "init_lane_state"):
            raise ValueError(
                "decode='cache' needs a stateful policy "
                "(init_lane_state/compute_actions_stateful)"
            )
        self.inference = inference
        self.decode = decode
        super().__init__(env, policy, algo=algo, num_envs=num_envs, rollout_len=rollout_len, **kwargs)

    # ------------------------------------------------------------ state init
    def _rebuild_plumbing(self) -> None:
        """(Re)derive what depends on ``self.num_envs``: the VectorEnv and
        the lane-id bases."""
        if self.num_envs > MAX_LANES:
            raise ValueError(f"num_envs {self.num_envs} > MAX_LANES {MAX_LANES}")
        self.venv = VectorEnv(self.env, self.num_envs)
        self._lane_base = self.worker_index * MAX_LANES + np.arange(self.num_envs, dtype=np.int64)

    def _init_env_state(self) -> None:
        self._rebuild_plumbing()
        self.vstate = self.venv.reset(_child_generator(self._gen, self.device))
        self.act_rng = _child_generator(self._gen, self.device)
        self._reset_lane_state()

    def _reset_lane_state(self) -> None:
        """Fresh per-lane model state for the cached-decode path (an empty
        dict when decode='forward')."""
        self.lane_state = (
            self.policy.init_lane_state(self.num_envs, self.device) if self.decode == "cache" else {}
        )

    # -------------------------------------------------------------- lowering
    def configure_vectorization(
        self,
        vector: Optional[int] = None,
        inference: Optional[str] = None,
        client: Any = None,
        decode: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Reconfigure lanes / inference mode / decode path (FlowSpec
        annotation lowering).

        Resizing rebuilds the ``VectorEnv`` with fresh generators derived
        from the worker's; ``inference='server'`` without a client stays
        local (flagged in the ack) and with one raises, since the serving
        tier is not ported; ``decode='cache'`` on a policy without the
        stateful protocol falls back to ``'forward'`` likewise.
        """
        if vector is not None and int(vector) != self.num_envs:
            self.num_envs = int(vector)
            self._init_env_state()
        if inference is not None:
            if inference not in ("local", "server"):
                raise ValueError(f"unknown inference mode {inference!r}")
            if inference == "server" and client is not None:
                raise NotImplementedError(
                    "inference='server' needs rl/inference.py, which is not ported to repro_torch yet"
                )
            self.inference = "local"
        if decode is not None:
            if decode not in ("forward", "cache"):
                raise ValueError(f"unknown decode mode {decode!r}")
            if decode == "cache" and not hasattr(self.policy, "init_lane_state"):
                decode = "forward"
            if decode != self.decode:
                self.decode = decode
                self._reset_lane_state()
        return {"vector": self.num_envs, "inference": self.inference, "decode": self.decode}

    # --------------------------------------------------------------- rollout
    @torch.no_grad()
    def _vrollout(self) -> Dict[str, torch.Tensor]:
        params, vstate, lstate = self.params, self.vstate, self.lane_state
        steps = []
        for _ in range(self.rollout_len):
            obs = vstate.obs
            if self.decode == "cache":
                action, logp, value, lstate = self.policy.compute_actions_stateful(
                    params, obs, self.act_rng, lstate
                )
            else:
                action, logp, value, _ = self.policy.compute_actions(params, obs, self.act_rng)
            vstate, out = self.venv.step(vstate, action)
            steps.append({
                "obs": obs,
                "actions": action,
                "rewards": out.reward,
                "dones": out.done.float(),
                "terminateds": out.terminated.float(),
                "truncateds": out.truncated.float(),
                "logp": logp,
                "values": value,
                "next_obs": out.next_obs,
                "completed": out.completed_return,
                "eps_count": out.eps_count,
            })
        self.vstate, self.lane_state = vstate, lstate
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    @torch.no_grad()
    def _postprocess_cols(self, params: PyTree, cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Advantage columns over [T, B] rollout columns.  Truncation
        bootstrap: the successor value (true pre-reset next obs) is folded
        into the reward at truncated steps, then ``fused_gae`` runs with
        ``dones`` as the accumulation mask."""
        cols = dict(cols)
        v_next = self.policy.value(params, cols["next_obs"])
        rewards_adj = cols["rewards"] + self.gamma * v_next * cols["truncateds"]
        adv, ret = gae(rewards_adj, cols["values"], cols["dones"], v_next[-1], self.gamma, self.lam)
        cols["advantages"] = adv
        cols["returns"] = ret
        return cols

    def _record_completed(self, completed: np.ndarray) -> None:
        flat = completed.T.reshape(-1)
        for r in flat[flat != 0.0]:
            self._completed.append(float(r))

    def sample(self) -> SampleBatch:
        cols = self._postprocess_cols(self.params, self._vrollout())
        self._record_completed(_host(cols.pop("completed")))
        return assemble_fragments(cols, self._lane_base)

    # ------------------------------------------------------------ durability
    def get_state(self) -> Dict[str, Any]:
        state = {
            "generator": self._gen.get_state().numpy(),
            "vstate": VectorEnv.state_to_numpy(self.vstate),
            "act_rng": self.act_rng.get_state().numpy(),
            "completed": list(self._completed),
        }
        if self.decode == "cache":
            state["lane_state"] = tree_map(_host, self.lane_state)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._gen.set_state(torch.as_tensor(state["generator"]))
        self.vstate = VectorEnv.state_from_numpy(state["vstate"], self.device)
        self.act_rng.set_state(torch.as_tensor(state["act_rng"]))
        self._completed = deque(state["completed"], maxlen=100)
        # Adopt the checkpoint's lane count.
        lanes = int(self.vstate.obs.shape[0])
        if lanes != self.num_envs:
            self.num_envs = lanes
            self._rebuild_plumbing()
        if self.decode == "cache":
            ls = state.get("lane_state")
            # A checkpoint without lane state (taken under decode='forward')
            # restores to fresh caches; stale caches self-heal anyway (the
            # policy re-prefills any lane whose cache position disagrees
            # with its observation).
            self.lane_state = (
                tree_map(lambda x: torch.as_tensor(x, device=self.device), ls)
                if ls is not None
                else self.policy.init_lane_state(self.num_envs, self.device)
            )

    def episode_stats(self) -> Dict[str, float]:
        stats = super().episode_stats()
        # Only the server inference path drops fragments; it is not ported.
        stats["fragments_dropped"] = 0.0
        return stats
