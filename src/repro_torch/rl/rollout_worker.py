"""RolloutWorker: the actor target of the dataflow plans (PyTorch port of
``repro/rl/rollout_worker.py``).

Owns a batched env, a policy, its parameters (plus target parameters for
the off-policy ``dqn`` and ``sac``) and optimizer state, and a threefry key
chain, all on one device.  Where the reference compiles the
T-step rollout into one ``lax.scan``, the port runs it as a loop of eager
batched steps on the device and ends it with the GAE kernel (``pg`` and
``ppo``; ``vtrace``, ``dqn`` and ``sac`` workers compute no advantages); the
learner step is autograd through the surrogate or V-trace kernels (or the
plain DQN and SAC losses) plus the hand-written optimizer.
The dataflow layer composes workers through the same protocol as the
reference (sample / get_weights / set_weights / compute_gradients /
apply_gradients / learn_on_batch / update_target / episode_stats /
get_state / set_state).

Weights cross workers by value: ``get_weights`` returns detached clones and
``set_weights`` copies into the worker's own tensors; ``update_target``
clones, so the target network never tracks the online one.  The reference can
share one weights object between workers because JAX arrays are immutable;
here a shared tensor would let one worker see another's update mid-rollout.
The learner step never updates in place either: the optimizer builds new
tensors and rebinds ``self.params``, so a ``get_weights`` on another thread
(the IMPALA broadcast gate, while the learner thread runs
``learn_on_batch``) reads either the old or the new weights, never a mix.

Every rollout draw comes from the reference's key chains (``repro_torch.prng``,
bit for bit): the worker's root key ``key(seed * 10007 + worker_index)``
splits into the chain, the parameters' key and the envs' key; each rollout
splits the chain into a key a step, each step's key into the acting key and
the envs' key, and that into a key an env.  So a worker's stream equals the
reference's from the same seed and converted weights, and ``get_state`` /
``set_state`` carry the chain, which makes a restored worker's next rollout
bit-identical.  Two draws stay on a ``torch.Generator`` seeded the same way
(deliberate differences of the port): parameter initialisation (weights
cross between the packages by value, ``repro_torch.interop``) and the
learner's own noise (SAC's loss; MBPO's synthetic rollouts).

``VectorizedRolloutWorker`` is the vectorized engine over a ``VectorEnv``:
one batched policy dispatch per step with per-lane threefry keys, per-episode
fragments with globally unique ``eps_id`` labels, truncation-aware GAE, the
cached-decode path (``decode="cache"``) that carries an LM's per-lane KV
cache through the rollout, and decoupled inference (``inference="server"``)
through the serving tier of ``rl/inference.py``.  ``PerEnvRolloutWorker`` is
its per-env reference loop (one dispatch an env a step, the same key
chains).  ``MultiAgentRolloutWorker`` steps one env of several agents, each
mapped to a policy of its own (the PPO+DQN composition), and returns a
``MultiAgentBatch``.

The workers run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with ``device="cuda"`` and no CUDA device they raise.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.ops import fused_gae as gae
from repro_torch.optim import Optimizer, adam
from repro_torch.rl.env import Env, VectorEnv, VectorEnvState
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = [
    "RolloutWorker",
    "MultiAgentRolloutWorker",
    "VectorizedRolloutWorker",
    "PerEnvRolloutWorker",
    "assemble_fragments",
    "MAX_LANES",
    "EPS_STRIDE",
]

ALGOS = ("pg", "ppo", "vtrace", "dqn", "sac")

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


def _resolve_device(device: Any, worker: str) -> torch.device:
    """The worker's device; a CUDA request without a CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{worker}(device='cuda'): no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return device


def _value_and_grad(loss_fn: Callable[[PyTree], Tuple[torch.Tensor, Dict]], params: PyTree):
    """``(grads, loss, aux)`` of ``loss_fn(params) -> (loss, aux)`` by
    autograd, all detached; a leaf the loss does not reach gets zeros."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(tracked)
        leaves = torch.autograd.grad(loss, tree_leaves(tracked), allow_unused=True)
    it = iter(leaves)

    def _grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
        g = next(it)  # tree_map visits leaves in tree_leaves order
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(_grad_or_zeros, tracked)
    return grads, loss.detach(), {k: v.detach() for k, v in aux.items()}


# Host-side metadata columns that never enter a loss.
_HOST_COLUMNS = frozenset({"batch_indices", "eps_id"})


def _device_batch(batch: SampleBatch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The loss columns as tensors on ``device``.  A read-only column (a
    view into a shared-memory ring slot) is copied: a CPU tensor must not
    alias a buffer it may not write."""
    return {
        k: torch.as_tensor(v if v.flags.writeable else np.array(v), device=device)
        for k, v in batch.items()
        if k not in _HOST_COLUMNS
    }


def _episode_stats(completed: deque) -> Dict[str, float]:
    if not completed:
        return {"episode_reward_mean": float("nan"), "episodes": 0}
    return {"episode_reward_mean": float(np.mean(completed)), "episodes": len(completed)}


@torch.no_grad()
def _copy_into(params: PyTree, weights: PyTree) -> None:
    """Copy ``weights`` (tensors, or numpy arrays as ``interop`` gives them)
    into the tensors of ``params``, which stay the worker's own."""

    def _copy(p: torch.Tensor, w: Any) -> None:
        p.copy_(w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w)))

    tree_map(_copy, params, weights)


class RolloutWorker:
    def __init__(
        self,
        env: Env,
        policy: Any,
        algo: str = "pg",  # pg | ppo | vtrace | dqn | sac
        num_envs: int = 4,
        rollout_len: int = 64,
        optimizer: Optional[Optimizer] = None,
        gamma: float = 0.99,
        lam: float = 0.95,
        epsilon: float = 0.1,
        target_polyak: float = 0.0,  # 0 -> hard target copy
        seed: int = 0,
        worker_index: int = 0,
        device: Any = "cuda",
    ):
        if algo not in ALGOS:
            raise ValueError(f"algo={algo!r}: the RolloutWorker runs {', '.join(ALGOS)}")
        self.env = env
        self.policy = policy
        self.algo = algo
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.epsilon = epsilon
        self.target_polyak = target_polyak
        self.worker_index = worker_index
        self.device = _resolve_device(device, type(self).__name__)

        root = seed * 10007 + worker_index
        self._key, _, ek = prng.split(prng.key(root, self.device), 3)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(root)
        self.params = policy.init_params(self._gen)
        self.update_target()
        self.optimizer = optimizer or adam(3e-4)
        self.opt_state = self.optimizer.init(self.params)

        self._completed: deque = deque(maxlen=100)
        self._init_env_state(ek)

    def _init_env_state(self, ek: torch.Tensor) -> None:
        """Build the worker's env-side state from the envs' key (subclass
        hook: the vectorized engine keeps a ``VectorEnv`` state instead)."""
        self.env_state, self.obs = self.env.reset(prng.split(ek, self.num_envs))
        self._ep_returns = torch.zeros((self.num_envs,), dtype=torch.float32, device=self.device)

    def _next_key(self) -> torch.Tensor:
        """Advance the worker's chain by one split; the split-off key."""
        self._key, k = prng.split(self._key, 2)
        return k

    # --------------------------------------------------------------- rollout
    def _act(self, params: PyTree, obs: torch.Tensor, key: torch.Tensor):
        if self.algo == "dqn":
            return self.policy.act(params, obs, key, self.epsilon)
        return self.policy.act(params, obs, key)

    @torch.no_grad()
    def _rollout(self) -> Dict[str, torch.Tensor]:
        params, env_state, obs, ep_ret = self.params, self.env_state, self.obs, self._ep_returns
        # The reference's chain: a key a step, each split into the acting key
        # and the envs' key, that split into a key an env.  All steps' keys
        # come from three hashes, before the loop.
        step_keys = prng.split(prng.split(self._next_key(), self.rollout_len), 2)  # [T, 2, 2]
        env_keys = prng.split(step_keys[:, 1], self.num_envs)  # [T, N, 2]
        steps = []
        for t in range(self.rollout_len):
            action, logp, value, _ = self._act(params, obs, step_keys[t, 0])
            env_state, next_obs, reward, done = self.env.step(env_state, action, env_keys[t])
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
        if self.algo in ("pg", "ppo"):  # V-trace computes its targets in the loss
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
        return _to_numpy_batch(self._drop_off_policy_columns(cols))

    def sample_with_count(self) -> Tuple[SampleBatch, int]:
        b = self.sample()
        return b, b.count

    def _drop_off_policy_columns(self, cols: Dict[str, Any]) -> Dict[str, Any]:
        """DQN and SAC batches carry no behaviour log-probs or values."""
        if self.algo in ("dqn", "sac"):
            cols = {k: v for k, v in cols.items() if k not in ("logp", "values")}
        return cols

    # ----------------------------------------------------------------- learn
    def _loss_for(self, params: PyTree, target_params: PyTree, batch: Dict[str, torch.Tensor]):
        """The policy's loss; ``target_params`` (no grad) enter the DQN and
        SAC losses, and SAC draws its two noises from the worker's
        generator (the reference draws them from the learner key
        ``_grads`` splits off; a deliberate difference)."""
        if self.algo == "dqn":
            return self.policy.loss(params, target_params, batch)
        if self.algo == "sac":
            return self.policy.loss(params, target_params, batch, self._gen)
        return self.policy.loss(params, batch)

    def _grads(self, batch: Dict[str, torch.Tensor]):
        self._next_key()  # the reference's learner key: the chain advances alike
        return _value_and_grad(lambda p: self._loss_for(p, self.target_params, batch), self.params)

    @staticmethod
    def _info(loss: torch.Tensor, aux: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Stats as host values: every scalar through one device-to-host
        copy as a float, each per-row statistic (DQN's and SAC's
        ``td_error``) as a numpy array."""
        scalars = iter(torch.stack([loss, *(v for v in aux.values() if v.dim() == 0)]).tolist())
        info = {"loss": next(scalars)}
        for name, v in aux.items():
            info[name] = next(scalars) if v.dim() == 0 else v.cpu().numpy()
        return info

    def learn_on_batch(self, batch: SampleBatch, policy_id: Optional[str] = None) -> Dict[str, Any]:
        grads, loss, aux = self._grads(_device_batch(batch, self.device))
        self.params, self.opt_state = self.optimizer.apply(self.params, grads, self.opt_state)
        self._post_update()
        return self._info(loss, aux)

    def _post_update(self) -> None:
        """Per-update side effects beyond the optimizer step: SAC tracks its
        target network by polyak averaging (new tensors, never in place)."""
        if self.algo == "sac" and self.target_polyak > 0:
            tau = self.target_polyak
            self.target_params = tree_map(
                lambda t, p: (1 - tau) * t + tau * p.detach(), self.target_params, self.params
            )

    def compute_gradients(self, batch: SampleBatch) -> Tuple[PyTree, Dict[str, Any]]:
        grads, loss, _ = self._grads(_device_batch(batch, self.device))
        return grads, {"loss": float(loss), "batch_count": batch.count}

    def apply_gradients(self, grads: PyTree) -> None:
        self.params, self.opt_state = self.optimizer.apply(self.params, grads, self.opt_state)

    # ------------------------------------------------------------- messaging
    def get_weights(self) -> PyTree:
        return tree_map(lambda p: p.detach().clone(), self.params)

    def set_weights(self, weights: PyTree) -> None:
        """Copy ``weights`` (tensors, or numpy arrays as ``interop`` gives
        them) into this worker's own parameter tensors."""
        _copy_into(self.params, weights)

    def update_target(self) -> None:
        """Hard target sync: the target network becomes a copy of the
        online weights (a clone: later updates of the online net, in place or
        not, leave it unchanged)."""
        self.target_params = tree_map(lambda p: p.detach().clone(), self.params)

    def episode_stats(self) -> Dict[str, float]:
        return _episode_stats(self._completed)

    # ------------------------------------------------------------ durability
    def get_state(self) -> Dict[str, Any]:
        """Resumable rollout-side state (weights travel separately): the key
        chain (uint32, as the reference's), env auto-reset state, episode
        stats, and the learner's generator."""
        return {
            "key": _host(self._key).astype(np.uint32),
            "generator": self._gen.get_state().numpy(),
            "env_state": [np.asarray(x.cpu()) for x in self.env_state],
            "obs": self.obs.cpu().numpy(),
            "ep_returns": self._ep_returns.cpu().numpy(),
            "completed": list(self._completed),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self._key = _device_key(state["key"], self.device)
        self._gen.set_state(torch.as_tensor(state["generator"]))
        self.env_state = type(self.env_state)(
            *(torch.as_tensor(x, device=self.device) for x in state["env_state"])
        )
        self.obs = torch.as_tensor(state["obs"], device=self.device)
        self._ep_returns = torch.as_tensor(state["ep_returns"], device=self.device)
        self._completed = deque(state["completed"], maxlen=100)

    # --------------------------------------------------------------- MAML
    def inner_adapt(self, batch: SampleBatch) -> None:
        """One inner-loop PG step on worker-local params (first-order MAML)."""
        self.learn_on_batch(batch)

    def reset_inner(self) -> None:
        # Nothing to undo: TrainOneStep's broadcast just copied the meta
        # weights into this worker's own tensors (``set_weights``), over the
        # weights its inner adaptation rebound.
        pass


def _device_key(words: Any, device: torch.device) -> torch.Tensor:
    """Checkpointed key words (uint32, as either package writes them) as
    the port's int64 key tensor on ``device``."""
    return torch.as_tensor(np.asarray(words).astype(np.int64), device=device)


class VectorizedRolloutWorker(RolloutWorker):
    """Vectorized rollout engine: a ``VectorEnv`` stepped with one batched
    policy dispatch per step (PyTorch port of the reference's
    ``VectorizedRolloutWorker``).

      * env auto-reset, per-lane env key chains and episode accounting live
        in a ``VectorEnvState``.  Acting draws from ``act_rng``, ``[N, 2]``
        threefry lane keys, ``fold_in(k_act, i)`` of the envs' key's split
        and split every step as the reference's; a lane's actions therefore
        do not depend on which batch serves it.  The env state, ``act_rng``,
        the worker's chain and the lane state are part of
        ``get_state``/``set_state``;
      * batches are per-episode fragments: every row carries a globally
        unique int64 ``eps_id``, plus ``terminateds``/``truncateds``;
      * GAE runs through ``ops.fused_gae`` with truncation-aware bootstrap:
        at a truncated step the value of the TRUE pre-reset next obs is
        folded into the reward;
      * ``decode="cache"``: a policy with the stateful protocol
        (``init_lane_state``/``compute_actions_stateful``) carries per-lane
        model state, an LM's KV cache, through the rollout, so acting is one
        decode step per token instead of a full forward;
      * ``inference="server"``: actions come from an ``InferenceActor`` (or
        an ``InferenceRouter`` of replicas) through ``inference_client``, one
        request per step with the lanes' obs and keys.  If the server fails
        mid-rollout the in-flight fragment is dropped
        (``num_fragments_dropped``), the client recovers (restart and weight
        re-sync), and sampling resumes from the live env state, up to
        ``max_inference_retries`` times.
    """

    def __init__(
        self,
        env: Env,
        policy: Any,
        algo: str = "pg",
        num_envs: int = 8,
        rollout_len: int = 64,
        inference: str = "local",
        inference_client: Any = None,
        max_inference_retries: int = 3,
        decode: str = "forward",
        **kwargs: Any,
    ):
        if inference not in ("local", "server"):
            raise ValueError(f"unknown inference mode {inference!r}")
        if decode not in ("forward", "cache"):
            raise ValueError(f"unknown decode mode {decode!r}")
        if decode == "cache" and not hasattr(policy, "init_lane_state"):
            raise ValueError(
                "decode='cache' needs a stateful policy "
                "(init_lane_state/compute_actions_stateful)"
            )
        self.inference = inference
        self.inference_client = inference_client
        self.max_inference_retries = max_inference_retries
        self.num_fragments_dropped = 0
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

    def _init_env_state(self, ek: torch.Tensor) -> None:
        self._rebuild_plumbing()
        k_env, k_act = prng.split(ek, 2)
        self.vstate = self.venv.reset(k_env)
        self.act_rng = prng.fold_in(k_act, torch.arange(self.num_envs, device=self.device))
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

        Resizing rebuilds the ``VectorEnv`` with fresh per-lane key chains
        split from the worker's chain; switching to ``'server'`` without a
        client falls back to local inference (flagged in the ack), and
        ``decode='cache'`` on a policy without the stateful protocol falls
        back to ``'forward'`` likewise.
        """
        if vector is not None and int(vector) != self.num_envs:
            self.num_envs = int(vector)
            self._init_env_state(self._next_key())
        if inference is not None:
            if inference not in ("local", "server"):
                raise ValueError(f"unknown inference mode {inference!r}")
            if client is not None:
                self.inference_client = client
            if inference == "server" and self.inference_client is None:
                inference = "local"
            self.inference = inference
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
    def _compute_actions(self, params: PyTree, obs: torch.Tensor, keys: torch.Tensor):
        if self.algo == "dqn":
            return self.policy.compute_actions(params, obs, keys, self.epsilon)
        return self.policy.compute_actions(params, obs, keys)

    @staticmethod
    def _step_columns(obs, action, logp, value, out) -> Dict[str, torch.Tensor]:
        return {
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
        }

    @torch.no_grad()
    def _vrollout(self) -> Dict[str, torch.Tensor]:
        params, vstate, lstate, act_rng = self.params, self.vstate, self.lane_state, self.act_rng
        steps = []
        for _ in range(self.rollout_len):
            act_rng, k_act = VectorEnv._split_lanes(act_rng)
            obs = vstate.obs
            if self.decode == "cache":
                action, logp, value, lstate = self.policy.compute_actions_stateful(
                    params, obs, k_act, lstate
                )
            else:
                action, logp, value, _ = self._compute_actions(params, obs, k_act)
            vstate, out = self.venv.step(vstate, action)
            steps.append(self._step_columns(obs, action, logp, value, out))
        self.vstate, self.lane_state, self.act_rng = vstate, lstate, act_rng
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    @torch.no_grad()
    def _postprocess_cols(self, params: PyTree, cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Advantage columns over [T, B] rollout columns (none for
        ``algo="vtrace"``, whose loss computes its targets).  Truncation
        bootstrap: the successor value (true pre-reset next obs) is folded
        into the reward at truncated steps, then ``fused_gae`` runs with
        ``dones`` as the accumulation mask."""
        cols = dict(cols)
        if self.algo in ("pg", "ppo"):  # V-trace computes its targets in the loss
            v_next = self.policy.value(params, cols["next_obs"])
            rewards_adj = cols["rewards"] + self.gamma * v_next * cols["truncateds"]
            adv, ret = gae(
                rewards_adj, cols["values"], cols["dones"], v_next[-1], self.gamma, self.lam
            )
            cols["advantages"] = adv
            cols["returns"] = ret
        return cols

    def _record_completed(self, completed: np.ndarray) -> None:
        flat = completed.T.reshape(-1)
        for r in flat[flat != 0.0]:
            self._completed.append(float(r))

    def _emit(self, cols: Dict[str, torch.Tensor]) -> SampleBatch:
        """Post-rollout path shared by both inference modes."""
        cols = self._postprocess_cols(self.params, cols)
        self._record_completed(_host(cols.pop("completed")))
        return assemble_fragments(self._drop_off_policy_columns(cols), self._lane_base)

    def sample(self) -> SampleBatch:
        if self.inference == "server":
            return self._sample_server()
        return self._emit(self._vrollout())

    # ---------------------------------------------------- decoupled inference
    def _sample_server(self) -> SampleBatch:
        from repro_torch.rl.inference import InferenceUnavailable

        attempts = 0
        while True:
            try:
                return self._emit(self._server_rollout())
            except InferenceUnavailable:
                # Drop ONLY the in-flight fragment: the env state has advanced
                # to wherever acting stopped; the collected step columns are
                # discarded, emitted batches are untouched.
                self.num_fragments_dropped += 1
                attempts += 1
                if attempts > self.max_inference_retries:
                    raise
                self.inference_client.recover()

    @torch.no_grad()
    def _server_rollout(self) -> Dict[str, torch.Tensor]:
        # Routing clients (InferenceRouter) want the global lane ids so
        # stateful policies can be sticky-routed; plain clients and bare
        # targets keep the two-argument call.
        client = self.inference_client
        lanes = self._lane_base if getattr(client, "wants_lanes", False) else None
        steps = []
        for _ in range(self.rollout_len):
            self.act_rng, k_act = VectorEnv._split_lanes(self.act_rng)
            obs = self.vstate.obs
            request = (_host(obs), _host(k_act).astype(np.uint32))
            if lanes is not None:
                request += (lanes,)
            action, logp, value = (
                torch.as_tensor(x, device=self.device) for x in client.compute_actions(*request)
            )
            self.vstate, out = self.venv.step(self.vstate, action)
            steps.append(self._step_columns(obs, action, logp, value, out))
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    # ------------------------------------------------------------ durability
    def get_state(self) -> Dict[str, Any]:
        state = {
            "key": _host(self._key).astype(np.uint32),
            "generator": self._gen.get_state().numpy(),
            "vstate": VectorEnv.state_to_numpy(self.vstate),
            "act_rng": _host(self.act_rng).astype(np.uint32),
            "completed": list(self._completed),
            "num_fragments_dropped": self.num_fragments_dropped,
        }
        if self.decode == "cache":
            state["lane_state"] = tree_map(_host, self.lane_state)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._key = _device_key(state["key"], self.device)
        self._gen.set_state(torch.as_tensor(state["generator"]))
        self.vstate = VectorEnv.state_from_numpy(state["vstate"], self.device)
        self.act_rng = _device_key(state["act_rng"], self.device)
        self._completed = deque(state["completed"], maxlen=100)
        self.num_fragments_dropped = int(state.get("num_fragments_dropped", 0))
        # Adopt the checkpoint's lane count: a state saved at vector=8
        # restored into a worker configured vector=4 must not leave stale
        # lane plumbing behind.
        lanes = int(self.act_rng.shape[0])
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
        stats["fragments_dropped"] = float(self.num_fragments_dropped)
        return stats


class PerEnvRolloutWorker(VectorizedRolloutWorker):
    """The per-env reference loop: one policy dispatch *per env per step*.

    The same key chains, env stepping and fragment assembly as
    ``VectorizedRolloutWorker``; only the inference dispatch differs (N
    single-row ``act`` calls, each with its lane's key, instead of one
    batched call).  For elementwise envs and policies (``StubEnv`` +
    ``DummyPolicy``) the two engines are bit-identical, which the
    determinism suite pins down.
    """

    def _rebuild_plumbing(self) -> None:
        super()._rebuild_plumbing()
        # Each lane steps through an N=1 VectorEnv over its slice of the
        # state: a lane's step is elementwise, so its key chain and its
        # values equal lane i of the N-wide step.
        self._venv1 = VectorEnv(self.env, 1)

    @staticmethod
    def _lane(state: VectorEnvState, i: int) -> VectorEnvState:
        es = state.env_state
        rest = (x[i : i + 1] for x in state[1:])
        return VectorEnvState(type(es)(*(x[i : i + 1] for x in es)), *rest)

    @staticmethod
    def _concat(lanes: List[VectorEnvState]) -> VectorEnvState:
        es = [lane.env_state for lane in lanes]
        fields = (torch.cat(xs, dim=0) for xs in zip(*(lane[1:] for lane in lanes)))
        return VectorEnvState(type(es[0])(*(torch.cat(xs, dim=0) for xs in zip(*es))), *fields)

    @torch.no_grad()
    def sample(self) -> SampleBatch:
        if self.inference == "server" or self.decode == "cache":
            return super().sample()
        lanes = [self._lane(self.vstate, i) for i in range(self.num_envs)]
        act_rng, steps = self.act_rng, []
        for _ in range(self.rollout_len):
            act_rng, k_act = VectorEnv._split_lanes(act_rng)
            per_lane = []
            for i in range(self.num_envs):
                obs_i = lanes[i].obs
                a, logp, value, _ = self._act(self.params, obs_i, k_act[i])
                lanes[i], out = self._venv1.step(lanes[i], a)
                per_lane.append(self._step_columns(obs_i, a, logp, value, out))
            steps.append({k: torch.cat([p[k] for p in per_lane]) for k in per_lane[0]})
        self.act_rng = act_rng
        self.vstate = self._concat(lanes)
        return self._emit({k: torch.stack([s[k] for s in steps]) for k in steps[0]})


class MultiAgentRolloutWorker:
    """Multi-policy rollouts for the PPO+DQN composition (paper §5.3).

    Each agent index is mapped to a policy id; per-policy experiences are
    returned as a ``MultiAgentBatch``.  Policies may use different
    algorithms (PPO and DQN here), which is exactly the composition the
    paper enables.  Each rollout ends in one GAE over all agents' ``[T, A]``
    columns (the GAE kernel on the card), bootstrapped from zero as in the
    reference, before the columns are split per policy; DQN policies' batches
    drop ``logp``, ``values``, ``advantages`` and ``returns``.

    Weights cross workers by value, as ``RolloutWorker``'s do: ``get_weights``
    returns detached clones per policy id and ``set_weights`` copies each
    given policy's weights into this worker's own tensors (the reference
    updates its dict with the caller's arrays, which a torch tensor changed in
    place would turn into a shared weight).
    """

    def __init__(
        self,
        env: Any,  # MultiAgentCartPole
        policy_specs: Dict[str, Dict[str, Any]],
        agent_to_policy: Dict[int, str],
        rollout_len: int = 32,
        gamma: float = 0.99,
        lam: float = 0.95,
        epsilon: float = 0.1,
        seed: int = 0,
        worker_index: int = 0,
        device: Any = "cuda",
    ):
        self.env = env
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.epsilon = epsilon
        self.agent_to_policy = dict(agent_to_policy)
        self.worker_index = worker_index
        self.device = _resolve_device(device, type(self).__name__)
        root = seed * 7919 + worker_index
        self._key = prng.key(root, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(root)

        self.policies: Dict[str, Any] = {}
        self.params: Dict[str, PyTree] = {}
        self.target_params: Dict[str, PyTree] = {}
        self.optimizers: Dict[str, Optimizer] = {}
        self.opt_states: Dict[str, PyTree] = {}
        self.algos: Dict[str, str] = {}
        for pid, spec in policy_specs.items():  # params drawn in the specs' order
            self._next_key()  # the reference's parameter key: the chain advances alike
            self.policies[pid] = spec["policy"]
            self.algos[pid] = spec.get("algo", "ppo")
            self.params[pid] = spec["policy"].init_params(self._gen)
            self.target_params[pid] = tree_map(lambda p: p.detach().clone(), self.params[pid])
            self.optimizers[pid] = spec.get("optimizer") or adam(3e-4)
            self.opt_states[pid] = self.optimizers[pid].init(self.params[pid])
        # Agents grouped by policy, as index tensors on the device.
        self._agents = {
            pid: torch.tensor(
                [a for a, p in self.agent_to_policy.items() if p == pid],
                dtype=torch.int64, device=self.device,
            )
            for pid in self.policies
        }

        self.env_state, self.obs = env.reset(self._next_key())
        self._ep_returns = torch.zeros((env.num_agents,), dtype=torch.float32, device=self.device)
        self._completed: deque = deque(maxlen=100)

    def _next_key(self) -> torch.Tensor:
        """Advance the worker's chain by one split; the split-off key."""
        self._key, k = prng.split(self._key, 2)
        return k

    # --------------------------------------------------------------- rollout
    @torch.no_grad()
    def _rollout(self) -> Dict[str, torch.Tensor]:
        A, dev = self.env.num_agents, self.device
        env_state, obs, ep_ret = self.env_state, self.obs, self._ep_returns
        # A key a step, split into the acting key (every policy's) and the
        # env's, as the reference's chain.
        step_keys = prng.split(prng.split(self._next_key(), self.rollout_len), 2)  # [T, 2, 2]
        steps = []
        for t in range(self.rollout_len):
            k_act, k_env = step_keys[t]
            actions = torch.zeros((A,), dtype=torch.int64, device=dev)
            logps = torch.zeros((A,), dtype=torch.float32, device=dev)
            values = torch.zeros((A,), dtype=torch.float32, device=dev)
            for pid, pol in self.policies.items():
                idx = self._agents[pid]
                o = obs.index_select(0, idx)
                if self.algos[pid] == "dqn":
                    a, lp, v, _ = pol.act(self.params[pid], o, k_act, self.epsilon)
                else:
                    a, lp, v, _ = pol.act(self.params[pid], o, k_act)
                actions.index_copy_(0, idx, a)
                logps.index_copy_(0, idx, lp)
                values.index_copy_(0, idx, v)
            env_state, next_obs, reward, done = self.env.step(env_state, actions, k_env)
            new_ret = ep_ret + reward
            completed = torch.where(done, new_ret, 0.0)
            ep_ret = torch.where(done, 0.0, new_ret)
            steps.append({
                "obs": obs,
                "actions": actions,
                "rewards": reward,
                "dones": done.float(),
                "logp": logps,
                "values": values,
                "next_obs": next_obs,
                "completed": completed,
            })
            obs = next_obs
        cols = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        # The reference bootstraps every agent from zero, not from the value
        # of its last observation; the port reproduces it.
        adv, ret = gae(
            cols["rewards"], cols["values"], cols["dones"], torch.zeros_like(ep_ret),
            self.gamma, self.lam,
        )
        cols["advantages"] = adv
        cols["returns"] = ret
        self.env_state, self.obs, self._ep_returns = env_state, obs, ep_ret
        return cols

    _DQN_DROPPED = frozenset({"logp", "values", "advantages", "returns"})

    def sample(self) -> MultiAgentBatch:
        cols = self._rollout()
        completed = cols.pop("completed").cpu().numpy()
        for r in completed[completed != 0.0]:
            self._completed.append(float(r))
        # Split per policy: columns are [T, A, ...].
        batches = {}
        for pid in self.policies:
            idx = self._agents[pid]
            drop = self._DQN_DROPPED if self.algos[pid] == "dqn" else ()
            batches[pid] = _to_numpy_batch(
                {k: v.index_select(1, idx) for k, v in cols.items() if k not in drop}
            )
        return MultiAgentBatch(batches)

    # ----------------------------------------------------------------- learn
    def learn_on_batch(self, batch: SampleBatch, policy_id: str = "ppo_policy") -> Dict[str, Any]:
        """One update of ``policy_id``: its loss (DQN against its target
        weights), autograd and its optimizer.  Returns the loss as a float
        and, for DQN, the per-row ``td_error`` as a numpy array."""
        dev = _device_batch(batch, self.device)
        self._next_key()  # the reference's learner key: the chain advances alike
        pol = self.policies[policy_id]
        if self.algos[policy_id] == "dqn":
            target = self.target_params[policy_id]
            loss_fn = lambda p: pol.loss(p, target, dev)  # noqa: E731
        else:
            loss_fn = lambda p: pol.loss(p, dev)  # noqa: E731
        grads, loss, aux = _value_and_grad(loss_fn, self.params[policy_id])
        self.params[policy_id], self.opt_states[policy_id] = self.optimizers[policy_id].apply(
            self.params[policy_id], grads, self.opt_states[policy_id]
        )
        info: Dict[str, Any] = {"loss": float(loss)}
        if "td_error" in aux:
            info["td_error"] = aux["td_error"].cpu().numpy()
        return info

    def update_target(self) -> None:
        for pid in self.policies:
            if self.algos[pid] == "dqn":
                self.target_params[pid] = tree_map(lambda p: p.detach().clone(), self.params[pid])

    # ------------------------------------------------------------- messaging
    def get_weights(self) -> Dict[str, PyTree]:
        return {pid: tree_map(lambda p: p.detach().clone(), w) for pid, w in self.params.items()}

    def set_weights(self, weights: Dict[str, PyTree]) -> None:
        """Copy each given policy's weights into this worker's own tensors;
        policies not given keep theirs."""
        for pid, w in weights.items():
            _copy_into(self.params[pid], w)

    def episode_stats(self) -> Dict[str, float]:
        return _episode_stats(self._completed)
