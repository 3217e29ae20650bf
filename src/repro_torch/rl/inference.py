"""Decoupled batched inference: the serving tier of the rollout engine
(PyTorch port of ``repro/rl/inference.py``).

SRL (Mei et al., 2023) and HybridFlow (Sheng et al., 2024) both separate
environment simulation from policy inference: env loops stay cheap and
numerous, while action computation is batched onto dedicated inference
workers.  Here that split rides the existing executor runtime, grown into a
multi-replica serving tier (ISSUE 9):

  * ``AdmissionQueue`` — Orca-style continuous batching: requests are
    admitted/evicted per *dispatch step* (FIFO, up to ``max_occupancy``)
    instead of per fixed batch, with occupancy and admission-latency
    accounting.
  * ``InferenceActor`` — a worker *target* owning a policy + params on one
    device (the card unless the caller passes ``device="cpu"``).  Its native
    surface is ``submit``/``poll``: submissions from *different* clients
    interleaving through the actor mailbox are co-batched into one dispatch
    per serve step.  ``compute_actions`` (submit + drain)
    keeps the original blocking call.  Policies exposing ``init_lane_state``
    / ``compute_actions_stateful`` (KV cache, SSM state — see
    ``repro.rl.stateful_policy``) keep their per-lane recurrent state
    server-side, keyed by global lane id.
  * ``CreditGate`` — a counting semaphore shared by every client of one
    serving tier: at most ``credits`` requests in flight across all shards
    (the PR 3 credit-based backpressure idea applied to the request path).
  * ``InferenceClient`` — the single-replica rollout-worker handle.  On
    actor failure it raises ``InferenceUnavailable`` (the worker drops its
    in-flight fragment); ``recover()`` restarts the actor through the
    supervision path and re-syncs weights before the next rollout begins.
  * ``InferenceRouter`` — N replicas behind the client API: least-loaded
    dispatch for stateless policies, **sticky lane->replica routing** for
    stateful ones (a lane's server-side state lives on exactly one
    replica), per-replica health + weight-version tracking (a replica that
    missed a ``sync_weights`` broadcast is refused until re-synced), and a
    ``restart``/``drop_shard`` recovery path that re-pins orphaned lanes
    with a state reset.

Process-backed *rollout* workers cannot hold a client (actor handles do not
pickle across the RPC boundary), so server inference is lowered only onto
thread-backend rollout workers — ``compile()`` falls back to local
inference elsewhere and says so.

Where the reference's replica shares the caller's immutable weights
(``set_weights`` binds them), a replica here copies them into its own
tensors and ``get_weights`` returns detached clones: a torch tensor changed
in place by the learner must never change what a replica serves.  Requests
and results cross the replica boundary as numpy arrays (obs ``[N, D]``
float32, lane keys ``[N, 2]`` uint32, lane ids int64), as in the reference.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import LatencyStat
from repro_torch.rl.rollout_worker import _copy_into, _resolve_device
from repro_torch.tree import tree_map

__all__ = [
    "AdmissionQueue",
    "InferenceActor",
    "InferenceClient",
    "InferenceRouter",
    "InferenceUnavailable",
    "CreditGate",
]

logger = logging.getLogger(__name__)


class InferenceUnavailable(RuntimeError):
    """The inference server failed mid-request; the caller's in-flight
    rollout fragment must be dropped and the client recovered."""


class CreditGate:
    """Counting semaphore bounding in-flight inference requests.

    One gate is shared by every client of an inference tier, so the bound
    is global across rollout shards.  ``stalls``/``stall_time_s`` mirror the
    data plane's ``num_credit_stalls`` instrumentation.
    """

    def __init__(self, credits: int):
        if credits < 1:
            raise ValueError(f"credits must be >= 1 (got {credits})")
        self.credits = credits
        self._sem = threading.Semaphore(credits)
        self._lock = threading.Lock()
        self.stalls = 0
        self.stall_time_s = 0.0

    def acquire(self) -> None:
        if self._sem.acquire(blocking=False):
            return
        t0 = time.perf_counter()
        self._sem.acquire()
        with self._lock:
            self.stalls += 1
            self.stall_time_s += time.perf_counter() - t0

    def release(self) -> None:
        self._sem.release()


# --------------------------------------------------------------------------
# Continuous batching
# --------------------------------------------------------------------------
class AdmissionQueue:
    """Admission control for continuous batching (Orca-style).

    Requests move ``pending -> active -> (completed | evicted)``; every
    transition happens at a *dispatch step* boundary (``admit``), never per
    fixed batch: a step admits pending requests FIFO up to
    ``max_occupancy`` free slots, serves the whole active set, and the
    server completes (or evicts) them individually.  Invariants the
    property suite pins down:

      * conservation — every submitted id is in exactly one of
        pending/active/completed/evicted at all times;
      * FIFO fairness — ids are admitted in submission order (no pending
        request is overtaken by a later submission);
      * bounded occupancy — ``len(active) <= max_occupancy`` always.

    ``max_occupancy=None`` means unbounded: a whole lane batch admits in
    one step, which keeps single-client serving bit-identical to a fixed
    whole-batch dispatch.
    """

    def __init__(self, max_occupancy: Optional[int] = None):
        if max_occupancy is not None and max_occupancy < 1:
            raise ValueError(f"max_occupancy must be >= 1 (got {max_occupancy})")
        self.max_occupancy = max_occupancy
        self._lock = threading.Lock()
        self._pending: deque = deque()  # (req_id, t_submit)
        self._active: Dict[Any, float] = {}  # req_id -> t_submit
        self.num_submitted = 0
        self.num_admitted = 0
        self.num_completed = 0
        self.num_evicted = 0
        self.occupancy_peak = 0
        self._occ_sum = 0.0
        self._steps = 0
        self.admission_wait = LatencyStat()

    @property
    def occupancy(self) -> int:
        return len(self._active)

    def submit(self, req_id: Any) -> None:
        with self._lock:
            if req_id in self._active or any(r == req_id for r, _ in self._pending):
                raise ValueError(f"request {req_id!r} already queued")
            self._pending.append((req_id, time.perf_counter()))
            self.num_submitted += 1

    def admit(self) -> List[Any]:
        """One dispatch step's admission: pending -> active, FIFO, up to the
        configured occupancy.  Returns the ids admitted *this step* (the
        server batches them together with anything still active)."""
        with self._lock:
            now = time.perf_counter()
            free = (
                len(self._pending)
                if self.max_occupancy is None
                else self.max_occupancy - len(self._active)
            )
            admitted: List[Any] = []
            while self._pending and len(admitted) < max(0, free):
                rid, t0 = self._pending.popleft()
                self._active[rid] = t0
                self.admission_wait.push(now - t0)
                admitted.append(rid)
            self.num_admitted += len(admitted)
            occ = len(self._active)
            self.occupancy_peak = max(self.occupancy_peak, occ)
            self._occ_sum += occ
            self._steps += 1
            return admitted

    def complete(self, ids: Sequence[Any]) -> None:
        with self._lock:
            for rid in ids:
                if rid not in self._active:
                    raise ValueError(f"request {rid!r} is not active")
                del self._active[rid]
                self.num_completed += 1

    def evict(self, ids: Sequence[Any]) -> int:
        """Drop requests (cancel/failure path) from active *or* pending."""
        with self._lock:
            dropped = 0
            for rid in ids:
                if rid in self._active:
                    del self._active[rid]
                    dropped += 1
                else:
                    n = len(self._pending)
                    self._pending = deque(
                        (r, t) for r, t in self._pending if r != rid
                    )
                    dropped += n - len(self._pending)
            self.num_evicted += dropped
            return dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            wait = self.admission_wait.summary()
            return {
                "max_occupancy": -1.0 if self.max_occupancy is None else float(self.max_occupancy),
                "occupancy": float(len(self._active)),
                "occupancy_peak": float(self.occupancy_peak),
                "occupancy_mean": self._occ_sum / self._steps if self._steps else 0.0,
                "num_steps": float(self._steps),
                "num_submitted": float(self.num_submitted),
                "num_admitted": float(self.num_admitted),
                "num_completed": float(self.num_completed),
                "num_evicted": float(self.num_evicted),
                "admission_wait_mean_s": wait["mean"],
                "admission_wait_p50_s": wait["p50"],
                "admission_wait_p99_s": wait["p99"],
            }


# --------------------------------------------------------------------------
# The serving replica
# --------------------------------------------------------------------------
class InferenceActor:
    """Worker target serving batched action requests for one policy.

    Built from a policy *factory* so it is rebuildable by supervision.  Its
    parameters are initialised from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``"cuda"`` by default, which raises without a
    card), and every dispatch runs there.

    The native serving surface is asynchronous: ``submit`` enqueues one
    request per lane row into the admission queue, ``poll`` drives at most
    one serve step when the caller's requests are not done yet.  A serve
    step co-batches *every* admitted request — whichever client submitted
    it — into one dispatch, which is what makes interleaved submissions
    from multiple rollout shards continuous-batched rather than serialized
    per caller.  ``compute_actions`` is submit + drain.

    Stateful policies (``init_lane_state``/``compute_actions_stateful``)
    keep per-lane recurrent state here, keyed by the caller's global lane
    id; ``reset_lanes`` drops it (router re-pin path).
    """

    def __init__(
        self,
        policy_factory: Callable[[], Any],
        algo: str = "pg",
        epsilon: float = 0.1,
        seed: int = 0,
        max_batch: Optional[int] = None,
        device: Any = "cuda",
    ):
        self.device = _resolve_device(device, type(self).__name__)
        self.policy = policy_factory()
        self.algo = algo
        self.epsilon = epsilon
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = self.policy.init_params(gen)
        self.stateful = hasattr(self.policy, "init_lane_state")
        self.num_requests = 0
        self.num_lane_steps = 0
        self.num_dispatches = 0
        self.queue = AdmissionQueue(max_batch)
        self._req_seq = 0
        self._requests: Dict[int, Tuple[np.ndarray, np.ndarray, Optional[int]]] = {}
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._lane_state: Dict[int, Any] = {}

    def _tensor(self, x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device).to(dtype)

    @torch.no_grad()
    def _dispatch(self, params: Any, obs: np.ndarray, keys: np.ndarray):
        obs, keys = self._tensor(obs, torch.float32), self._tensor(keys, torch.int64)
        if self.algo == "dqn":
            return self.policy.compute_actions(params, obs, keys, self.epsilon)
        return self.policy.compute_actions(params, obs, keys)

    @torch.no_grad()
    def _dispatch_stateful(self, params: Any, obs: np.ndarray, keys: np.ndarray, state: Any):
        obs, keys = self._tensor(obs, torch.float32), self._tensor(keys, torch.int64)
        return self.policy.compute_actions_stateful(params, obs, keys, state)

    # ------------------------------------------------------- async serving
    def submit(
        self,
        obs: np.ndarray,
        keys: np.ndarray,
        lanes: Optional[np.ndarray] = None,
    ) -> List[int]:
        """Enqueue one request per lane row; returns the request ids."""
        obs, keys = np.asarray(obs), np.asarray(keys)
        if self.stateful and lanes is None:
            raise ValueError(
                "stateful policy serving needs lanes= (per-row global lane "
                "ids keying the server-side recurrent state)"
            )
        self.num_requests += 1
        self.num_lane_steps += int(obs.shape[0])
        ids: List[int] = []
        for i in range(obs.shape[0]):
            rid = self._req_seq
            self._req_seq += 1
            lane = None if lanes is None else int(np.asarray(lanes)[i])
            self._requests[rid] = (obs[i], keys[i], lane)
            self.queue.submit(rid)
            ids.append(rid)
        return ids

    def serve_step(self) -> int:
        """Admit + dispatch one continuous-batching step; returns the number
        of requests served (0 when nothing is pending).

        The dispatch batch is padded up to the next power of two (row 0
        repeated; padded results discarded), as in the reference, where
        every new batch size would pay an XLA recompile mid-serve; here it
        bounds the set of shapes the card's kernels and cuBLAS see.  Each row
        samples from its own key, so a pure-RNG policy's rows do not depend
        on the batch; where a matmul computes the logits, a float32 row can
        round differently at another batch size (by an ulp or so), which
        the tests bound at 1e-5 with actions equal."""
        ids = self.queue.admit()
        if not ids:
            return 0
        n = len(ids)
        pad = (1 << max(0, n - 1).bit_length()) - n
        rows = [self._requests[rid] for rid in ids]
        obs = np.stack([r[0] for r in rows])
        keys = np.stack([r[1] for r in rows])
        if pad:
            obs = np.concatenate([obs, np.repeat(obs[:1], pad, axis=0)])
            keys = np.concatenate([keys, np.repeat(keys[:1], pad, axis=0)])
        if self.stateful:
            init = None
            states = []
            for r in rows:
                s = self._lane_state.get(r[2])
                if s is None:
                    if init is None:
                        init = self.policy.init_lane_state(1, self.device)
                    s = init
                states.append(s)
            if pad:
                states.append(self.policy.init_lane_state(pad, self.device))
            batch_state = tree_map(lambda *xs: torch.cat(xs, dim=0), *states)
            action, logp, value, new_state = self._dispatch_stateful(
                self.params, obs, keys, batch_state
            )
            for j, r in enumerate(rows):
                self._lane_state[r[2]] = tree_map(lambda x, j=j: x[j : j + 1], new_state)
        else:
            action, logp, value, _ = self._dispatch(self.params, obs, keys)
        action, logp, value = (x.cpu().numpy() for x in (action, logp, value))
        for j, rid in enumerate(ids):
            self._results[rid] = (action[j], logp[j], value[j])
            del self._requests[rid]
        self.queue.complete(ids)
        self.num_dispatches += 1
        return n

    def poll(
        self, ids: Sequence[int]
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Collect results for ``ids``; drives at most one serve step when
        they are not all done yet (returning None — the caller loops)."""
        if not all(rid in self._results for rid in ids):
            self.serve_step()
            if not all(rid in self._results for rid in ids):
                return None
        rows = [self._results.pop(rid) for rid in ids]
        return (
            np.stack([r[0] for r in rows]),
            np.stack([r[1] for r in rows]),
            np.stack([r[2] for r in rows]),
        )

    def discard(self, ids: Sequence[int]) -> int:
        """Cancel requests (failure cleanup): evict queued ones, drop any
        results already computed."""
        dropped = self.queue.evict([rid for rid in ids if rid in self._requests])
        for rid in ids:
            self._requests.pop(rid, None)
            if self._results.pop(rid, None) is not None:
                dropped += 1
        return dropped

    # ---------------------------------------------------- blocking serving
    def compute_actions(
        self,
        obs: np.ndarray,
        keys: np.ndarray,
        lanes: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[N, obs_dim] obs + [N, 2] lane keys -> (actions, logp, values).

        Blocking submit + drain.  With the default unbounded admission this
        is a single whole-batch dispatch — bit-identical to fixed batching;
        with ``max_batch`` set the batch is served in FIFO chunks."""
        ids = self.submit(obs, keys, lanes)
        while True:
            out = self.poll(ids)
            if out is not None:
                return out

    @torch.no_grad()
    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        """Value-only dispatch (GAE bootstrap queries)."""
        return self.policy.value(self.params, self._tensor(obs, torch.float32)).cpu().numpy()

    # --------------------------------------------------------- lane state
    def reset_lanes(self, lanes: Sequence[int]) -> int:
        """Drop server-side recurrent state for ``lanes`` (re-pin path)."""
        n = 0
        for lane in lanes:
            if self._lane_state.pop(int(lane), None) is not None:
                n += 1
        return n

    # ------------------------------------------------------------ messaging
    def set_weights(self, weights: Any) -> None:
        """Copy ``weights`` (tensors on any device, or numpy arrays) into
        this replica's own parameter tensors; the caller's are never held."""
        _copy_into(self.params, weights)

    def get_weights(self) -> Any:
        return tree_map(lambda p: p.detach().clone(), self.params)

    def stats(self) -> Dict[str, Any]:
        return {
            "num_requests": self.num_requests,
            "num_lane_steps": self.num_lane_steps,
            "num_dispatches": self.num_dispatches,
            "stateful": self.stateful,
            "num_lane_states": len(self._lane_state),
            "queue": self.queue.stats(),
        }


class InferenceClient:
    """Rollout-shard handle to a (possibly remote) ``InferenceActor``.

    ``actor`` is either a ``VirtualActor`` wrapping an ``InferenceActor``
    (``.call``/``.sync`` duck-typed) or a bare ``InferenceActor`` (direct
    in-process calls — useful in tests).  ``credits`` bounds requests in
    flight across every client sharing the gate.

    Failure contract: any actor-side failure surfaces as
    ``InferenceUnavailable``.  The *worker* decides what to drop (its
    in-flight fragment); ``recover()`` then heals the server — restart via
    the supervision path, plus a weight re-sync from ``weights_provider``
    (the canonical policy owner, normally the plan's local worker) so the
    restarted actor never serves stale or freshly-reinitialized weights.
    """

    wants_lanes = False  # single replica: no routing key needed

    def __init__(
        self,
        actor: Any,
        credits: Optional[CreditGate] = None,
        weights_provider: Optional[Callable[[], Any]] = None,
    ):
        self.actor = actor
        self.credits = credits
        self.weights_provider = weights_provider
        self.num_failures = 0
        self.num_recoveries = 0

    def _invoke(self, method: str, *args: Any) -> Any:
        actor = self.actor
        if hasattr(actor, "call"):  # VirtualActor
            try:
                return actor.call(method, *args).result()
            except Exception as exc:
                self.num_failures += 1
                raise InferenceUnavailable(
                    f"inference actor {getattr(actor, 'name', actor)!r} failed "
                    f"in {method}(): {exc!r}"
                ) from exc
        try:  # bare target (in-process)
            return getattr(actor, method)(*args)
        except Exception as exc:
            self.num_failures += 1
            raise InferenceUnavailable(f"inference target failed: {exc!r}") from exc

    def compute_actions(
        self,
        obs: np.ndarray,
        keys: np.ndarray,
        lanes: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.credits is not None:
            self.credits.acquire()
        try:
            if lanes is not None:
                return self._invoke("compute_actions", obs, keys, lanes)
            return self._invoke("compute_actions", obs, keys)
        finally:
            if self.credits is not None:
                self.credits.release()

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        return self._invoke("compute_values", obs)

    def sync_weights(self, weights: Any = None) -> None:
        if weights is None and self.weights_provider is not None:
            weights = self.weights_provider()
        if weights is not None:
            self._invoke("set_weights", weights)

    def recover(self) -> None:
        """Heal the server: restart a dead VirtualActor (supervision path),
        then push canonical weights so the fresh target is in sync."""
        actor = self.actor
        if hasattr(actor, "restart") and not getattr(actor, "alive", True):
            actor.restart()
            self.num_recoveries += 1
        self.sync_weights()

    def stop(self) -> None:
        if hasattr(self.actor, "stop"):
            self.actor.stop()


# --------------------------------------------------------------------------
# Multi-replica routing
# --------------------------------------------------------------------------
class _Replica:
    """Router-side record for one serving replica."""

    __slots__ = ("actor", "inflight", "weight_version", "failures")

    def __init__(self, actor: Any):
        self.actor = actor
        self.inflight = 0
        self.weight_version = 0
        self.failures = 0

    @property
    def name(self) -> str:
        return getattr(self.actor, "name", type(self.actor).__name__)

    @property
    def alive(self) -> bool:
        return getattr(self.actor, "alive", True)

    def is_virtual(self) -> bool:
        return hasattr(self.actor, "call")


class _Immediate:
    """Future-shaped wrapper for bare-target results."""

    def __init__(self, value: Any):
        self._value = value

    def result(self) -> Any:
        return self._value


class InferenceRouter:
    """N ``InferenceActor`` replicas behind the ``InferenceClient`` API.

    Dispatch policy:

      * stateless replicas — **least-loaded**: the whole request batch goes
        to the eligible replica with the fewest in-flight requests (whole-
        batch dispatch keeps single-client serving bit-identical to one
        local inference).
      * stateful replicas — **sticky lane->replica routing**: each global
        lane id is pinned to one replica (its KV/SSM state lives there);
        a request batch is partitioned by pin and the sub-batches are
        dispatched concurrently through the replicas' submit/poll surface.

    A replica is *eligible* when it is alive AND its acked weight version
    matches the router's: a replica that was down during a ``sync_weights``
    broadcast — even one restarted out-of-band afterwards — is refused
    until ``recover()`` re-syncs it, so stale weights never serve.

    Failure contract matches ``InferenceClient``: a replica failing
    mid-request raises ``InferenceUnavailable`` (in-flight rows counted in
    ``num_inflight_dropped``; the caller drops its fragment).  ``recover()``
    then heals per ``failure_policy``: ``'restart'`` rebuilds dead replicas
    through supervision and re-syncs weights; ``'drop_shard'`` removes them
    from the set.  Either way, lanes pinned to a lost replica are unpinned
    (their server-side state is gone) and re-pin onto survivors with a
    fresh state — counted in ``num_lane_repins``/``num_lane_state_resets``.
    """

    wants_lanes = True  # sticky routing needs the caller's global lane ids

    def __init__(
        self,
        replicas: Sequence[Any],
        credits: Optional[CreditGate] = None,
        weights_provider: Optional[Callable[[], Any]] = None,
        sticky: Optional[bool] = None,
        failure_policy: str = "restart",
        name: str = "inference-router",
    ):
        if not replicas:
            raise ValueError("InferenceRouter needs at least one replica")
        if failure_policy not in ("restart", "drop_shard"):
            raise ValueError(
                f"failure_policy must be 'restart'|'drop_shard' (got {failure_policy!r})"
            )
        self.name = name
        self.credits = credits
        self.weights_provider = weights_provider
        self.failure_policy = failure_policy
        self.weight_version = 0
        self._replicas: List[_Replica] = [_Replica(a) for a in replicas]
        self._pins: Dict[int, _Replica] = {}
        self._lock = threading.Lock()
        self._recover_lock = threading.Lock()
        self._sticky = sticky
        self.num_requests = 0
        self.num_lane_requests = 0
        self.num_failures = 0  # kept name-compatible with InferenceClient
        self.num_recoveries = 0
        self.num_replica_failures = 0
        self.num_replica_restarts = 0
        self.num_replicas_dropped = 0
        self.num_inflight_dropped = 0
        self.num_lane_repins = 0
        self.num_lane_state_resets = 0

    # ---------------------------------------------------------- inspection
    @property
    def sticky(self) -> bool:
        if self._sticky is None:
            self._sticky = self._probe_stateful()
        return self._sticky

    def _probe_stateful(self) -> bool:
        rep = self._replicas[0]
        if not rep.is_virtual():
            return bool(getattr(rep.actor, "stateful", False))
        try:
            return bool(rep.actor.sync("stats").get("stateful", False))
        except Exception:  # dead/opaque replica: assume stateless
            return False

    def _eligible(self) -> List[_Replica]:
        return [
            r
            for r in self._replicas
            if r.alive and r.weight_version == self.weight_version
        ]

    @property
    def replicas(self) -> List[Any]:
        return [r.actor for r in self._replicas]

    # ------------------------------------------------------------- serving
    def compute_actions(
        self,
        obs: np.ndarray,
        keys: np.ndarray,
        lanes: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.credits is not None:
            self.credits.acquire()
        try:
            return self._route(obs, keys, lanes)
        finally:
            if self.credits is not None:
                self.credits.release()

    def _route(
        self, obs: np.ndarray, keys: np.ndarray, lanes: Optional[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs, keys = np.asarray(obs), np.asarray(keys)
        n = int(obs.shape[0])
        with self._lock:
            self.num_requests += 1
            self.num_lane_requests += n
        eligible = self._eligible()
        if not eligible:
            self.num_failures += 1
            raise InferenceUnavailable(
                f"router {self.name!r}: no eligible replicas "
                f"({len(self._replicas)} known, weight_version={self.weight_version})"
            )
        if self.sticky and lanes is not None:
            groups = self._sticky_groups(np.asarray(lanes), eligible)
        else:
            rep = min(eligible, key=lambda r: r.inflight)
            groups = [(rep, np.arange(n))]
        return self._dispatch_groups(groups, obs, keys, lanes)

    def _sticky_groups(
        self, lanes: np.ndarray, eligible: List[_Replica]
    ) -> List[Tuple[_Replica, np.ndarray]]:
        """Partition rows by pinned replica, pinning new lanes least-loaded.

        All of a request's *new* lanes pin together to one least-loaded
        replica (session affinity): pinning per-lane would shred every
        request into tiny sub-batches across all replicas, destroying the
        batching that makes the tier fast — affinity keeps whole requests
        dispatching as one batch while different clients' lane sets still
        balance across replicas.

        A lane pinned to a replica that is no longer eligible fails the
        request (the pin is only moved by ``recover()``, which also resets
        the lane's server-side state): silently re-pinning here would serve
        from a replica that never saw the lane's recurrent state.
        """
        by_rep: Dict[int, List[int]] = {}
        reps: Dict[int, _Replica] = {}
        with self._lock:
            load = {id(r): r.inflight for r in eligible}
            new_rep: Optional[_Replica] = None
            for i, lane in enumerate(int(x) for x in lanes):
                rep = self._pins.get(lane)
                if rep is None:
                    if new_rep is None:
                        new_rep = min(eligible, key=lambda r: (load[id(r)], r.name))
                    rep = new_rep
                    self._pins[lane] = rep
                elif rep not in self._replicas or not (
                    rep.alive and rep.weight_version == self.weight_version
                ):
                    self.num_failures += 1
                    self.num_replica_failures += 1
                    raise InferenceUnavailable(
                        f"router {self.name!r}: lane {lane} is pinned to "
                        f"ineligible replica {rep.name!r}; recover() to re-pin"
                    )
                load[id(rep)] = load.get(id(rep), 0) + 1
                by_rep.setdefault(id(rep), []).append(i)
                reps[id(rep)] = rep
        return [(reps[k], np.asarray(idx)) for k, idx in by_rep.items()]

    def _dispatch_groups(
        self,
        groups: List[Tuple[_Replica, np.ndarray]],
        obs: np.ndarray,
        keys: np.ndarray,
        lanes: Optional[np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dispatch per-replica sub-batches; submit-all-then-poll so groups
        run concurrently across replicas, then reassemble rows in order."""
        pending: List[Tuple[_Replica, np.ndarray, Any]] = []
        failed: Optional[Tuple[_Replica, int, Exception]] = None
        for rep, idx in groups:
            sub_lanes = None if lanes is None else np.asarray(lanes)[idx]
            with self._lock:
                rep.inflight += len(idx)
            try:
                if rep.is_virtual():
                    ids_f = rep.actor.call("submit", obs[idx], keys[idx], sub_lanes)
                else:
                    ids_f = _Immediate(rep.actor.submit(obs[idx], keys[idx], sub_lanes))
            except Exception as exc:
                with self._lock:
                    rep.inflight -= len(idx)
                failed = (rep, len(idx), exc)
                break
            pending.append((rep, idx, ids_f))

        out: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
        for rep, idx, ids_f in pending:
            if failed is not None:
                self._discard_group(rep, idx, ids_f)
                continue
            try:
                ids = ids_f.result()
                while True:
                    if rep.is_virtual():
                        res = rep.actor.call("poll", ids).result()
                    else:
                        res = rep.actor.poll(ids)
                    if res is not None:
                        break
                out.append(res)
            except Exception as exc:
                failed = (rep, len(idx), exc)
            finally:
                with self._lock:
                    rep.inflight -= len(idx)
        if failed is not None:
            rep, nrows, exc = failed
            with self._lock:
                rep.failures += 1
                self.num_failures += 1
                self.num_replica_failures += 1
                self.num_inflight_dropped += nrows
            raise InferenceUnavailable(
                f"router {self.name!r}: replica {rep.name!r} failed "
                f"mid-request ({nrows} lane rows in flight): {exc!r}"
            ) from exc

        n = sum(len(idx) for _, idx, _ in pending)
        first = out[0]
        actions = np.empty((n,) + first[0].shape[1:], dtype=first[0].dtype)
        logps = np.empty((n,) + first[1].shape[1:], dtype=first[1].dtype)
        values = np.empty((n,) + first[2].shape[1:], dtype=first[2].dtype)
        for (rep, idx, _), (a, lp, v) in zip(pending, out):
            actions[idx], logps[idx], values[idx] = a, lp, v
        return actions, logps, values

    def _discard_group(self, rep: _Replica, idx: np.ndarray, ids_f: Any) -> None:
        """Best-effort cancel of a group submitted before another failed."""
        try:
            ids = ids_f.result()
            if rep.is_virtual():
                rep.actor.call("discard", ids)
            else:
                rep.actor.discard(ids)
        except Exception:  # pragma: no cover - cleanup is best-effort
            pass
        finally:
            with self._lock:
                rep.inflight -= len(idx)
                self.num_inflight_dropped += len(idx)

    def compute_values(self, obs: np.ndarray, lanes: Optional[np.ndarray] = None) -> Any:
        eligible = self._eligible()
        if not eligible:
            raise InferenceUnavailable(f"router {self.name!r}: no eligible replicas")
        rep = min(eligible, key=lambda r: r.inflight)
        try:
            if rep.is_virtual():
                return rep.actor.call("compute_values", obs).result()
            return rep.actor.compute_values(obs)
        except Exception as exc:
            with self._lock:
                rep.failures += 1
                self.num_failures += 1
                self.num_replica_failures += 1
            raise InferenceUnavailable(
                f"router {self.name!r}: replica {rep.name!r} failed in "
                f"compute_values(): {exc!r}"
            ) from exc

    # ------------------------------------------------------ weight tracking
    def sync_weights(self, weights: Any = None) -> None:
        """Broadcast weights to all live replicas, bumping the router's
        weight version.  A replica that misses the broadcast keeps its old
        version and becomes ineligible until ``recover()`` re-syncs it."""
        if weights is None and self.weights_provider is not None:
            weights = self.weights_provider()
        if weights is None:
            return
        with self._lock:
            self.weight_version += 1
            version = self.weight_version
        for rep in list(self._replicas):
            if not rep.alive:
                continue  # stays on its old version: refused until recover()
            try:
                if rep.is_virtual():
                    rep.actor.call("set_weights", weights).result()
                else:
                    rep.actor.set_weights(weights)
                rep.weight_version = version
            except Exception as exc:
                logger.warning(
                    "router %s: weight broadcast v%d to replica %s failed: %s",
                    self.name, version, rep.name, repr(exc),
                )

    def _push_weights(self, rep: _Replica) -> bool:
        weights = (
            self.weights_provider() if self.weights_provider is not None else None
        )
        if weights is None:
            # No canonical provider (tests driving the router directly):
            # nothing to re-sync, accept the replica at the current version.
            rep.weight_version = self.weight_version
            return True
        try:
            if rep.is_virtual():
                rep.actor.call("set_weights", weights).result()
            else:
                rep.actor.set_weights(weights)
            rep.weight_version = self.weight_version
            return True
        except Exception as exc:
            logger.warning(
                "router %s: weight re-sync to replica %s failed: %s",
                self.name, rep.name, repr(exc),
            )
            return False

    # ------------------------------------------------------------- healing
    def recover(self) -> None:
        """Heal the replica set: per ``failure_policy``, dead replicas are
        restarted through supervision (then weight re-synced) or dropped;
        stale-but-alive replicas are re-synced.  Lanes pinned to lost
        replicas are unpinned so they re-pin with fresh server-side state.
        Serialized: concurrent callers (racing rollout shards) observe the
        first caller's completed repair as a no-op."""
        with self._recover_lock:
            for rep in list(self._replicas):
                if rep.alive and rep.weight_version == self.weight_version:
                    continue
                if not rep.alive:
                    if self.failure_policy == "drop_shard" or not hasattr(
                        rep.actor, "restart"
                    ):
                        self._drop_replica(rep)
                        continue
                    try:
                        rep.actor.restart()
                    except Exception as exc:
                        logger.warning(
                            "router %s: restart of replica %s failed: %s",
                            self.name, rep.name, repr(exc),
                        )
                    if not rep.alive:
                        self._drop_replica(rep)  # restart budget exhausted
                        continue
                    with self._lock:
                        self.num_replica_restarts += 1
                    # The rebuilt target lost all per-lane state: unpin its
                    # lanes so they re-init wherever they pin next.
                    self._unpin_replica(rep)
                if not self._push_weights(rep):
                    if not rep.alive:
                        self._drop_replica(rep)
            with self._lock:
                self.num_recoveries += 1

    def _drop_replica(self, rep: _Replica) -> None:
        with self._lock:
            if rep not in self._replicas:
                return
            self._replicas.remove(rep)
            self.num_replicas_dropped += 1
        self._unpin_replica(rep)
        try:
            if hasattr(rep.actor, "stop"):
                rep.actor.stop()
        except Exception:  # pragma: no cover - teardown is best-effort
            pass

    def _unpin_replica(self, rep: _Replica) -> None:
        with self._lock:
            lanes = [lane for lane, r in self._pins.items() if r is rep]
            for lane in lanes:
                del self._pins[lane]
            self.num_lane_repins += len(lanes)
            self.num_lane_state_resets += len(lanes)

    # ----------------------------------------------------------- lifecycle
    def stop(self) -> None:
        for rep in list(self._replicas):
            try:
                if hasattr(rep.actor, "stop"):
                    rep.actor.stop()
            except Exception:  # pragma: no cover - teardown is best-effort
                pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "num_requests": self.num_requests,
                "num_lane_requests": self.num_lane_requests,
                "num_failures": self.num_failures,
                "num_recoveries": self.num_recoveries,
                "num_replica_failures": self.num_replica_failures,
                "num_replica_restarts": self.num_replica_restarts,
                "num_replicas_dropped": self.num_replicas_dropped,
                "num_inflight_dropped": self.num_inflight_dropped,
                "num_lane_repins": self.num_lane_repins,
                "num_lane_state_resets": self.num_lane_state_resets,
                "num_pinned_lanes": len(self._pins),
                "weight_version": self.weight_version,
                "sticky": self._sticky,
            }
        replicas = []
        for rep in list(self._replicas):
            row: Dict[str, Any] = {
                "name": rep.name,
                "alive": rep.alive,
                "weight_version": rep.weight_version,
                "inflight": rep.inflight,
                "failures": rep.failures,
            }
            try:
                row["stats"] = (
                    rep.actor.sync("stats") if rep.is_virtual() else rep.actor.stats()
                )
            except Exception:  # dead replica: health fields only
                pass
            replicas.append(row)
        out["replicas"] = replicas
        out["num_eligible"] = len(self._eligible())
        return out

    # ------------------------------------------------------------- metrics
    def metrics_probe(self, key: str) -> Callable[[Any], None]:
        """A ``MetricsContext`` probe publishing this router's serving
        metrics under ``inference/<key>/...`` — run at every ``save()`` so
        occupancy, admission latency, and credit stalls land in ``train()``
        results and the ``Algorithm.explain()`` join."""

        def probe(ctx: Any) -> None:
            pre = f"inference/{key}/"
            with self._lock:
                ctx.counters[pre + "num_requests"] = self.num_requests
                ctx.counters[pre + "num_replica_failures"] = self.num_replica_failures
                ctx.counters[pre + "num_replicas_dropped"] = self.num_replicas_dropped
                ctx.counters[pre + "num_inflight_dropped"] = self.num_inflight_dropped
                ctx.counters[pre + "num_lane_repins"] = self.num_lane_repins
                replicas = list(self._replicas)
            ctx.gauges[pre + "replicas"] = float(len(replicas))
            ctx.gauges[pre + "replicas_eligible"] = float(len(self._eligible()))
            ctx.gauges[pre + "weight_version"] = float(self.weight_version)
            if self.credits is not None:
                ctx.counters[pre + "credit_stalls"] = self.credits.stalls
                ctx.gauges[pre + "credit_stall_time_s"] = self.credits.stall_time_s
            occ_mean: List[float] = []
            occ_peak: List[float] = []
            wait_p50: List[float] = []
            wait_p99: List[float] = []
            for rep in replicas:
                try:
                    st = (
                        rep.actor.sync("stats")
                        if rep.is_virtual()
                        else rep.actor.stats()
                    )
                except Exception:
                    continue  # dead replica: skip its queue stats
                q = st.get("queue") or {}
                occ_mean.append(float(q.get("occupancy_mean", 0.0)))
                occ_peak.append(float(q.get("occupancy_peak", 0.0)))
                wait_p50.append(float(q.get("admission_wait_p50_s", 0.0)))
                wait_p99.append(float(q.get("admission_wait_p99_s", 0.0)))
            if occ_mean:
                ctx.gauges[pre + "occupancy_mean"] = sum(occ_mean) / len(occ_mean)
                ctx.gauges[pre + "occupancy_peak"] = max(occ_peak)
                ctx.gauges[pre + "admission_wait_p50_s"] = max(wait_p50)
                ctx.gauges[pre + "admission_wait_p99_s"] = max(wait_p99)

        return probe
