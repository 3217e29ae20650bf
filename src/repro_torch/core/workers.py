"""WorkerSet: the local + remote rollout-worker group used by plans.

Mirrors RLlib's WorkerSet: one *local* worker (driver-side; owns the canonical
policy used by TrainOneStep/ApplyGradients) plus N *remote* workers (virtual
actors) that sample in parallel.  The protocol any worker target must satisfy:

    sample() -> SampleBatch
    get_weights() -> pytree
    set_weights(weights) -> None
    compute_gradients(batch) -> (grads, info)
    apply_gradients(grads) -> info
    learn_on_batch(batch) -> info

Fault tolerance / elasticity (executor runtime):

  * ``create(..., max_restarts=2, failure_policy="drop_shard")`` builds
    supervised workers; the factory is kept so workers can be rebuilt.  The
    port runs them on the thread backend: ``backend="process"`` and
    ``transport=`` are not ported yet and raise ``NotImplementedError``.
  * ``sync_weights`` skips dead workers instead of poisoning the caller.
  * ``add_workers``/``remove_workers`` resize the group mid-training (the
    pool version bump makes pool-aware gather loops pick up the change).
  * ``recover`` restarts dead workers in place (factory rebuild) or replaces
    them with fresh actors, then re-broadcasts the canonical weights.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.actor import ActorPool, VirtualActor
from repro_torch.core.executor import FailurePolicy

__all__ = ["WorkerSet"]

logger = logging.getLogger(__name__)


class WorkerSet:
    def __init__(
        self,
        local_worker: Any,
        remote_workers: ActorPool,
        worker_factory: Optional[Callable[[int], Any]] = None,
        actor_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self._local = local_worker
        self._remote = remote_workers
        self._factory = worker_factory
        self._actor_kwargs = dict(actor_kwargs or {})
        self._next_index = len(remote_workers) + 1
        # Extra consumers of weight broadcasts beyond the rollout actors —
        # e.g. decoupled InferenceActors serving this set's policy.
        self._weight_sinks: List[Callable[[Any], None]] = []

    @classmethod
    def create(
        cls,
        worker_factory: Callable[[int], Any],
        num_workers: int,
        *,
        backend: Any = None,
        transport: Any = None,
        max_restarts: int = 0,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        failure_policy: str = FailurePolicy.RAISE,
        restart_window_s: Optional[float] = None,
    ) -> "WorkerSet":
        """Build a local worker (index 0) and ``num_workers`` remote actors.

        ``backend`` selects the execution vehicle ("thread" or an
        ``ExecutionBackend``); supervision kwargs configure restart budget,
        backoff, and the failure policy gather operators honor.

        ``transport`` (the reference's inter-process data plane) is not
        ported yet: passing one raises ``NotImplementedError``.
        """
        if transport is not None:
            raise NotImplementedError(
                "transport= selects the process backend's data plane, which is not ported yet"
            )
        local = worker_factory(0)
        actor_kwargs = dict(
            backend=backend,
            max_restarts=max_restarts,
            backoff_base=backoff_base,
            backoff_cap=backoff_cap,
            failure_policy=failure_policy,
            restart_window_s=restart_window_s,
        )
        actors = [
            cls._make_actor(worker_factory, i + 1, actor_kwargs)
            for i in range(num_workers)
        ]
        pool = ActorPool(actors, name="rollout_workers")
        return cls(local, pool, worker_factory, actor_kwargs)

    @staticmethod
    def _make_actor(
        factory: Callable[[int], Any], index: int, actor_kwargs: Dict[str, Any]
    ) -> VirtualActor:
        actor = VirtualActor(
            factory=functools.partial(factory, index),
            name=f"rollout-{index}",
            **actor_kwargs,
        )
        actor.worker_index = index  # type: ignore[attr-defined]
        return actor

    def local_worker(self) -> Any:
        return self._local

    def remote_workers(self) -> ActorPool:
        return self._remote

    def healthy_workers(self) -> List[VirtualActor]:
        return self._remote.alive_actors()

    def num_healthy_workers(self) -> int:
        return len(self.healthy_workers())

    def sync_weights(self) -> None:
        """Broadcast local weights to all live remote workers.

        Dead workers are skipped, and failures on workers whose policy
        absorbs faults (restart/drop_shard) are logged so one lost rollout
        worker cannot poison a TrainOneStep weight broadcast.  Workers under
        the default RAISE policy keep the legacy global-barrier semantics:
        their failure propagates to the driver.
        """
        weights = self._local.get_weights()
        futures = []
        for actor in self._remote:
            if not getattr(actor, "alive", True):
                continue
            try:
                futures.append((actor, actor.call("set_weights", weights)))
            except RuntimeError:
                continue  # stopped between the alive check and the call
        for actor, f in futures:
            try:
                f.result()
            except Exception as exc:
                policy = getattr(actor, "failure_policy", FailurePolicy.RAISE)
                if policy == FailurePolicy.RAISE and getattr(actor, "alive", True):
                    raise
                logger.warning("sync_weights: worker %s failed: %s", actor.name, repr(exc))
        for sink in self._weight_sinks:
            try:
                sink(weights)
            except Exception as exc:
                # Sinks heal themselves (InferenceClient.recover); a dead
                # server must not poison a rollout-worker broadcast.
                logger.warning("sync_weights: weight sink failed: %s", repr(exc))

    def add_weight_sink(self, sink: Callable[[Any], None]) -> None:
        """Register an extra weight-broadcast consumer (e.g. the decoupled
        inference server's ``InferenceClient.sync_weights``)."""
        self._weight_sinks.append(sink)

    def remove_weight_sink(self, sink: Callable[[Any], None]) -> None:
        """Unregister a weight sink (no-op if absent).  Flows that register
        a sink for a resource they own must remove it on stop — a shared
        WorkerSet outlives any one compiled flow."""
        try:
            self._weight_sinks.remove(sink)
        except ValueError:
            pass

    # ------------------------------------------------------------- elastic
    def add_workers(self, num_workers: int) -> List[VirtualActor]:
        """Grow the remote group mid-training; new workers get the canonical
        weights and join pool-aware gather loops via the version bump."""
        if self._factory is None:
            raise RuntimeError("WorkerSet has no factory; build it with WorkerSet.create")
        added = []
        weights = self._local.get_weights()
        for _ in range(num_workers):
            actor = self._make_actor(self._factory, self._next_index, self._actor_kwargs)
            self._next_index += 1
            actor.call("set_weights", weights)
            self._remote.add(actor)
            added.append(actor)
        return added

    def remove_workers(self, num_workers: int = 1) -> List[str]:
        """Shrink the remote group from the tail (at least one must remain)."""
        if num_workers >= len(self._remote):
            raise ValueError(
                f"cannot remove {num_workers} of {len(self._remote)} workers; "
                "at least one remote worker must remain"
            )
        removed = []
        for _ in range(num_workers):
            actor = self._remote[len(self._remote) - 1]
            self._remote.remove(actor, stop=True)
            removed.append(actor.name)
        return removed

    def recover(self) -> Dict[str, List[str]]:
        """Heal the group: restart dead workers in place (factory rebuild),
        or replace them with fresh actors when in-place restart fails, then
        re-broadcast the canonical weights.  Returns what was done."""
        report: Dict[str, List[str]] = {"restarted": [], "replaced": [], "failed": []}
        for actor in list(self._remote):
            if getattr(actor, "alive", True):
                continue
            try:
                actor.restart(timeout=5.0)
                report["restarted"].append(actor.name)
                continue
            except Exception as exc:
                logger.warning("recover: in-place restart of %s failed: %s", actor.name, repr(exc))
            if self._factory is None:
                report["failed"].append(actor.name)
                continue
            index = getattr(actor, "worker_index", self._next_index)
            if index == self._next_index:
                self._next_index += 1
            replacement = self._make_actor(self._factory, index, self._actor_kwargs)
            self._remote.replace(actor, replacement, stop_old=True)
            report["replaced"].append(replacement.name)
        if report["restarted"] or report["replaced"]:
            self.sync_weights()
        return report

    def stop(self) -> None:
        self._remote.stop()
