"""Virtual actors: the process abstraction underneath RLlib Flow iterators.

The paper implements dataflow shards on Ray actors.  On a TPU pod there is no
per-chip RPC endpoint, so we provide *virtual actors*: Python objects that own
state (policy params, env state, replay shards) plus a dedicated executor
thread that serializes method execution, giving Ray-like semantics:

  * ``actor.call(method, *args)``  -> Future   (async, like ``.remote()``)
  * ``actor.sync(method, *args)``  -> result   (blocking convenience)
  * per-actor FIFO execution order (one mailbox thread per actor)
  * ``wait(futures, num_returns)`` (like ``ray.wait``) with *batched wait* —
    the small optimization the paper credits for Fig 13a throughput wins.

Where the target executes is pluggable (``core.executor``): ``ThreadBackend``
keeps it in-process (PyTorch releases the GIL inside its kernels and CUDA
launches are asynchronous, so virtual actors still overlap device compute);
``ProcessBackend`` builds it in a child process (started by forkserver or
spawn, never fork) from a pickled factory and turns method calls into pipe
RPCs; ``RemoteBackend`` (``core.remote``) homes it on another host.
Actors are also *supervised*: with a factory and ``max_restarts`` the target
is rebuilt with exponential backoff after a failure, and a ``FailurePolicy``
tells downstream gather operators whether to restart, drop the shard, or
raise (see ``core.iterators``).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core.executor import (
    ActorDiedError,
    ActorError,
    ExecutionBackend,
    FailurePolicy,
    SupervisorSpec,
    resolve_backend,
)

__all__ = [
    "VirtualActor",
    "ActorHandle",
    "ActorPool",
    "wait",
    "get",
    "create_colocated",
]

_actor_ids = itertools.count()

import logging

_logger = logging.getLogger(__name__)


def _log_if_failed(actor_name: str, method: str):
    def _cb(fut: Future) -> None:
        exc = fut.exception()
        # StopIteration = stream exhaustion; AttributeError = protocol probe
        # against an optional method (configure_vectorization, get_state,
        # episode_stats on legacy workers).  Both are expected control flow,
        # not worker faults — same exemption the supervision path applies.
        if exc is not None and not isinstance(exc, (StopIteration, AttributeError)):
            _logger.error("actor %s.%s failed: %s", actor_name, method, repr(exc))

    return _cb


class VirtualActor:
    """A stateful worker with a mailbox thread.

    ``target`` is any object; method calls are dispatched by name onto the
    mailbox thread so actor state is never accessed concurrently (the Ray
    actor model's serialized-execution guarantee).  Alternatively pass a
    zero-arg ``factory`` — required for ``ProcessBackend`` (the factory is
    pickled into the child) and for supervision (``max_restarts`` rebuilds
    the target from the factory after a failure).
    """

    def __init__(
        self,
        target: Any = None,
        name: Optional[str] = None,
        *,
        factory: Optional[Callable[[], Any]] = None,
        backend: Any = None,
        max_restarts: int = 0,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        failure_policy: str = FailurePolicy.RAISE,
        restart_window_s: Optional[float] = None,
    ):
        if (target is None) == (factory is None):
            raise ValueError("pass exactly one of target= or factory=")
        if max_restarts > 0 and factory is None:
            raise ValueError("max_restarts > 0 requires a factory= (restart rebuilds the target)")
        self._backend: ExecutionBackend = resolve_backend(backend)
        self._factory = factory
        self._cell = self._backend.make_cell(factory=factory, target=target)
        self.supervision = SupervisorSpec(
            max_restarts=max_restarts,
            backoff_base=backoff_base,
            backoff_cap=backoff_cap,
            failure_policy=failure_policy,
            restart_window_s=restart_window_s,
        )
        self.failure_policy = self.supervision.failure_policy
        self.actor_id = next(_actor_ids)
        base = type(target).__name__ if target is not None else getattr(
            factory, "__name__", type(factory).__name__
        )
        self.name = name or f"{base}-{self.actor_id}"
        self._inbox: "queue.Queue[Optional[Tuple[Future, str, Any, tuple, dict]]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run_loop, name=f"actor-{self.name}", daemon=True
        )
        self._alive = True
        self._dead = False
        self.num_failures = 0
        self.num_restarts = 0
        self._budget_used = 0
        self._last_failure_t: Optional[float] = None
        self._thread.start()

    # ----------------------------------------------------------- properties
    @property
    def target(self) -> Any:
        """The execution target (real object, or an RPC proxy for processes)."""
        return self._cell.target

    @property
    def alive(self) -> bool:
        """False once stopped, killed, or the restart budget is exhausted."""
        return self._alive and not self._dead

    @property
    def backend_name(self) -> str:
        return self._backend.name

    # ------------------------------------------------------------------ api
    def call(self, method: str, *args: Any, **kwargs: Any) -> Future:
        """Asynchronously invoke ``target.<method>(*args)``; returns a Future."""
        fut = self._submit("method", method, args, kwargs)
        # Fire-and-forget callers never see exceptions; log them so failures
        # in message-passing operators (StoreToReplayBuffer, ...) surface.
        fut.add_done_callback(_log_if_failed(self.name, method))
        return fut

    def apply(self, fn: Callable[..., Any], *args: Any) -> Future:
        """Asynchronously run ``fn(target, *args)`` on the actor thread.

        This is how parallel transformations are *scheduled onto the source
        actor* (paper §4, Transformation): the callable sees actor-local
        state (or, under ``ProcessBackend``, a proxy to it).
        """
        return self._submit("apply", fn, args, {})

    def sync(self, method: str, *args: Any, **kwargs: Any) -> Any:
        return self.call(method, *args, **kwargs).result()

    def kill(self) -> None:
        """Simulate hard actor loss: the execution vehicle is torn down and
        every queued/future call fails with ``ActorDiedError``."""
        self._dead = True
        self._cell.kill()

    def restart(self, timeout: float = 10.0) -> None:
        """Force-rebuild the target from its factory and mark the actor
        alive again (resets the supervisor's restart budget).  Runs on the
        mailbox thread so it serializes with in-flight calls.

        Concurrent restarts *coalesce*: a queued restart that finds the
        actor already healed (another caller's restart won the race) is a
        no-op.  Without this, two clients of a shared actor — e.g. rollout
        shards recovering one InferenceActor — would rebuild it twice, the
        second rebuild silently discarding whatever state (re-synced
        weights) the first recovery installed between the two."""
        if not self._alive:
            raise RuntimeError(f"actor {self.name} is stopped")
        if self._factory is None:
            raise ActorError(f"actor {self.name} has no factory; cannot restart")
        fut: Future = Future()
        self._inbox.put((fut, "restart", None, (), {}))
        fut.result(timeout=timeout)

    def rehome(self, backend: Any, timeout: float = 60.0) -> None:
        """Move this actor's target onto a different execution backend.

        The fragment assembler's lever (``flow.compile``): a pool built on
        the default backend is re-homed onto the ``RemoteBackend`` of its
        placement host at lowering time.  The new cell rebuilds the target
        from the factory (fresh state, like ``restart``), so only
        factory-built actors can move.  Serializes through the mailbox
        thread: calls queued behind the rehome reach the new cell.
        """
        if not self._alive:
            raise RuntimeError(f"actor {self.name} is stopped")
        if self._factory is None:
            raise ActorError(f"actor {self.name} has no factory; cannot rehome")
        fut: Future = Future()
        self._inbox.put((fut, "rehome", resolve_backend(backend), (), {}))
        fut.result(timeout=timeout)

    def stop(self) -> None:
        if self._alive:
            self._alive = False
            self._inbox.put(None)
            self._thread.join(timeout=5.0)
            self._cell.stop()

    # ------------------------------------------------------------- internals
    def _submit(self, kind: str, fn_or_method: Any, args: tuple, kwargs: dict) -> Future:
        if not self._alive:
            raise RuntimeError(f"actor {self.name} is stopped")
        fut: Future = Future()
        if self._dead:
            fut.set_exception(ActorDiedError(f"actor {self.name} is dead"))
            return fut
        self._inbox.put((fut, kind, fn_or_method, args, kwargs))
        return fut

    def _run_loop(self) -> None:
        while True:
            item = self._inbox.get()
            if item is None:
                return
            fut, kind, fn_or_method, args, kwargs = item
            if kind == "restart":
                self._manual_restart(fut)
                continue
            if kind == "rehome":
                self._do_rehome(fut, fn_or_method)
                continue
            if self._dead:
                fut.set_exception(ActorDiedError(f"actor {self.name} is dead"))
                continue
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                # Resolve against the *current* cell target at execution time
                # so calls queued across a restart reach the fresh target.
                if kind == "method":
                    result = getattr(self._cell.target, fn_or_method)(*args, **kwargs)
                else:  # apply
                    result = fn_or_method(self._cell.target, *args, **kwargs)
            except BaseException as exc:
                # StopIteration = stream exhaustion; AttributeError = protocol
                # probe against an optional method (episode_stats, get_state).
                # Neither is a worker fault: supervision must not burn a
                # restart (wiping worker state) on them.
                if isinstance(exc, Exception) and not isinstance(
                    exc, (StopIteration, AttributeError)
                ):
                    self._handle_failure(exc)
                fut.set_exception(exc)
            else:
                fut.set_result(result)

    def _do_rehome(self, fut: Future, backend: ExecutionBackend) -> None:
        """Mailbox-thread half of ``rehome``: build the new cell first, so a
        backend that cannot construct (unreachable host) leaves the actor
        exactly where it was."""
        old_cell = self._cell
        try:
            new_cell = backend.make_cell(factory=self._factory)
        except BaseException as exc:
            fut.set_exception(exc)
            return
        self._backend = backend
        self._cell = new_cell
        self._dead = False
        self._budget_used = 0
        try:
            old_cell.stop()
        except Exception:
            pass
        fut.set_result(None)

    def _manual_restart(self, fut: Future) -> None:
        if not self._dead and self._cell.alive:
            fut.set_result(None)  # coalesced: already healed by another caller
            return
        try:
            self._cell.restart()
        except BaseException as exc:
            self._mark_dead()
            fut.set_exception(exc)
        else:
            self._dead = False
            self._budget_used = 0
            self.num_restarts += 1
            fut.set_result(None)

    def _handle_failure(self, exc: Exception) -> None:
        """Supervision (mailbox thread): restart with backoff, or mark dead."""
        self.num_failures += 1
        if self._dead:
            return
        sup = self.supervision
        died = isinstance(exc, ActorDiedError) or not self._cell.alive
        # Read the *mutable* failure_policy (flow-graph annotations may have
        # overridden the construction-time spec) so supervisor and gather
        # consumers always act on the same policy.
        if self.failure_policy == FailurePolicy.DROP_SHARD and not died:
            # Consumers drop the shard on first failure regardless, so a
            # rebuild (plus its backoff sleep, which would stall a gather
            # barrier blocked on this future) is pure waste.
            return
        # Healthy-window forgiveness: a full restart_window_s without a
        # supervised failure resets the budget (and the backoff exponent),
        # so the budget bounds crash *loops*, not lifetime failures.
        window = sup.restart_window_s
        if (
            window is not None
            and self._budget_used > 0
            and self._last_failure_t is not None
            and time.monotonic() - self._last_failure_t >= window
        ):
            self._budget_used = 0
        self._last_failure_t = time.monotonic()
        if sup.max_restarts > 0 and self._budget_used < sup.max_restarts:
            delay = sup.backoff(self._budget_used)
            if delay > 0:
                time.sleep(delay)
            try:
                self._cell.restart()
            except BaseException as rexc:
                _logger.error("actor %s restart failed: %s", self.name, repr(rexc))
                self._mark_dead()
                return
            self._budget_used += 1
            self.num_restarts += 1
            _logger.warning(
                "actor %s restarted (%d/%d, backoff %.3fs) after %s",
                self.name, self._budget_used, sup.max_restarts, delay, repr(exc),
            )
            return
        if died or sup.max_restarts > 0:
            # Transport gone, or a supervised actor out of budget: actor dies.
            _logger.error(
                "actor %s died after %d failures (%d restarts used): %s",
                self.name, self.num_failures, self._budget_used, repr(exc),
            )
            self._mark_dead()
        # Unsupervised target-level exceptions keep legacy semantics: the
        # future carries the exception, the actor stays alive.

    def _mark_dead(self) -> None:
        self._dead = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"VirtualActor({self.name}, backend={self._backend.name}, alive={self.alive})"


# ``ActorHandle`` is what flows through dataflow metadata (zip_with_source_actor)
ActorHandle = VirtualActor


class ActorPool:
    """A named group of actors — the unit a ParallelIterator shards over.

    The pool is *elastic*: ``add``/``remove``/``replace`` bump a version
    counter that pool-aware iterators use to pick up membership changes
    mid-stream (``Algorithm.add_workers()/remove_workers()``).
    """

    def __init__(self, actors: Sequence[VirtualActor], name: str = "pool"):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self.actors: List[VirtualActor] = list(actors)
        self.name = name
        self._version = 0

    @classmethod
    def from_targets(cls, targets: Sequence[Any], name: str = "pool") -> "ActorPool":
        return cls([VirtualActor(t) for t in targets], name=name)

    @classmethod
    def from_factories(
        cls,
        factories: Sequence[Callable[[], Any]],
        name: str = "pool",
        **actor_kwargs: Any,
    ) -> "ActorPool":
        """Supervised/process-backed pools: one factory per actor."""
        return cls(
            [VirtualActor(factory=f, **actor_kwargs) for f in factories], name=name
        )

    @property
    def version(self) -> int:
        """Bumped on every membership change (elastic iterator sync point)."""
        return self._version

    def __len__(self) -> int:
        return len(self.actors)

    def __iter__(self):
        return iter(list(self.actors))

    def __getitem__(self, i: int) -> VirtualActor:
        return self.actors[i]

    # -------------------------------------------------------------- elastic
    def add(self, actor: VirtualActor) -> None:
        self.actors.append(actor)
        self._version += 1

    def remove(self, actor: VirtualActor, stop: bool = True) -> None:
        self.actors.remove(actor)
        self._version += 1
        if stop:
            actor.stop()

    def replace(self, old: VirtualActor, new: VirtualActor, stop_old: bool = True) -> None:
        self.actors[self.actors.index(old)] = new
        self._version += 1
        if stop_old:
            old.stop()

    def alive_actors(self) -> List[VirtualActor]:
        return [a for a in self.actors if getattr(a, "alive", True)]

    # Broadcast a method call to every actor; returns futures.
    def broadcast(self, method: str, *args: Any, **kwargs: Any) -> List[Future]:
        return [a.call(method, *args, **kwargs) for a in self.actors]

    def broadcast_sync(self, method: str, *args: Any, **kwargs: Any) -> List[Any]:
        return [f.result() for f in self.broadcast(method, *args, **kwargs)]

    def stop(self) -> None:
        for a in self.actors:
            a.stop()


def wait(
    futures: Sequence[Future],
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[Future], List[Future]]:
    """``ray.wait`` equivalent: split futures into (ready, pending).

    Blocks until ``num_returns`` futures are done (or timeout).  Uses a single
    condition variable over all futures — the *batched RPC wait* the paper
    cites as an easy cross-algorithm optimization (Fig 13a).
    """
    futures = list(futures)
    if num_returns > len(futures):
        raise ValueError(f"num_returns={num_returns} > #futures={len(futures)}")
    cond = threading.Condition()
    n_done = [0]

    def _on_done(_f: Future) -> None:
        with cond:
            n_done[0] += 1
            cond.notify_all()

    for f in futures:
        f.add_done_callback(_on_done)
    with cond:
        cond.wait_for(lambda: sum(f.done() for f in futures) >= num_returns, timeout)
    ready = [f for f in futures if f.done()]
    pending = [f for f in futures if not f.done()]
    # Deterministic "first num_returns" semantics like ray.wait
    return ready[:max(num_returns, len(ready))], pending


def get(obj: Any) -> Any:
    """``ray.get`` equivalent (works on Futures, lists of Futures, plain values)."""
    if isinstance(obj, Future):
        return obj.result()
    if isinstance(obj, (list, tuple)):
        return type(obj)(get(o) for o in obj)
    return obj


def create_colocated(
    factory: Callable[[], Any], count: int, name: str = "colocated"
) -> ActorPool:
    """Paper's ``create_colocated`` (Ape-X replay actors): a colocation group.

    On Ray this pins actors to the head node; here all virtual actors share
    the process, so colocation is a naming/grouping concern only.
    """
    return ActorPool.from_targets([factory() for _ in range(count)], name=name)
