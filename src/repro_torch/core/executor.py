"""Pluggable execution backends + actor supervision (the executor runtime).

The paper's dataflow shards run on Ray actors and inherit Ray's fault
tolerance for free.  This module makes the execution vehicle pluggable (MSRL:
dataflow fragments must be remappable across heterogeneous backends) and
supervised (SRL: scaling hinges on decoupled, restartable worker groups):

  * ``ThreadBackend``  — a mailbox thread per actor, target lives in-process
    (PyTorch releases the GIL inside its kernels and CUDA launches are
    asynchronous, so device compute still overlaps).
  * ``ProcessBackend`` — not ported: constructing it raises
    ``NotImplementedError``.  The reference's default start method is
    ``fork``, and a child forked after the parent has initialised CUDA cannot
    use the card, so the port needs a spawn-based cell before it has one.
  * ``SupervisorSpec`` — ``max_restarts`` with exponential backoff, plus a
    ``FailurePolicy`` (restart / drop_shard / raise) that the gather
    operators in ``core.iterators`` and ``WorkerSet`` honor: a dead rollout
    worker shrinks the shard set instead of poisoning the stream.

``VirtualActor`` (``core.actor``) keeps its public API and delegates the
execution locus to a backend *cell*; everything above the actor layer is
backend-agnostic.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = [
    "ActorError",
    "ActorDiedError",
    "FailurePolicy",
    "SupervisorSpec",
    "ExecutionBackend",
    "ThreadBackend",
    "ProcessBackend",
    "BACKENDS",
    "resolve_backend",
]


class ActorError(RuntimeError):
    """A failure attributable to a (virtual) actor's execution vehicle."""


class ActorDiedError(ActorError):
    """The actor's execution vehicle is gone (process exit, restart budget
    exhausted, explicit ``kill()``).  Gather operators treat this as a shard
    loss, never as a recoverable item failure."""


class FailurePolicy:
    """What the *consumers* of an actor do when one of its calls fails.

    RAISE      -> propagate to the driver (legacy behaviour, default).
    RESTART    -> the supervisor restarts the target (factory rebuild with
                  exponential backoff); the failed item is skipped and the
                  shard stays in the set.  Once the restart budget is
                  exhausted the actor dies and the shard is dropped.
    DROP_SHARD -> remove the shard from the iterator's active set on first
                  failure; the stream continues with the survivors.
    """

    RAISE = "raise"
    RESTART = "restart"
    DROP_SHARD = "drop_shard"
    ALL = frozenset((RAISE, RESTART, DROP_SHARD))

    @classmethod
    def validate(cls, policy: str) -> str:
        if policy not in cls.ALL:
            raise ValueError(
                f"unknown failure policy {policy!r}; expected one of {sorted(cls.ALL)}"
            )
        return policy


@dataclass(frozen=True)
class SupervisorSpec:
    """Restart budget + backoff schedule + consumer-facing failure policy.

    ``max_restarts`` on its own is a *lifetime* budget: a long-lived actor
    that crashes occasionally exhausts it and dies permanently even after
    hours of health between failures.  ``restart_window_s`` fixes that — an
    actor that stays healthy for a full window gets its prior-restart
    counter (and with it the backoff exponent) forgiven, so the budget only
    bounds *crash loops*, not total failures over the actor's life.
    ``None`` keeps the legacy lifetime-budget semantics.
    """

    max_restarts: int = 0
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    failure_policy: str = FailurePolicy.RAISE
    restart_window_s: Optional[float] = None

    def __post_init__(self) -> None:
        FailurePolicy.validate(self.failure_policy)
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_base < 0 or self.backoff_cap < 0:
            raise ValueError("backoff must be >= 0")
        if self.restart_window_s is not None and self.restart_window_s <= 0:
            raise ValueError("restart_window_s must be > 0 (or None for a lifetime budget)")

    def backoff(self, n_prior_restarts: int) -> float:
        return min(self.backoff_base * (2.0 ** n_prior_restarts), self.backoff_cap)


# --------------------------------------------------------------------------
# Cells: the execution locus behind one actor
# --------------------------------------------------------------------------
class Cell(ABC):
    """Owns the target object (or a proxy to it) for one actor."""

    @property
    @abstractmethod
    def target(self) -> Any:
        """The object method calls are dispatched onto (real or proxy)."""

    @property
    @abstractmethod
    def alive(self) -> bool:
        """Whether the execution vehicle can still run calls."""

    @abstractmethod
    def restart(self) -> None:
        """Rebuild the target from its factory (fresh state)."""

    @abstractmethod
    def stop(self) -> None:
        """Graceful shutdown of the vehicle (idempotent)."""

    @abstractmethod
    def kill(self) -> None:
        """Forceful shutdown (process terminate; best-effort for threads)."""


class ThreadCell(Cell):
    """Target lives in-process; the actor's mailbox thread calls it directly."""

    def __init__(self, factory: Optional[Callable[[], Any]] = None, target: Any = None):
        self._factory = factory
        self._target = target if target is not None else factory()  # type: ignore[misc]

    @property
    def target(self) -> Any:
        return self._target

    @property
    def alive(self) -> bool:
        return True

    def restart(self) -> None:
        if self._factory is None:
            raise ActorError("thread cell has no factory; target is not restartable")
        self._target = self._factory()

    def stop(self) -> None:
        pass

    def kill(self) -> None:
        # Threads cannot be preempted; the actor layer marks itself dead and
        # fails queued work.  A call already executing cannot be interrupted.
        pass


# --------------------------------------------------------------------------
# Backends
# --------------------------------------------------------------------------
class ExecutionBackend(ABC):
    """Factory for cells: where an actor's target executes."""

    name: str = "abstract"

    @abstractmethod
    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        ...


class ThreadBackend(ExecutionBackend):
    name = "thread"

    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        return ThreadCell(factory=factory, target=target)


class ProcessBackend(ExecutionBackend):
    """Not ported yet: raises on construction.

    The reference builds each target in a child process started with
    ``fork``; a child forked after the parent has initialised CUDA cannot use
    the card, and the failure would only show inside the child (through
    supervised restarts).  So the port refuses up front until it has a
    spawn-based cell."""

    name = "process"

    def __init__(self, start_method: Optional[str] = None, transport: Any = None):
        raise NotImplementedError(
            "the process backend is not ported yet (a forked child cannot use "
            "CUDA); use the default thread backend"
        )

    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        raise NotImplementedError("the process backend is not ported yet")


BACKENDS = {"thread": ThreadBackend, "process": ProcessBackend}


def resolve_backend(backend: Any) -> ExecutionBackend:
    """None -> ThreadBackend; str -> registry lookup; instance passthrough."""
    if backend is None:
        return ThreadBackend()
    if isinstance(backend, ExecutionBackend):
        return backend
    if isinstance(backend, str):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; known: {sorted(BACKENDS)}")
        return BACKENDS[backend]()
    raise TypeError(f"backend must be None, str, or ExecutionBackend (got {backend!r})")
