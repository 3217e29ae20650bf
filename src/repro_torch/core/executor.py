"""Execution backends + supervision for virtual actors (PyTorch port of
``repro/core/executor.py``).

RLlib Flow's actors are Ray actors, which gives the paper process isolation
and fault tolerance for free.  This module makes the execution vehicle
pluggable (MSRL: dataflow fragments must be remappable across heterogeneous
backends) and supervised (SRL: scaling hinges on decoupled, restartable
worker groups):

  * ``ThreadBackend`` — the target lives in the driver process on a mailbox
    thread (PyTorch releases the GIL inside its kernels and CUDA launches
    are asynchronous, so device compute still overlaps).
  * ``ProcessBackend`` — the target is built *inside a child process* from a
    pickled factory ("picklable-target transport"); method calls are RPCs
    over a pipe.  ``apply()`` still works with arbitrary closures: the
    closure runs driver-side against a proxy whose method calls round-trip
    to the child, so only method arguments/results must be picklable.
    *Result payloads* cross a pluggable data plane (``core.transport``):
    by default large ``SampleBatch`` columns move through shared-memory
    ring segments (header-only pipe messages, refcounted reclaim) instead
    of being pickled — pass ``ProcessBackend(transport="pickle")`` for the
    pipe baseline.  Every message is pickled with ``transport.dumps``, so a
    torch tensor crosses as host bytes and lands on the device it left.
  * ``SupervisorSpec`` — ``max_restarts`` with exponential backoff, plus a
    ``FailurePolicy`` (restart / drop_shard / raise) that the gather
    operators in ``core.iterators`` and ``WorkerSet`` honor: a dead rollout
    worker shrinks the shard set instead of poisoning the stream.

The port never forks the driver.  A child forked after the parent has
initialised CUDA cannot use the card, so children start from a fork server
(``forkserver``, the default: a clean interpreter that has imported
``torch`` and ``repro_torch`` and never touches CUDA, so its forks can) or by
``spawn``; ``start_method="fork"`` raises ``ValueError``.

``VirtualActor`` (``core.actor``) keeps its public API and delegates the
execution locus to a backend *cell*; everything above the actor layer is
backend-agnostic.
"""

from __future__ import annotations

import itertools
import logging
import multiprocessing
import os
import weakref
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.transport import (
    SEGMENT_PREFIX,
    Transport,
    dumps,
    loads,
    resolve_transport,
)

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

_logger = logging.getLogger(__name__)

_cell_seq = itertools.count()


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


def _send(conn: Any, obj: Any) -> int:
    """Send one message with the tensor rule (never torch's reducers);
    returns the bytes put on the pipe."""
    data = dumps(obj)
    conn.send_bytes(data)
    return len(data)


def _recv(conn: Any) -> Any:
    return loads(conn.recv_bytes())


def _serve(conn: Any, payload: bytes, transport_payload: bytes) -> None:
    """Child-process loop: build the target from its pickled factory, then
    execute (method, args, kwargs, released_segments) requests until
    shutdown/EOF.  Results cross back through the cell's transport: the
    shared-memory transport replaces large numpy payloads with header-only
    refs; the pipe carries everything else (tensors as host bytes)."""
    spec, prefix = loads(transport_payload)
    encoder = spec.server_endpoint(prefix)
    try:
        target = loads(payload)()
    except BaseException as exc:  # construction failure: report and exit
        try:
            _send(conn, (False, ActorError(f"target construction failed: {exc!r}")))
        except Exception:
            pass
        encoder.close()
        return
    while True:
        try:
            msg = _recv(conn)
        except (EOFError, OSError):
            encoder.close()
            return
        if msg is None:
            encoder.close()
            conn.close()
            return
        method, args, kwargs, released = msg
        encoder.reclaim(released)
        try:
            result = getattr(target, method)(*args, **kwargs)
        except BaseException as exc:
            try:
                _send(conn, (False, exc))
            except Exception:  # unpicklable exception: degrade to a summary
                _send(conn, (False, ActorError(f"{type(exc).__name__}: {exc}")))
            continue
        try:
            wire = encoder.encode(result)
        except Exception as exc:
            # An encode failure is a per-message problem (allocation race,
            # OOM): report it like any call failure, keep serving.
            _send(conn, (False, ActorError(f"transport encode failed for {method}(): {exc!r}")))
            continue
        try:
            _send(conn, (True, wire))
        except Exception as exc:
            encoder.rollback(wire)  # consumer will never release these refs
            _send(conn, (False, ActorError(f"unpicklable result from {method}(): {exc}")))


class _Proxy:
    """Driver-side stand-in for a process-hosted target.

    Attribute access returns RPC stubs, so ``apply(lambda t: t.sample())``
    works unchanged: the closure runs on the driver's mailbox thread and
    every method call round-trips to the child process.
    """

    __slots__ = ("_cell",)

    def __init__(self, cell: "ProcessCell"):
        object.__setattr__(self, "_cell", cell)

    def __getattr__(self, name: str) -> Any:
        cell = object.__getattribute__(self, "_cell")

        def _stub(*args: Any, **kwargs: Any) -> Any:
            return cell.rpc(name, args, kwargs)

        _stub.__name__ = name
        return _stub

    def __repr__(self) -> str:  # pragma: no cover
        return f"_Proxy({object.__getattribute__(self, '_cell')!r})"


class _ReturnTarget:
    """Picklable factory wrapper for a pre-built (picklable) target object."""

    def __init__(self, target: Any):
        self.target = target

    def __call__(self) -> Any:
        return self.target


# What the fork server imports once, so that each child starts warm: torch
# (most of a cold interpreter's start) and the port's runtime and RL modules.
# None of them touches CUDA at import.
FORKSERVER_PRELOAD = ("torch", "repro_torch", "repro_torch.core", "repro_torch.rl")


def mp_context(start_method: Optional[str]) -> Any:
    """The multiprocessing context a cell or host starts its child with.

    ``None`` or ``"forkserver"``: a fork server that has preloaded
    ``FORKSERVER_PRELOAD`` (it imports and never touches CUDA, so its forks
    can use the card).  ``"spawn"``: a fresh interpreter per child.
    ``"fork"`` is refused: a child forked after the driver has initialised
    CUDA cannot use the card, and the failure would only show inside it.
    """
    if start_method is None:
        start_method = "forkserver"
    if start_method == "fork":
        raise ValueError(
            "start_method='fork' is refused: a child forked after the driver has "
            "initialised CUDA cannot use the card; use 'forkserver' (the default) "
            "or 'spawn'"
        )
    if start_method not in ("forkserver", "spawn"):
        raise ValueError(
            f"unknown start method {start_method!r}; expected 'forkserver' or 'spawn'"
        )
    ctx = multiprocessing.get_context(start_method)
    if start_method == "forkserver":
        ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
    return ctx


def stop_helper_processes(timeout: float = 10.0) -> None:
    """Stop every child this process still has, then the fork server and
    the resource tracker, and wait for each to exit.

    Left alone, the fork server exits only after the driver has (on the EOF
    of its pipe, and then it finalises the torch it preloaded), and so does
    the tracker: a program that must leave no process behind when it ends
    calls this first.  A child that ignores ``terminate`` is killed; one
    that outlives even that raises ``ActorError``, and the fork server and
    tracker are then left up (waiting on them would block).  A later cell
    starts a fresh fork server."""
    from multiprocessing import forkserver, resource_tracker

    children = multiprocessing.active_children()
    for p in children:
        p.terminate()
    for p in children:
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(timeout)
    left = [p for p in children if p.is_alive()]
    if left:
        raise ActorError(f"children still running after kill: {[p.pid for p in left]}")
    # Every holder of the server's and the tracker's pipes is gone now, so
    # closing ours makes each exit, and their _stop() reaps it.
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class ProcessCell(Cell):
    """Target lives in a child process; calls are pipe RPCs.

    The factory (or the target itself) is pickled eagerly — the
    "picklable-target transport" contract — so a cell that constructs at all
    can always be restarted.  ``wire_bytes`` counts the pickled bytes each
    way (``"sent"`` to the child, ``"received"`` from it); shared-memory
    payloads are counted by the transport's reader (``stats``).
    """

    def __init__(
        self,
        factory: Optional[Callable[[], Any]] = None,
        target: Any = None,
        start_method: Optional[str] = None,
        transport: Any = None,
    ):
        payload = factory if factory is not None else _ReturnTarget(target)
        self._ctx = mp_context(start_method)
        self._payload = dumps(payload)
        self._transport: Transport = resolve_transport(transport)
        self._prefix_base = f"{SEGMENT_PREFIX}{os.getpid()}x{next(_cell_seq)}"
        self._generation = 0
        self._decoder: Any = None
        self._proc: Any = None
        self._conn: Any = None
        self._proxy = _Proxy(self)
        self.wire_bytes = {"sent": 0, "received": 0}
        # Last-resort segment sweep: a cell abandoned without stop()/kill()
        # (test aborted mid-stream, driver crash path) still reclaims its
        # shared-memory names at GC/interpreter exit.  Normal shutdown paths
        # make this a no-op.
        self._finalizer = weakref.finalize(
            self, ProcessCell._sweep_prefix, self._prefix_base
        )
        self._spawn()

    @staticmethod
    def _sweep_prefix(prefix_base: str) -> None:
        from repro_torch.core.transport import _unlink_by_name, list_segments

        for name in list_segments(prefix_base):
            _unlink_by_name(name)

    def _spawn(self) -> None:
        parent, child = self._ctx.Pipe()
        self._conn = parent
        # A fresh name generation per spawn: segments of a killed child are
        # swept by the driver, and the replacement child can never collide
        # with a name the sweep missed.
        self._generation += 1
        prefix = f"{self._prefix_base}g{self._generation}"
        self._decoder = self._transport.client_endpoint(prefix)
        self._proc = self._ctx.Process(
            target=_serve,
            args=(child, self._payload, dumps((self._transport, prefix))),
            daemon=True,
            name="actor-cell",
        )
        self._proc.start()
        child.close()

    # ------------------------------------------------------------------ rpc
    def rpc(self, method: str, args: tuple, kwargs: dict) -> Any:
        if not self.alive:
            raise self._death_error(method)
        try:
            self.wire_bytes["sent"] += _send(
                self._conn, (method, args, kwargs, self._decoder.drain_releases())
            )
            data = self._conn.recv_bytes()
        except (EOFError, OSError, BrokenPipeError):
            raise self._death_error(method) from None
        self.wire_bytes["received"] += len(data)
        ok, payload = loads(data)
        if ok:
            return self._decoder.decode(payload)
        raise payload

    def _death_error(self, method: str) -> ActorDiedError:
        """Build the death error, draining any buffered report from the
        child first — a target whose constructor raised sends the real
        exception into the pipe before exiting, and that beats a generic
        'process is dead'."""
        buffered: Optional[BaseException] = None
        try:
            if self._conn.poll(0.05):
                ok, payload = _recv(self._conn)
                if not ok and isinstance(payload, BaseException):
                    buffered = payload
        except (EOFError, OSError, BrokenPipeError, ValueError):
            pass
        err = ActorDiedError(
            f"process cell died during {method}() (exitcode={self._exitcode()})"
            + (f": {buffered}" if buffered is not None else "")
        )
        err.__cause__ = buffered
        return err

    def _exitcode(self) -> Any:
        return self._proc.exitcode if self._proc is not None else None

    # ------------------------------------------------------------ lifecycle
    @property
    def target(self) -> Any:
        return self._proxy

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def restart(self) -> None:
        self.kill()
        self._spawn()

    def stop(self) -> None:
        if self._proc is None:
            return
        try:
            if self._proc.is_alive():
                _send(self._conn, None)
                self._proc.join(timeout=1.0)
        except (OSError, BrokenPipeError, ValueError):
            pass
        self.kill()

    def kill(self) -> None:
        if self._proc is None:
            return
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=2.0)
        try:
            self._conn.close()
        except Exception:
            pass
        # Sweep this generation's shared-memory segments: the child is gone
        # (or never cleaned up after terminate), so reclaim is ours now.
        if self._decoder is not None:
            self._decoder.close(unlink=True)


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

    def __init__(self, transport: Any = None):
        # Thread cells share the driver's address space: every payload is
        # already zero-copy.  The kwarg exists so backend-matrix code can
        # parametrize (backend, transport) uniformly.
        self.transport = transport

    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        return ThreadCell(factory=factory, target=target)


class ProcessBackend(ExecutionBackend):
    """Cells in child processes started by ``forkserver`` (the default) or
    ``spawn``; ``start_method="fork"`` raises ``ValueError``."""

    name = "process"

    def __init__(self, start_method: Optional[str] = None, transport: Any = None):
        mp_context(start_method)  # refuse fork (and unknown methods) up front
        self.start_method = start_method
        self.transport = resolve_transport(transport)

    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        return ProcessCell(
            factory=factory,
            target=target,
            start_method=self.start_method,
            transport=self.transport,
        )


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
