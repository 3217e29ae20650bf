"""Distributed iterators: the RLlib Flow programming model core.

Two iterator kinds (paper §4):

  * ``ParallelIterator[T]`` — a lazy parallel stream of items sharded across a
    pool of (virtual) actors.  Transformations added with ``for_each`` are
    *scheduled onto the source actor* so they can read actor-local state
    (policy weights, env state).  Consuming a parallel iterator requires a
    sequencing operator: ``gather_sync`` (deterministic, barrier semantics) or
    ``gather_async`` (items surface as soon as ready; ``num_async`` controls
    pipeline depth).

  * ``LocalIterator[T]`` — a lazy sequential stream.  Supports ``for_each``,
    ``filter``, ``batch``, ``combine``, ``zip_with_source_actor``, ``union``
    (round-robin or async, with rate-limiting weights) and ``duplicate``.

Iterators are lazy: building a dataflow does nothing; pulling items from the
output iterator drives the whole graph (Volcano-style).

Fault tolerance (executor runtime): the gather operators honor each source
actor's ``FailurePolicy`` — a failing worker either restarts (item skipped,
shard kept), gets its shard dropped (the stream continues with survivors),
or propagates the error (default).  Failures and dropped shards are counted
into the shared metrics context.  Pool-backed parallel iterators are also
*elastic*: actors added to / removed from the source ``ActorPool`` mid-stream
are picked up by the gather loops (``Algorithm.add_workers()``).

Backpressure (data plane): ``gather_async`` is credit-bounded — the total
dispatched-but-unconsumed window is capped (``credits``; default
``num_async * shards``), starved shards are backfilled FIFO as the consumer
frees credits, and stalls/bytes/occupancy are recorded into the shared
metrics context (``core.metrics``; see ``core.transport`` for the
inter-process data plane itself).
"""

from __future__ import annotations

import copy
import logging
import queue
import threading
import time
import types
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    TypeVar,
    Union,
)

from repro_torch.core.actor import ActorPool, VirtualActor
from repro_torch.core.executor import FailurePolicy
from repro_torch.core.metrics import (
    BYTES_MOVED_PREFIX,
    CREDIT_STALL_TIME,
    GATHER_TIMER_PREFIX,
    INFLIGHT_PREFIX,
    NUM_BYTES_MOVED,
    NUM_CREDIT_STALLS,
    NUM_SHARDS_DROPPED,
    NUM_WORKER_FAILURES,
    MetricsContext,
    get_metrics,
    payload_nbytes,
    set_metrics_for_thread,
)

T = TypeVar("T")
U = TypeVar("U")

logger = logging.getLogger(__name__)

__all__ = [
    "LocalIterator",
    "ParallelIterator",
    "NextValueNotReady",
    "from_actors",
    "from_items",
    "from_iterators",
]


class NextValueNotReady:
    """Sentinel yielded by non-blocking fragments when no item is ready yet.

    Round-robin unions propagate it so one starved branch cannot stall the
    others (paper: asynchronous dependencies / pink arrows).
    """

    def __repr__(self) -> str:  # pragma: no cover
        return "<NextValueNotReady>"


_NOT_READY = NextValueNotReady()


def _apply_stages(item: Any, stages: Sequence[Callable]) -> Any:
    for fn in stages:
        if isinstance(item, NextValueNotReady):
            return item
        item = fn(item)
    return item


class _Exhausted:
    """Internal marker: a shard's underlying stream raised StopIteration.

    PEP 479: raising StopIteration inside a generator is a RuntimeError, so
    the gather generators map finite shards' exhaustion to this marker."""


_EXHAUSTED = _Exhausted()


class _ShardVerdict:
    """Internal marker: how a shard failure was absorbed (policy != raise)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.name}>"


_SKIPPED = _ShardVerdict("item-skipped")  # restart policy: shard stays
_DROPPED = _ShardVerdict("shard-dropped")  # shard leaves the active set


def _absorb_shard_failure(actor: Any, exc: Exception, dropped: Dict[int, str], stream: str) -> Any:
    """Apply the source actor's FailurePolicy to a failed shard dispatch.

    Returns ``_SKIPPED`` (keep shard, lose item) or ``_DROPPED`` (shard
    leaves the set), or re-raises under the default RAISE policy.  Counts
    failures/drops into the driving thread's metrics context.

    ``dropped`` maps actor_id -> drop reason: ``"dead"`` drops are pruned by
    the gather loops when the actor comes back alive (``recover()``'s
    in-place restart), ``"policy"`` drops are permanent for this stream.
    """
    policy = getattr(actor, "failure_policy", FailurePolicy.RAISE)
    metrics = get_metrics()
    metrics.counters[NUM_WORKER_FAILURES] += 1
    if policy == FailurePolicy.RAISE:
        raise exc
    alive = getattr(actor, "alive", True)
    # RESTART is only meaningful when the supervisor can actually heal the
    # worker: it needs a restart budget, and AttributeError is exempt from
    # supervision (protocol probes, see actor._run_loop) so a persistent one
    # can never be fixed by restarting.  Either way, skipping would
    # re-dispatch the same failing call forever (livelock) — degrade to
    # dropping the shard.
    restartable = (
        getattr(getattr(actor, "supervision", None), "max_restarts", 0) > 0
        and not isinstance(exc, AttributeError)
    )
    if policy == FailurePolicy.DROP_SHARD or not alive or not restartable:
        dropped[actor.actor_id] = "dead" if not alive else "policy"
        metrics.counters[NUM_SHARDS_DROPPED] += 1
        # repr(exc) eagerly: a live exception in a LogRecord pins its
        # traceback frames — and any in-flight shm attachments they
        # reference — for as long as a buffering handler (pytest's capture,
        # a QueueHandler) retains the record.
        logger.warning(
            "%s: dropping shard %s after failure (%s); %s",
            stream, getattr(actor, "name", actor), repr(exc),
            "actor dead" if not alive
            else ("drop_shard policy" if policy == FailurePolicy.DROP_SHARD
                  else "restart policy without restart budget"),
        )
        return _DROPPED
    # RESTART policy with a live (supervisor-restarted) actor: the failed
    # item is lost, the shard stays in the set.
    logger.warning(
        "%s: worker %s failed (%s); restart policy, item skipped",
        stream, getattr(actor, "name", actor), repr(exc),
    )
    return _SKIPPED


def _rejoin_revived(dropped: Dict[int, str], shards: Sequence["_Shard"]) -> List["_Shard"]:
    """Prune ``"dead"`` drops whose actor is alive again (healed by
    ``recover()``'s in-place restart) so they rejoin the stream; returns the
    shards revived this round."""
    revived = []
    for s in shards:
        aid = s.actor.actor_id
        if dropped.get(aid) == "dead" and getattr(s.actor, "alive", True):
            del dropped[aid]
            revived.append(s)
    return revived


# --------------------------------------------------------------------------
# LocalIterator
# --------------------------------------------------------------------------
class LocalIterator(Generic[T]):
    """A lazy sequential stream of items with a shared metrics context."""

    def __init__(
        self,
        base_builder: Callable[[], Iterator[T]],
        metrics: Optional[MetricsContext] = None,
        stages: Optional[List[Callable]] = None,
        name: str = "LocalIterator",
        parents: Optional[List["LocalIterator"]] = None,
    ):
        self._base_builder = base_builder
        self._stages: List[Callable] = list(stages or [])
        self.metrics = metrics or MetricsContext()
        self.name = name
        self._built: Optional[Iterator[T]] = None
        # Upstream iterators captured by wrapper generators (flatten,
        # duplicate, union children): close() propagates teardown to them.
        self._parents: List["LocalIterator"] = list(parents or [])

    # ------------------------------------------------------------- plumbing
    def _build(self) -> Iterator[T]:
        if self._built is None:
            self._built = self._base_builder()
        return self._built

    def close(self) -> None:
        """Tear down the driven stream: close the built generator so its
        ``finally`` blocks run now (joining union driver threads, closing
        child branches) instead of at GC time, then close parents."""
        gen = self._built
        if gen is not None and hasattr(gen, "close"):
            try:
                gen.close()
            except RuntimeError:
                # Generator currently executing on another thread; its own
                # teardown path (done-flag) will unwind it.
                pass
        for p in self._parents:
            p.close()

    def __iter__(self) -> Iterator[T]:
        it = self._build()
        while True:
            # Install this dataflow's context before pulling: base generators
            # (gather ops) report current_actor through the thread-local.
            set_metrics_for_thread(self.metrics)
            try:
                item = next(it)
            except StopIteration:
                return
            item = _apply_stages(item, self._stages)
            if isinstance(item, NextValueNotReady):
                continue
            yield item

    def __next__(self) -> T:
        # Pull until a concrete item emerges (skipping not-ready sentinels).
        it = self._build()
        while True:
            set_metrics_for_thread(self.metrics)
            item = next(it)
            item = _apply_stages(item, self._stages)
            if not isinstance(item, NextValueNotReady):
                return item

    def next(self) -> T:
        return self.__next__()

    def _iter_with_sentinels(self) -> Iterator[Any]:
        """Like ``__iter__`` but yields NextValueNotReady through, so unions
        can move on to other branches instead of blocking on a starved one."""
        it = self._build()
        while True:
            set_metrics_for_thread(self.metrics)
            try:
                item = next(it)
            except StopIteration:
                return
            yield _apply_stages(item, self._stages)

    def _chain(self, fn: Callable, name: str) -> "LocalIterator":
        return LocalIterator(
            self._base_builder,
            metrics=self.metrics,
            stages=self._stages + [fn],
            name=f"{self.name}.{name}",
            parents=self._parents,
        )

    # ------------------------------------------------------------ operators
    def for_each(self, fn: Callable[[T], U]) -> "LocalIterator[U]":
        """Transformation operator (paper Fig 6). ``fn`` may be stateful."""
        return self._chain(fn, f"for_each({getattr(fn, '__name__', type(fn).__name__)})")

    def filter(self, predicate: Callable[[T], bool]) -> "LocalIterator[T]":
        def _filter(item: Any) -> Any:
            return item if predicate(item) else _NOT_READY

        return self._chain(_filter, "filter")

    def batch(self, n: int) -> "LocalIterator[List[T]]":
        buf: List[Any] = []

        def _batch(item: Any) -> Any:
            buf.append(item)
            if len(buf) >= n:
                out, buf[:] = list(buf), []
                return out
            return _NOT_READY

        return self._chain(_batch, f"batch({n})")

    def flatten(self) -> "LocalIterator[Any]":
        parent = self

        def _gen() -> Iterator[Any]:
            for item in parent:
                for sub in item:
                    yield sub

        return LocalIterator(
            _gen, metrics=self.metrics, name=f"{self.name}.flatten", parents=[parent]
        )

    def combine(self, fn: Callable[[T], Iterable[U]]) -> "LocalIterator[U]":
        """for_each returning a list, flattened (RLlib's ``combine``)."""
        return self.for_each(fn).flatten()

    def take(self, n: int) -> List[T]:
        out: List[T] = []
        it = iter(self)
        for _ in range(n):
            try:
                out.append(next(it))
            except StopIteration:
                break
        return out

    def zip_with_source_actor(self) -> "LocalIterator[tuple]":
        """Pair each item with the actor that produced it (paper §5.2)."""

        def _zip(item: Any) -> Any:
            return (item, get_metrics().current_actor)

        return self._chain(_zip, "zip_with_source_actor")

    # -------------------------------------------------------------- unions
    def union(
        self,
        *others: "LocalIterator",
        deterministic: bool = False,
        round_robin_weights: Optional[Sequence[Union[int, str]]] = None,
    ) -> "LocalIterator":
        """Concurrency operator (paper Fig 8): merge concurrent fragments.

        deterministic=True  -> round-robin (optionally weighted; weight ``k``
            pulls k items per turn, ``'*'`` drains what is ready).  This is
            the rate-limiting mechanism [Acme] for e.g. replay:sample ratios.
        deterministic=False -> async merge: each child is driven by its own
            thread; items surface in completion order (pink arrows).  The
            driver threads are joined when the merged stream is closed or
            exhausted — they do not leak across dataflows.
        """
        children = [self, *others]
        # Children share one metrics context so counters/current_actor flow.
        merged_metrics = self.metrics
        for c in others:
            for k, v in c.metrics.counters.items():
                merged_metrics.counters[k] += v
            c.metrics = merged_metrics

        if deterministic:
            weights = list(round_robin_weights or [1] * len(children))
            if len(weights) != len(children):
                raise ValueError("round_robin_weights must match #children")

            def _rr_gen() -> Iterator[Any]:
                # Sentinel-aware pulls: a branch that reports "not ready"
                # (e.g. a cold replay buffer) yields its turn instead of
                # blocking the whole union (paper: rate-limited concurrency).
                try:
                    iters = [c._iter_with_sentinels() for c in children]
                    alive = [True] * len(iters)
                    while any(alive):
                        for i, it in enumerate(iters):
                            if not alive[i]:
                                continue
                            pulls = weights[i]
                            n = 1 if pulls == "*" else int(pulls)
                            for _ in range(n):
                                try:
                                    item = next(it)
                                except StopIteration:
                                    alive[i] = False
                                    break
                                yield item  # may be a sentinel; consumer skips
                finally:
                    for c in children:
                        c.close()

            return LocalIterator(
                _rr_gen, metrics=merged_metrics, name="union_rr", parents=children
            )

        def _async_gen() -> Iterator[Any]:
            q: "queue.Queue[Any]" = queue.Queue(maxsize=max(8, 2 * len(children)))
            done = threading.Event()
            n_alive = [len(children)]
            lock = threading.Lock()

            def _put(item: Any) -> bool:
                # Bounded-blocking put that aborts on teardown, so a driver
                # blocked against a full queue can always exit and be joined.
                while not done.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except queue.Full:
                        pass
                return False

            def _drive(child: LocalIterator) -> None:
                try:
                    set_metrics_for_thread(merged_metrics)
                    for item in child:
                        if not _put(item):
                            return
                except BaseException as exc:  # surface errors to consumer
                    _put(exc)
                finally:
                    with lock:
                        n_alive[0] -= 1
                        if n_alive[0] == 0:
                            _put(StopIteration())

            threads = [
                threading.Thread(
                    target=_drive, args=(c,), daemon=True, name=f"union-drive-{i}"
                )
                for i, c in enumerate(children)
            ]
            for t in threads:
                t.start()
            try:
                while True:
                    item = q.get()
                    if isinstance(item, StopIteration):
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                done.set()
                # Unblock drivers racing a full queue, then join them so no
                # daemon threads outlive the merged stream.
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                for t in threads:
                    t.join(timeout=2.0)
                for c in children:
                    c.close()

        return LocalIterator(
            _async_gen, metrics=merged_metrics, name="union_async", parents=children
        )

    def duplicate(self, n: int, bound: int = 1000) -> List["LocalIterator[T]"]:
        """Split an iterator into ``n`` copies (paper Fig 8, split).

        Buffers are inserted to retain items until fully consumed; the
        scheduler bounds memory by warning when a consumer falls more than
        ``bound`` items behind (RLlib Flow behaviour).
        """
        parent_iter = iter(self)
        lock = threading.Lock()
        buffers: List[List[Any]] = [[] for _ in range(n)]
        exhausted = [False]

        def _make(i: int) -> Iterator[Any]:
            while True:
                with lock:
                    if buffers[i]:
                        item = buffers[i].pop(0)
                    elif exhausted[0]:
                        return
                    else:
                        try:
                            item = next(parent_iter)
                        except StopIteration:
                            exhausted[0] = True
                            return
                        for j in range(n):
                            if j != i:
                                buffers[j].append(item)
                                if len(buffers[j]) > bound:
                                    logger.warning(
                                        "duplicate(): consumer %d lags %d items",
                                        j,
                                        len(buffers[j]),
                                    )
                yield item

        return [
            LocalIterator(
                lambda i=i: _make(i),
                metrics=self.metrics,
                name=f"{self.name}.dup{i}",
                parents=[self],
            )
            for i in range(n)
        ]

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalIterator[{self.name}]"


# --------------------------------------------------------------------------
# ParallelIterator
# --------------------------------------------------------------------------
class _Shard:
    """One shard of a parallel iterator, bound to a source actor."""

    def __init__(self, actor: VirtualActor, pull_fn: Callable[[Any], Any]):
        self.actor = actor
        self.pull_fn = pull_fn  # target -> item

    def dispatch(self, stages: Sequence[Callable]) -> "Any":
        """Schedule one item production (pull + stages) onto the actor."""
        pull_fn = self.pull_fn

        def _produce(target: Any) -> Any:
            item = pull_fn(target)
            return _apply_stages(item, stages)

        return self.actor.apply(_produce)


def _clone_stage(fn: Callable) -> Callable:
    """Per-shard stage cloning rule (see ``ParallelIterator.for_each``)."""
    if isinstance(fn, types.FunctionType) or getattr(fn, "share_across_shards", False):
        return fn
    try:
        return copy.deepcopy(fn)
    except Exception:
        return fn


class ParallelIterator(Generic[T]):
    """A parallel stream sharded over an actor pool (``ParIter[T]``).

    When built ``from_actors`` the iterator keeps a reference to the source
    pool and re-syncs shard membership with it inside the gather loops, so
    workers added or removed mid-stream (elastic training, supervision
    replacing a dead actor) join/leave the stream without a rebuild.
    """

    def __init__(
        self,
        shards: Sequence[_Shard],
        name: str = "ParallelIterator",
        pool: Optional[ActorPool] = None,
        pull_fn: Optional[Callable[[Any], Any]] = None,
    ):
        self._shards = list(shards)
        self._pool = pool
        self._pull_fn = pull_fn
        self._pool_version = pool.version if pool is not None else None
        # Original stage callables; per-actor clones are made lazily so that
        # shards added later (elasticity) get their own stateful copies.
        self._stage_fns: List[Callable] = []
        self._clones: List[Dict[int, Callable]] = []
        self.name = name

    # ------------------------------------------------------------- creation
    @classmethod
    def from_actors(
        cls,
        pool: ActorPool,
        pull_fn: Callable[[Any], Any],
        name: str = "ParallelIterator",
    ) -> "ParallelIterator":
        return cls(
            [_Shard(a, pull_fn) for a in pool], name=name, pool=pool, pull_fn=pull_fn
        )

    @property
    def actors(self) -> List[VirtualActor]:
        return [s.actor for s in self._shards]

    def num_shards(self) -> int:
        return len(self._shards)

    # ------------------------------------------------------------ operators
    def for_each(self, fn: Callable[[T], U]) -> "ParallelIterator[U]":
        """Parallel transformation, *executed on the source actor* so that
        ``fn`` can observe actor-local state (paper §4, Transformation).

        Stateful callable classes are cloned per shard (each shard gets its
        own state, as when Ray pickles the callable to each worker) unless
        they set ``share_across_shards = True`` or are not deep-copyable
        (operators that hold actor handles).
        """
        out = ParallelIterator(
            self._shards, name=f"{self.name}.for_each",
            pool=self._pool, pull_fn=self._pull_fn,
        )
        out._stage_fns = self._stage_fns + [fn]
        out._clones = [dict() for _ in out._stage_fns]
        return out

    # Alias matching the paper's pseudocode.
    par_for_each = for_each

    def _stages_for(self, actor: VirtualActor) -> List[Callable]:
        """The per-actor stage chain (clones created lazily per shard)."""
        out: List[Callable] = []
        for i, fn in enumerate(self._stage_fns):
            cache = self._clones[i]
            if actor.actor_id not in cache:
                cache[actor.actor_id] = _clone_stage(fn)
            out.append(cache[actor.actor_id])
        return out

    def _sync_shards(self) -> bool:
        """Reflect source-pool membership changes (elastic add/remove)."""
        if self._pool is None or self._pull_fn is None:
            return False
        if self._pool.version == self._pool_version:
            return False
        self._pool_version = self._pool.version
        have = {s.actor.actor_id: s for s in self._shards}
        self._shards = [
            have.get(a.actor_id) or _Shard(a, self._pull_fn) for a in self._pool
        ]
        return True

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        """Union of two parallel iterators (shards side by side).

        Requires both to be gathered later; stages already applied per side
        are preserved by materializing them into the shard pull functions.
        """
        def _freeze(par: "ParallelIterator") -> List[_Shard]:
            frozen = []
            for s in par._shards:
                stages = par._stages_for(s.actor)
                pull = s.pull_fn

                def _pull(target: Any, _p=pull, _st=tuple(stages)) -> Any:
                    return _apply_stages(_p(target), _st)

                frozen.append(_Shard(s.actor, _pull))
            return frozen

        return ParallelIterator(_freeze(self) + _freeze(other), name=f"{self.name}.union")

    # ------------------------------------------------------------ gathering
    def gather_sync(self, metrics_key: Optional[str] = None) -> "LocalIterator[T]":
        """Deterministic sequencing with *barrier semantics* (paper Fig 7).

        One item is pulled from every shard; upstream actors are fully halted
        between fetches, so messages sent to source actors between item
        fetches are ordered w.r.t. the dataflow (black arrows).  Failed
        shards are skipped/dropped per their actor's FailurePolicy.  Bytes
        yielded are recorded under ``bytes_moved/<metrics_key>``.
        """

        def _gen() -> Iterator[Any]:
            dropped: Dict[int, str] = {}
            while True:
                self._sync_shards()
                _rejoin_revived(dropped, self._shards)
                shards = [s for s in self._shards if s.actor.actor_id not in dropped]
                if not shards:
                    if dropped:
                        raise RuntimeError(f"{self.name}: all shards failed")
                    return
                # Dispatch defensively: an actor stopped mid-round (elastic
                # remove_workers race / teardown) is skipped, but futures
                # already dispatched this round are still gathered so their
                # items are never silently discarded.
                round_start = time.perf_counter()
                futures = []
                for s in shards:
                    try:
                        futures.append((s, s.dispatch(self._stages_for(s.actor))))
                    except RuntimeError:
                        pass
                if not futures:
                    if self._sync_shards():
                        continue  # membership changed: retry with survivors
                    return  # all actors stopped: stream teardown
                # Global barrier: wait for every shard's item.
                results = []
                for s, f in futures:
                    try:
                        item = f.result()
                    except StopIteration:
                        item = _EXHAUSTED
                    except Exception as exc:
                        item = _absorb_shard_failure(s.actor, exc, dropped, self.name)
                    results.append((item, s.actor))
                if any(isinstance(item, _Exhausted) for item, _ in results):
                    return
                # Per-round wall time of the dispatch -> barrier -> gathered
                # window, keyed by node id: the stage's live wall-time column
                # in Algorithm.explain() (for a rollouts source this is the
                # sample time the flow actually observed).
                get_metrics().timers[GATHER_TIMER_PREFIX + key].push(
                    time.perf_counter() - round_start
                )
                for item, actor in results:
                    if isinstance(item, (NextValueNotReady, _ShardVerdict)):
                        continue
                    metrics = get_metrics()
                    metrics.current_actor = actor
                    nbytes = payload_nbytes(item)
                    if nbytes:
                        metrics.counters[NUM_BYTES_MOVED] += nbytes
                        metrics.counters[BYTES_MOVED_PREFIX + key] += nbytes
                    yield item

        key = metrics_key or f"{self.name}.gather_sync"
        return LocalIterator(_gen, name=f"{self.name}.gather_sync")

    def gather_async(
        self,
        num_async: int = 1,
        credits: Optional[int] = None,
        metrics_key: Optional[str] = None,
    ) -> "LocalIterator[T]":
        """Asynchronous sequencing (paper Fig 7, pink arrow).

        Keeps up to ``num_async`` items in flight *per shard*; yields items in
        completion order and immediately backfills the producing shard —
        equivalent to RLlib Flow's async gather with configurable pipeline
        parallelism.  A failed shard is skipped or dropped per its actor's
        FailurePolicy; newly added pool actors join the pipeline mid-stream.

        Backpressure (data plane, ISSUE 3): ``credits`` caps the *total*
        number of dispatched-but-not-yet-consumed items across all shards
        (default: ``num_async * num_shards``, i.e. the per-shard window).  A
        shard that would exceed the window is *starved* instead of
        dispatched; the stall is recorded (``num_credit_stalls`` /
        ``credit_stall_time_s``) and the shard is backfilled as soon as the
        consumer frees a credit — so a slow consumer can never accumulate an
        unbounded completed-item backlog.  ``inflight/<metrics_key>`` gauges
        the window occupancy; bytes yielded are recorded under
        ``bytes_moved/<metrics_key>``.
        """
        if num_async < 1:
            raise ValueError("num_async must be >= 1")
        if credits is not None and credits < 1:
            raise ValueError("credits must be >= 1 (or None for num_async * shards)")

        def _gen() -> Iterator[Any]:
            result_q: "queue.Queue[tuple]" = queue.Queue()
            shard_by_id: Dict[int, _Shard] = {}
            inflight: Dict[int, int] = {}
            dropped: Dict[int, str] = {}
            exhausted: set = set()
            removed: set = set()
            # The credit window: one credit per dispatched-but-unconsumed
            # item, resized as shard membership changes.  Starved shards
            # wait here (aid -> stall start) until a credit frees.
            from repro_torch.core.transport import CreditPool

            credit_pool = CreditPool(credits if credits is not None else 1)
            starved: Dict[int, float] = {}

            def _capacity() -> int:
                if credits is not None:
                    return credits
                live = len(
                    [
                        aid
                        for aid in shard_by_id
                        if aid not in dropped and aid not in removed and aid not in exhausted
                    ]
                )
                return num_async * max(1, live)

            def _dispatch(s: _Shard, have_credit: bool = False) -> None:
                aid = s.actor.actor_id
                if not have_credit and not credit_pool.try_acquire():
                    if aid not in starved:
                        starved[aid] = time.perf_counter()
                        get_metrics().counters[NUM_CREDIT_STALLS] += 1
                    return
                try:
                    fut = s.dispatch(self._stages_for(s.actor))
                except RuntimeError:
                    # Actor stopped between membership sync and dispatch
                    # (graceful remove_workers race): treat as removed.
                    credit_pool.release()
                    removed.add(aid)
                    return
                inflight[aid] = inflight.get(aid, 0) + 1
                fut.add_done_callback(lambda f, aid=aid: result_q.put((aid, f)))

            def _backfill_starved() -> None:
                # A credit was just freed: resume starved shards FIFO,
                # charging their stall time to the shared metrics context.
                while starved and credit_pool.try_acquire():
                    aid, t0 = next(iter(starved.items()))
                    del starved[aid]
                    metrics = get_metrics()
                    metrics.counters[CREDIT_STALL_TIME] = (
                        metrics.counters.get(CREDIT_STALL_TIME, 0)
                        + (time.perf_counter() - t0)
                    )
                    if aid in shard_by_id and aid not in dropped and aid not in removed:
                        _dispatch(shard_by_id[aid], have_credit=True)
                    else:
                        credit_pool.release()

            def _admit() -> None:
                # Pick up pool membership changes (elastic add/remove) and
                # rejoin shards whose dead actor was revived by recover().
                self._sync_shards()
                credit_pool.resize(_capacity())
                for s in _rejoin_revived(dropped, self._shards):
                    for _ in range(num_async - inflight.get(s.actor.actor_id, 0)):
                        _dispatch(s)
                current = set()
                for s in self._shards:
                    aid = s.actor.actor_id
                    current.add(aid)
                    if aid not in shard_by_id:
                        shard_by_id[aid] = s
                        credit_pool.resize(_capacity())
                        for _ in range(num_async):
                            _dispatch(s)
                for aid in shard_by_id:
                    if aid not in current:
                        removed.add(aid)  # stop backfilling; drain in-flight
                        starved.pop(aid, None)
                credit_pool.resize(_capacity())

            _admit()
            while True:
                _admit()  # cheap (pool version compare); elastic sync point
                if sum(inflight.values()) == 0:
                    active = set(shard_by_id) - set(dropped) - exhausted - removed
                    if not active:
                        if dropped and not (exhausted or removed):
                            raise RuntimeError(f"{self.name}: all shards failed")
                        return
                    if starved:
                        _backfill_starved()  # window freed below a live shard
                try:
                    aid, fut = result_q.get(timeout=0.1)
                except queue.Empty:
                    continue  # elastic wake-up: re-check membership
                inflight[aid] -= 1
                credit_pool.release()  # every popped result frees its credit
                gone = aid in dropped or aid in removed
                try:
                    item = fut.result()
                except StopIteration:
                    exhausted.add(aid)
                    starved.pop(aid, None)
                    _backfill_starved()
                    continue
                except Exception as exc:
                    verdict = _absorb_shard_failure(
                        shard_by_id[aid].actor, exc, dropped, self.name
                    )
                    if verdict is _SKIPPED and not gone:
                        _dispatch(shard_by_id[aid])  # keep the pipeline full
                    else:
                        starved.pop(aid, None)
                        _backfill_starved()
                    continue
                if not gone:
                    if starved:
                        # Credits are contended: queue this shard behind the
                        # ones already stalled (FIFO fairness) rather than
                        # letting the fastest producer monopolize the window.
                        if aid not in starved:
                            starved[aid] = time.perf_counter()
                            get_metrics().counters[NUM_CREDIT_STALLS] += 1
                    else:
                        _dispatch(shard_by_id[aid])
                if isinstance(item, NextValueNotReady):
                    _backfill_starved()
                    continue
                metrics = get_metrics()
                metrics.current_actor = shard_by_id[aid].actor
                nbytes = payload_nbytes(item)
                if nbytes:
                    metrics.counters[NUM_BYTES_MOVED] += nbytes
                    metrics.counters[BYTES_MOVED_PREFIX + key] += nbytes
                metrics.gauges[INFLIGHT_PREFIX + key] = sum(inflight.values())
                yield item
                # The consumer took the item: its credit is free again.
                _backfill_starved()

        key = metrics_key or f"{self.name}.gather_async"
        return LocalIterator(_gen, name=f"{self.name}.gather_async")

    def batch_across_shards(
        self, metrics_key: Optional[str] = None
    ) -> "LocalIterator[List[T]]":
        """One synchronized list of per-shard items per pull (sync barrier)."""

        def _gen() -> Iterator[Any]:
            dropped: Dict[int, str] = {}
            while True:
                self._sync_shards()
                _rejoin_revived(dropped, self._shards)
                shards = [s for s in self._shards if s.actor.actor_id not in dropped]
                if not shards:
                    if dropped:
                        raise RuntimeError(f"{self.name}: all shards failed")
                    return
                # Defensive dispatch: see gather_sync — skip actors stopped
                # mid-round but never abandon already-dispatched futures.
                round_start = time.perf_counter()
                futures = []
                for s in shards:
                    try:
                        futures.append((s, s.dispatch(self._stages_for(s.actor))))
                    except RuntimeError:
                        pass
                if not futures:
                    if self._sync_shards():
                        continue
                    return
                items = []
                for s, f in futures:
                    try:
                        items.append(f.result())
                    except StopIteration:
                        items.append(_EXHAUSTED)
                    except Exception as exc:
                        items.append(
                            _absorb_shard_failure(s.actor, exc, dropped, self.name)
                        )
                if any(isinstance(x, _Exhausted) for x in items):
                    return
                # Same per-round gather timer as gather_sync (see there); for
                # a bulk_sync rollouts source this is the observed sample time.
                get_metrics().timers[GATHER_TIMER_PREFIX + key].push(
                    time.perf_counter() - round_start
                )
                items = [
                    x for x in items
                    if not isinstance(x, (NextValueNotReady, _ShardVerdict))
                ]
                if items:
                    metrics = get_metrics()
                    nbytes = payload_nbytes(items)
                    if nbytes:
                        metrics.counters[NUM_BYTES_MOVED] += nbytes
                        metrics.counters[BYTES_MOVED_PREFIX + key] += nbytes
                    yield items

        key = metrics_key or f"{self.name}.batch_across_shards"
        return LocalIterator(_gen, name=f"{self.name}.batch_across_shards")

    def __repr__(self) -> str:  # pragma: no cover
        return f"ParallelIterator[{self.name}, shards={len(self._shards)}]"


# --------------------------------------------------------------------------
# Convenience constructors
# --------------------------------------------------------------------------
def from_actors(pool: ActorPool, method: str = "sample") -> ParallelIterator:
    """Parallel iterator pulling ``actor.target.<method>()`` per item."""
    return ParallelIterator.from_actors(pool, lambda target: getattr(target, method)())


def from_items(items: Sequence[Any], repeat: bool = False) -> LocalIterator:
    def _gen() -> Iterator[Any]:
        while True:
            for x in items:
                yield x
            if not repeat:
                return

    return LocalIterator(_gen, name="from_items")


def from_iterators(
    pools: Sequence[Iterable[Any]],
) -> ParallelIterator:
    """Shard a parallel iterator over plain python iterables (testing aid)."""
    class _IterHolder:
        def __init__(self, it: Iterable[Any]):
            self.it = iter(it)

        def pull(self) -> Any:
            return next(self.it)

    pool = ActorPool.from_targets([_IterHolder(it) for it in pools], name="from_iterators")
    return ParallelIterator.from_actors(pool, lambda t: t.pull())
