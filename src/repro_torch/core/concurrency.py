"""Concurrency operators: Concurrently (union), Enqueue/Dequeue (paper §4/5.2).

``Concurrently`` composes multiple dataflow fragments — the operator the paper
shows enabling Ape-X (store/replay/update sub-flows) and multi-agent PPO+DQN
composition that "end users could not do before without writing low-level
systems code".

``Enqueue``/``Dequeue`` are the credited boundary between a flow and a
deferred resource (learner thread): the queue window is the credit pool, and
``Enqueue``'s overflow policy (``block | drop_newest | drop_oldest``) decides
what happens when the consumer falls behind — with stalls, drops, occupancy,
and bytes all recorded into the shared metrics context (ISSUE 3).
"""

from __future__ import annotations

import queue
import time
from typing import Any, List, Optional, Sequence, Union

from repro_torch.core.iterators import LocalIterator, NextValueNotReady
from repro_torch.core.metrics import (
    BYTES_MOVED_PREFIX,
    CREDIT_STALL_TIME,
    NUM_CREDIT_STALLS,
    NUM_SAMPLES_DROPPED,
    QUEUE_OCCUPANCY_PREFIX,
    get_metrics,
    payload_nbytes,
)
from repro_torch.core.transport import OverflowPolicy

__all__ = ["Concurrently", "Enqueue", "Dequeue", "OverflowPolicy"]


def Concurrently(
    ops: Sequence[LocalIterator],
    mode: str = "round_robin",
    output_indexes: Optional[Sequence[int]] = None,
    round_robin_weights: Optional[Sequence[Union[int, str]]] = None,
) -> LocalIterator:
    """Execute dataflow fragments concurrently; emit from ``output_indexes``.

    mode='round_robin' -> deterministic interleave (optionally weighted — the
        rate-limiting facility for e.g. 1:4 store:replay ratios [Acme]).
    mode='async'       -> each fragment driven independently; items surface in
        completion order (maximum pipeline parallelism).
    """
    if not ops:
        raise ValueError("Concurrently needs at least one op")
    if mode not in ("round_robin", "async"):
        raise ValueError(f"unknown mode {mode!r}")
    out_idx = list(output_indexes) if output_indexes is not None else list(range(len(ops)))
    for i in out_idx:
        if not (0 <= i < len(ops)):
            raise ValueError(f"output index {i} out of range")

    # Tag items with their branch so we can filter after the union.
    tagged: List[LocalIterator] = [
        op.for_each(lambda item, _i=i: (_i, item)) for i, op in enumerate(ops)
    ]

    merged = tagged[0].union(
        *tagged[1:],
        deterministic=(mode == "round_robin"),
        round_robin_weights=round_robin_weights,
    )

    def _select(tagged_item: Any) -> Any:
        i, item = tagged_item
        return item if i in out_idx else NextValueNotReady()

    return merged.for_each(_select)


class Enqueue:
    """Push items into a bounded queue (e.g. a learner thread's in-queue).

    Returns the item (so the flow can continue).  The queue's capacity is the
    credit window; ``policy`` decides what happens when it is exhausted:

      * ``block``       — wait for a free slot, charging the wait to
        ``credit_stall_time_s`` / ``num_credit_stalls`` (lossless Ape-X feed,
        backpressuring the producing sub-flow).
      * ``drop_newest`` — reject the incoming item and count it in
        ``num_samples_dropped`` (the paper's lossy Ape-X behaviour).
      * ``drop_oldest`` — evict the stalest queued item to admit the fresh
        one (bounded staleness: what you want for on-policy-ish feeds).

    Bytes enqueued are recorded under ``bytes_moved/<metrics_key>`` and the
    queue depth is gauged under ``queue_occupancy/<metrics_key>`` so the
    numbers surface in ``Algorithm.train()`` results and ``to_dot()`` labels.

    ``check`` guards blocking puts: while the consumer is alive the put
    retries with a timeout; once ``check()`` is False the stage raises
    instead of blocking a Concurrently driver thread forever against a queue
    nobody will ever drain (flow teardown, dead learner).

    ``block=True/False`` is accepted as a legacy alias for
    ``policy="block"/"drop_newest"``.
    """

    share_across_shards = True
    flow_pure = True  # always returns the item (never NextValueNotReady)

    def __init__(
        self,
        out_queue: "queue.Queue",
        block: Optional[bool] = None,
        check: Any = None,
        policy: Optional[str] = None,
        metrics_key: Optional[str] = None,
    ):
        if policy is None:
            policy = OverflowPolicy.BLOCK if block else OverflowPolicy.DROP_NEWEST
        elif block is not None:
            raise ValueError("pass either block= (legacy) or policy=, not both")
        self.queue = out_queue
        self.policy = OverflowPolicy.validate(policy)
        self.check = check
        self.metrics_key = metrics_key or "enqueue"
        self.num_dropped = 0

    # Kept for callers/tests introspecting the legacy flag.
    @property
    def block(self) -> bool:
        return self.policy == OverflowPolicy.BLOCK

    def __call__(self, item: Any) -> Any:
        metrics = get_metrics()
        if self.policy == OverflowPolicy.BLOCK:
            try:
                self._stamp(item)
                self.queue.put(item, block=False)
            except queue.Full:
                # The window is exhausted: this producer is now stalled on a
                # credit, however briefly — record it, then wait it out.
                stalled_at = time.perf_counter()
                metrics.counters[NUM_CREDIT_STALLS] += 1
                while self.check is None or self.check():
                    try:
                        # Re-stamp per attempt: the queue-wait metric must
                        # measure residency in the queue, not this
                        # producer-side credit stall (already counted).
                        self._stamp(item)
                        self.queue.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    raise RuntimeError("Enqueue check failed: consumer is dead")
                metrics.counters[CREDIT_STALL_TIME] = (
                    metrics.counters.get(CREDIT_STALL_TIME, 0)
                    + (time.perf_counter() - stalled_at)
                )
        elif self.policy == OverflowPolicy.DROP_OLDEST:
            while True:
                try:
                    self._stamp(item)
                    self.queue.put(item, block=False)
                    break
                except queue.Full:
                    try:
                        self.queue.get_nowait()
                        self.num_dropped += 1
                        metrics.counters[NUM_SAMPLES_DROPPED] += 1
                    except queue.Empty:
                        continue  # consumer drained it first: retry the put
        else:  # DROP_NEWEST
            try:
                self._stamp(item)
                self.queue.put(item, block=False)
            except queue.Full:
                self.num_dropped += 1
                metrics.counters[NUM_SAMPLES_DROPPED] += 1
                metrics.gauges[QUEUE_OCCUPANCY_PREFIX + self.metrics_key] = (
                    self.queue.qsize()
                )
                return item
        nbytes = payload_nbytes(item)
        if nbytes:
            metrics.counters[BYTES_MOVED_PREFIX + self.metrics_key] += nbytes
        metrics.gauges[QUEUE_OCCUPANCY_PREFIX + self.metrics_key] = self.queue.qsize()
        return item

    @staticmethod
    def _stamp(item: Any) -> None:
        """Mark the enqueue instant on the payload batch (queue-wait latency
        is measured by the consumer; see ``LearnerThread``)."""
        batch = item[0] if isinstance(item, tuple) and item else item
        try:
            batch._enqueued_at = time.perf_counter()
        except (AttributeError, TypeError):
            pass  # non-batch payloads simply go unmeasured


def Dequeue(
    in_queue: "queue.Queue", check: Any = None, metrics_key: Optional[str] = None
) -> LocalIterator:
    """Iterator over items popped from a queue (e.g. learner out-queue)."""
    key = metrics_key or "dequeue"

    def _gen():
        while True:
            if check is not None and not check():
                raise RuntimeError("Dequeue check failed: producer is dead")
            try:
                item = in_queue.get(timeout=0.05)
            except queue.Empty:
                yield NextValueNotReady()
                continue
            get_metrics().gauges[QUEUE_OCCUPANCY_PREFIX + key] = in_queue.qsize()
            yield item

    return LocalIterator(_gen, name="Dequeue")
