"""Learner thread: decouples gradient updates from the dataflow driver.

High-throughput plans (Ape-X, IMPALA) keep the learner busy on its own thread
fed by an in-queue; results (and replay priorities) surface on an out-queue.
This is exactly the paper's Listing A3 LearnerThread.

Data-plane instrumentation (ISSUE 3): when the flow runtime hands the thread
its shared ``MetricsContext`` (``FlowRuntime.ensure_started``), every batch
learned records

  * ``sample_to_learn_s``    — end-to-end latency from the batch's birth
    stamp (``SampleBatch.created_at``, monotonic and cross-process on one
    host) to the moment the learner picks it up;
  * ``learner_queue_wait_s`` — time spent waiting in the in-queue (stamped
    by ``Enqueue``);
  * ``queue_occupancy/learner_in|learner_out`` gauges.

The out-queue applies an overflow policy (``drop_newest`` keeps the paper's
lossy metrics behaviour; ``drop_oldest``/``block`` are available for flows
that treat learner info as load-bearing).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional, Tuple

from repro_torch.core.metrics import (
    LEARNER_QUEUE_WAIT,
    QUEUE_OCCUPANCY_PREFIX,
    SAMPLE_TO_LEARN_LATENCY,
    MetricsContext,
    TimerStat,
)
from repro_torch.core.transport import OverflowPolicy

__all__ = ["LearnerThread"]


class LearnerThread(threading.Thread):
    def __init__(
        self,
        local_worker: Any,
        in_queue_size: int = 16,
        out_queue_size: int = 64,
        out_policy: str = OverflowPolicy.DROP_NEWEST,
        num_learners: int = 0,
        microbatch: int = 0,
    ):
        super().__init__(name="learner", daemon=True)
        self.local_worker = local_worker
        # Sharded SPMD lowering (ISSUE 4): with num_learners/microbatch set,
        # updates run through a data-parallel learner group on a device
        # mesh instead of the worker's single-device learn_on_batch.
        # Declared in flow graphs via spec.learner_thread(workers,
        # num_learners=..., microbatch=...) (FlowRuntime passes params
        # through) and the worker stays the canonical weight owner.
        self.learner_group: Any = None
        if num_learners > 1 or microbatch > 1:
            if hasattr(local_worker, "_loss_for"):
                from repro_torch.rl.learner_group import ShardedLearnerGroup

                self.learner_group = ShardedLearnerGroup(
                    local_worker, num_learners=num_learners, microbatch=microbatch
                )
            else:
                import logging

                logging.getLogger(__name__).warning(
                    "LearnerThread(num_learners=%d, microbatch=%d): worker %s "
                    "has no pure loss (_loss_for); falling back to its plain "
                    "single-device learn_on_batch",
                    num_learners, microbatch, type(local_worker).__name__,
                )
        self.inqueue: "queue.Queue[Any]" = queue.Queue(maxsize=in_queue_size)
        self.outqueue: "queue.Queue[Tuple[Any, Any, int]]" = queue.Queue(maxsize=out_queue_size)
        self.out_policy = OverflowPolicy.validate(out_policy)
        self.weights_updated = False
        self.stopped = False
        self.learn_timer = TimerStat()
        self.num_steps = 0
        self.num_out_dropped = 0
        # Shared metrics context of the owning flow; assigned by
        # FlowRuntime.ensure_started before start() (None = standalone use).
        self.metrics: Optional[MetricsContext] = None

    def run(self) -> None:
        try:
            self._serve()
        finally:
            # The group's child ranks live as long as the thread that steps them.
            if self.learner_group is not None:
                self.learner_group.close()

    def _serve(self) -> None:
        while not self.stopped:
            try:
                item = self.inqueue.get(timeout=0.1)
            except queue.Empty:
                continue
            t_pickup = time.perf_counter()
            # Items may be (batch, replay_actor) pairs or bare batches.
            if isinstance(item, tuple) and len(item) == 2:
                batch, source_actor = item
            else:
                batch, source_actor = item, None
            self._record_latency(batch, t_pickup)
            learn = (
                self.learner_group.learn_on_batch
                if self.learner_group is not None
                else self.local_worker.learn_on_batch
            )
            with self.learn_timer:
                info = learn(batch)
            self.weights_updated = True
            self.num_steps += 1
            self._put_out((source_actor, batch, info))

    def _record_latency(self, batch: Any, t_pickup: float) -> None:
        if self.metrics is None:
            return
        created = getattr(batch, "created_at", None)
        if isinstance(created, float):
            self.metrics.latencies[SAMPLE_TO_LEARN_LATENCY].push(t_pickup - created)
        enqueued = getattr(batch, "_enqueued_at", None)
        if isinstance(enqueued, float):
            self.metrics.latencies[LEARNER_QUEUE_WAIT].push(t_pickup - enqueued)
        self.metrics.gauges[QUEUE_OCCUPANCY_PREFIX + "learner_in"] = self.inqueue.qsize()
        self.metrics.gauges[QUEUE_OCCUPANCY_PREFIX + "learner_out"] = self.outqueue.qsize()

    def _put_out(self, result: Tuple[Any, Any, Any]) -> None:
        if self.out_policy == OverflowPolicy.BLOCK:
            while not self.stopped:
                try:
                    self.outqueue.put(result, timeout=0.05)
                    return
                except queue.Full:
                    continue
            return
        try:
            self.outqueue.put(result, block=False)
            return
        except queue.Full:
            pass
        if self.out_policy == OverflowPolicy.DROP_OLDEST:
            while True:
                try:
                    self.outqueue.get_nowait()
                    self.num_out_dropped += 1
                except queue.Empty:
                    pass
                try:
                    self.outqueue.put(result, block=False)
                    return
                except queue.Full:
                    continue
        # DROP_NEWEST: metrics loss is tolerable (paper §3: weak consistency)
        self.num_out_dropped += 1

    def stop(self) -> None:
        self.stopped = True
