"""Shared metrics context that travels with a dataflow.

The paper routes training statistics through the dataflow itself
(``ReportMetrics``); operator-internal bookkeeping (counters such as
``num_steps_sampled``, timers such as ``apply_timer``) lives in a *shared
metrics context* attached to the local iterator — the same design RLlib Flow
uses so that operators stay pure item transforms while still being observable.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

__all__ = [
    "TimerStat",
    "LatencyStat",
    "MetricsContext",
    "get_metrics",
    "set_metrics_for_thread",
    "payload_nbytes",
]

# Canonical counter names used by the built-in operators (mirrors RLlib Flow).
STEPS_SAMPLED_COUNTER = "num_steps_sampled"
STEPS_TRAINED_COUNTER = "num_steps_trained"
AGENT_STEPS_SAMPLED_COUNTER = "num_agent_steps_sampled"
TARGET_NET_UPDATES = "num_target_updates"

# Fault-tolerance counters (executor runtime, ISSUE 2): recorded by the
# gather operators / Enqueue so failures surface in Algorithm.train() results.
NUM_SAMPLES_DROPPED = "num_samples_dropped"
NUM_WORKER_FAILURES = "num_worker_failures"
NUM_SHARDS_DROPPED = "num_shards_dropped"

# Data-plane accounting (ISSUE 3): recorded by the gather operators, the
# queue operators (Enqueue/Dequeue), and the learner thread.  Per-operator
# breakdowns use the ``<name>/<operator-key>`` convention (the flow compiler
# keys them by node id so ``to_dot`` can label edges).
NUM_BYTES_MOVED = "num_bytes_moved"
NUM_CREDIT_STALLS = "num_credit_stalls"
CREDIT_STALL_TIME = "credit_stall_time_s"
BYTES_MOVED_PREFIX = "bytes_moved/"
QUEUE_OCCUPANCY_PREFIX = "queue_occupancy/"
INFLIGHT_PREFIX = "inflight/"
# Per-round wall time of a sync gather (dispatch -> barrier -> gathered),
# keyed by node id — the live wall-time column Algorithm.explain() joins
# for source nodes.
GATHER_TIMER_PREFIX = "gather/"

# Latency streams (LatencyStat reservoirs; p50/p99 surfaced by save()).
SAMPLE_TO_LEARN_LATENCY = "sample_to_learn_s"
LEARNER_QUEUE_WAIT = "learner_queue_wait_s"

SAMPLE_TIMER = "sample"
GRAD_WAIT_TIMER = "grad_wait"
APPLY_GRADS_TIMER = "apply_grad"
LEARN_ON_BATCH_TIMER = "learn"
UPDATE_PRIORITIES_TIMER = "update_priorities"


def payload_nbytes(item: Any, _depth: int = 0) -> int:
    """Best-effort byte size of a dataflow item (SampleBatch-aware).

    Counts numpy-backed payloads (``size_bytes()`` / ``nbytes``) through one
    level of tuple/list/dict nesting — enough for every wire shape the
    operators produce ((batch, actor), (grads, info), [batch, ...]).
    """
    if item is None or _depth > 2:
        return 0
    size_fn = getattr(item, "size_bytes", None)
    if callable(size_fn):
        try:
            return int(size_fn())
        except Exception:
            return 0
    nbytes = getattr(item, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(item, (tuple, list)):
        return sum(payload_nbytes(x, _depth + 1) for x in item)
    if isinstance(item, dict):
        return sum(payload_nbytes(x, _depth + 1) for x in item.values())
    batches = getattr(item, "policy_batches", None)  # MultiAgentBatch
    if isinstance(batches, dict):
        return sum(payload_nbytes(x, _depth + 1) for x in batches.values())
    return 0


class TimerStat:
    """EWMA + total timer, context-manager style (paper Listing A2)."""

    def __init__(self, window: int = 100):
        self._window = window
        self.count = 0
        self.total = 0.0
        self.mean = 0.0
        self.units = 0.0
        self._start: Optional[float] = None

    def __enter__(self) -> "TimerStat":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        assert self._start is not None
        self.push(time.perf_counter() - self._start)
        self._start = None

    def push(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        alpha = 2.0 / (min(self.count, self._window) + 1)
        self.mean = dt if self.count == 1 else (1 - alpha) * self.mean + alpha * dt

    def push_units_processed(self, n: float) -> None:
        self.units += n

    @property
    def mean_throughput(self) -> float:
        return self.units / self.total if self.total else 0.0


class LatencyStat:
    """Sliding-window latency reservoir with percentile summaries.

    A fixed ring of the last ``window`` observations: pushes are O(1) and
    lock-free (single-writer per stream in practice; racy reads only smear
    the percentile by one sample), ``summary()`` computes p50/p99 on a copy.
    """

    def __init__(self, window: int = 512):
        self._window = window
        self._ring = [0.0] * window
        self.count = 0
        self.total = 0.0

    def push(self, dt: float) -> None:
        self._ring[self.count % self._window] = dt
        self.count += 1
        self.total += dt

    def _values(self) -> list:
        n = min(self.count, self._window)
        return list(self._ring[:n])

    @staticmethod
    def _pct(sorted_vals: list, p: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, max(0, int(round((p / 100.0) * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def percentile(self, p: float) -> float:
        return self._pct(sorted(self._values()), p)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        vals = sorted(self._values())
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self._pct(vals, 50.0),
            "p99": self._pct(vals, 99.0),
        }


class MetricsContext:
    """Counters/timers/info shared by all operators of one dataflow.

    ``current_actor`` is set by gather operators while an item produced by a
    given source actor is in flight — this is what ``zip_with_source_actor``
    and fine-grained message passing (e.g. Ape-X per-worker weight updates)
    read.
    """

    def __init__(self) -> None:
        self.counters: Dict[str, int] = defaultdict(int)
        self.timers: Dict[str, TimerStat] = defaultdict(TimerStat)
        self.latencies: Dict[str, LatencyStat] = defaultdict(LatencyStat)
        self.gauges: Dict[str, float] = {}
        self.info: Dict[str, Any] = {}
        self.current_actor: Any = None
        self._lock = threading.Lock()
        # Pull-based publishers (ISSUE 9): subsystems that keep their own
        # counters (the inference router, external pools) register a probe
        # ``fn(ctx)`` that writes into this context; ``save()`` runs them
        # first, so serving gauges land in every train() result without the
        # subsystem pushing on its own hot path.
        self._probes: list = []

    def register_probe(self, probe: Any) -> None:
        with self._lock:
            self._probes.append(probe)

    def unregister_probe(self, probe: Any) -> None:
        with self._lock:
            if probe in self._probes:
                self._probes.remove(probe)

    def run_probes(self) -> None:
        with self._lock:
            probes = list(self._probes)
        for probe in probes:
            try:
                probe(self)
            except Exception:  # a dead publisher must not break reporting
                pass

    @staticmethod
    def _racefree_copy(d: Dict) -> Dict:
        """Copy a dict that other (driver) threads may be inserting into.

        Concurrently/union driver threads insert first-time counter/timer
        keys without locking; a plain ``dict()`` copy can then raise
        "dictionary changed size during iteration".  Retry — key insertion
        is rare (values mutating mid-copy is fine)."""
        for _ in range(1000):
            try:
                return dict(d)
            except RuntimeError:
                continue
        return dict(d)  # pragma: no cover - pathological contention

    def snapshot_counters(self) -> Dict[str, int]:
        return self._racefree_copy(self.counters)

    def save(self) -> Dict[str, Any]:
        self.run_probes()
        return {
            "counters": self.snapshot_counters(),
            "info": self._racefree_copy(self.info),
            "timers": {
                k: {"mean": v.mean, "count": v.count, "throughput": v.mean_throughput}
                for k, v in self._racefree_copy(self.timers).items()
            },
            "gauges": self._racefree_copy(self.gauges),
            "latencies": {
                k: v.summary() for k, v in self._racefree_copy(self.latencies).items()
            },
        }


# Thread-local pointer to the metrics context of the dataflow currently being
# driven on this thread (gather operators install it before running stages).
_local = threading.local()


def get_metrics() -> MetricsContext:
    ctx = getattr(_local, "metrics", None)
    if ctx is None:
        ctx = MetricsContext()
        _local.metrics = ctx
    return ctx


def set_metrics_for_thread(ctx: Optional[MetricsContext]) -> None:
    _local.metrics = ctx
