"""Credit primitives of the data plane: overflow policies and credit pools.

Credit-based backpressure (``CreditPool``): ``gather_async`` acquires a
credit per dispatched-but-unconsumed item and releases it as the consumer
drains results (starved shards backfill FIFO); the queue operators
(``Enqueue``/learner queues) use their bounded queue capacity as the window
with an overflow policy.  Both replace open-loop buffering with a bounded,
observable window (credit stalls + occupancy are recorded into the shared
metrics context; see ``core.metrics``).

The reference's inter-process transports (pipe, shared-memory ring segments,
framed sockets) serve its process and multi-host backends, which the port
does not have yet; they come over with those backends.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["CreditPool", "OverflowPolicy"]


# --------------------------------------------------------------------------
# Overflow policies (shared by Enqueue / learner queues)
# --------------------------------------------------------------------------
class OverflowPolicy:
    """What a bounded producer does when its window/queue is full.

    BLOCK       -> wait for a credit/slot, recording stall time.
    DROP_NEWEST -> reject the incoming item (count it dropped).
    DROP_OLDEST -> evict the oldest buffered item to admit the new one.
    """

    BLOCK = "block"
    DROP_NEWEST = "drop_newest"
    DROP_OLDEST = "drop_oldest"
    ALL = frozenset((BLOCK, DROP_NEWEST, DROP_OLDEST))

    @classmethod
    def validate(cls, policy: str) -> str:
        if policy not in cls.ALL:
            raise ValueError(
                f"unknown overflow policy {policy!r}; expected one of {sorted(cls.ALL)}"
            )
        return policy


class CreditPool:
    """A bounded pool of in-flight credits (the backpressure primitive).

    Producers ``try_acquire()`` before dispatching an item and ``release()``
    when the consumer has taken it; a ``None`` capacity means unbounded
    (always grants).  Thread-safe; resizable mid-stream (elastic shards).
    """

    def __init__(self, capacity: Optional[int]):
        if capacity is not None and capacity < 1:
            raise ValueError("credit capacity must be >= 1 (or None for unbounded)")
        self._capacity = capacity
        self._outstanding = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> Optional[int]:
        return self._capacity

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def resize(self, capacity: Optional[int]) -> None:
        with self._lock:
            self._capacity = capacity

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            if self._capacity is not None and self._outstanding + n > self._capacity:
                return False
            self._outstanding += n
            return True

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._outstanding = max(0, self._outstanding - n)
