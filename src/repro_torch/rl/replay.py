"""Replay buffers: the actor target behind ``Replay`` / ``StoreToReplayBuffer``
(PyTorch port of ``repro/rl/replay.py``, the same numpy code).

Host-memory (numpy) circular storage — replay never occupies device HBM
(DESIGN.md §3.5).  Proportional prioritized sampling (Ape-X / PER) with
importance weights, plus a uniform mode for vanilla DQN/SAC.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.rl.sample_batch import SampleBatch

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    """Circular replay store keyed by column; thread-safe (actor mailbox
    already serializes calls, the lock guards direct driver access)."""

    def __init__(
        self,
        capacity: int = 50_000,
        sample_batch_size: int = 128,
        prioritized: bool = True,
        alpha: float = 0.6,
        beta: float = 0.4,
        learning_starts: int = 1000,
        seed: int = 0,
    ):
        self.capacity = capacity
        self.sample_batch_size = sample_batch_size
        self.prioritized = prioritized
        self.alpha = alpha
        self.beta = beta
        self.learning_starts = learning_starts
        self._rng = np.random.default_rng(seed)
        self._cols: Dict[str, np.ndarray] = {}
        self._priorities = np.zeros((capacity,), np.float64)
        self._max_prio = 1.0
        self._next = 0
        self._size = 0
        self._lock = threading.Lock()
        self.num_added = 0
        self.num_sampled = 0

    # ------------------------------------------------------------------ add
    def add_batch(self, batch: SampleBatch) -> int:
        with self._lock:
            n = batch.count
            if not self._cols:
                for k, v in batch.items():
                    self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            idx = (self._next + np.arange(n)) % self.capacity
            for k, v in batch.items():
                if k in self._cols:
                    self._cols[k][idx] = v
            self._priorities[idx] = self._max_prio
            self._next = int((self._next + n) % self.capacity)
            self._size = int(min(self._size + n, self.capacity))
            self.num_added += n
            return self._size

    # --------------------------------------------------------------- sample
    def replay(self) -> Optional[SampleBatch]:
        with self._lock:
            if self._size < max(self.learning_starts, self.sample_batch_size):
                time.sleep(0.001)  # cold buffer: avoid a hot polling loop
                return None
            n = self.sample_batch_size
            if self.prioritized:
                p = self._priorities[: self._size] ** self.alpha
                p = p / p.sum()
                idx = self._rng.choice(self._size, size=n, p=p, replace=True)
                w = (self._size * p[idx]) ** (-self.beta)
                w = w / w.max()
            else:
                idx = self._rng.integers(0, self._size, size=n)
                w = np.ones((n,), np.float32)
            out = {k: v[idx] for k, v in self._cols.items()}
            out["weights"] = w.astype(np.float32)
            out["batch_indices"] = idx.astype(np.int64)
            self.num_sampled += n
            return SampleBatch(out)

    # ------------------------------------------------------------ priorities
    def update_priorities(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        with self._lock:
            pr = np.asarray(priorities, np.float64) + 1e-6
            self._priorities[np.asarray(indices, np.int64)] = pr
            self._max_prio = max(self._max_prio, float(pr.max()))

    def stats(self) -> Dict[str, Any]:
        return {
            "size": self._size,
            "added": self.num_added,
            "sampled": self.num_sampled,
            # Data-plane accounting (ISSUE 3): resident bytes + bytes per
            # replayed batch, for occupancy dashboards and bytes/step math.
            "size_bytes": int(sum(v.nbytes for v in self._cols.values())),
            "batch_bytes": int(
                sum(v[: self.sample_batch_size].nbytes for v in self._cols.values())
            ),
        }

    # ------------------------------------------------------------ durability
    def get_state(self) -> Dict[str, Any]:
        """Full resumable state (storage, priorities, cursors, RNG) for
        ``Algorithm.save()``: a restore replays *identically*, including the
        sampling stream."""
        with self._lock:
            return {
                "cols": {k: v.copy() for k, v in self._cols.items()},
                "priorities": self._priorities.copy(),
                "next": self._next,
                "size": self._size,
                "max_prio": self._max_prio,
                "num_added": self.num_added,
                "num_sampled": self.num_sampled,
                "rng": self._rng.bit_generator.state,
            }

    def set_state(self, state: Dict[str, Any]) -> None:
        if len(state["priorities"]) != self.capacity:
            raise ValueError(
                f"checkpointed replay state has capacity {len(state['priorities'])} "
                f"but this buffer was built with capacity {self.capacity}; "
                "restore into a matching buffer"
            )
        with self._lock:
            self._cols = {k: v.copy() for k, v in state["cols"].items()}
            self._priorities = state["priorities"].copy()
            self._next = int(state["next"])
            self._size = int(state["size"])
            self._max_prio = float(state["max_prio"])
            self.num_added = int(state["num_added"])
            self.num_sampled = int(state["num_sampled"])
            self._rng.bit_generator.state = state["rng"]

    def __len__(self) -> int:
        return self._size
