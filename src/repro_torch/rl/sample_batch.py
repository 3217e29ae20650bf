"""SampleBatch: the unit of data flowing through RLlib Flow dataflows.

A thin, columnar dict-of-arrays (numpy on host — replay buffers and iterator
plumbing stay off-device; JAX arrays enter only inside jitted steps).  Also
``MultiAgentBatch`` for the multi-agent composition workflows (paper §5.3).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

__all__ = ["SampleBatch", "MultiAgentBatch", "concat_batches"]

# Canonical column names.
OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGITS = "logits"
LOGP = "logp"
VALUES = "values"
ADVANTAGES = "advantages"
RETURNS = "returns"
WEIGHTS = "weights"  # importance weights (prioritized replay)
EPS_ID = "eps_id"


def _check_one_schema(batches: Sequence["SampleBatch"]) -> None:
    first = batches[0]
    for i, b in enumerate(batches[1:], start=1):
        for k in sorted(set(first.keys()) ^ set(b.keys())):
            where = "part 0" if k in first._data else f"part {i}"
            raise TypeError(
                f"concat_samples: column {k!r} is only in {where}; every part "
                "must carry the same columns"
            )
        for k in first.keys():
            a, c = np.asarray(first[k]), np.asarray(b[k])
            if a.dtype != c.dtype:
                raise TypeError(
                    f"concat_samples: column {k!r} is {a.dtype} in part 0 and "
                    f"{c.dtype} in part {i}; convert the parts to one dtype first"
                )
            if a.shape[1:] != c.shape[1:]:
                raise TypeError(
                    f"concat_samples: column {k!r} has trailing shape {a.shape[1:]} "
                    f"in part 0 and {c.shape[1:]} in part {i}"
                )


class SampleBatch(Mapping[str, np.ndarray]):
    """Columnar batch of experiences; all columns share leading dim."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, **cols: Any):
        merged = dict(data or {})
        merged.update(cols)
        self._data: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in merged.items()
        }
        if self._data:
            lens = {k: v.shape[0] for k, v in self._data.items()}
            if len(set(lens.values())) > 1:
                raise ValueError(f"ragged SampleBatch columns: {lens}")
        # Birth stamp (CLOCK_MONOTONIC: comparable across processes on one
        # host) — the data-plane instrumentation measures sample->learn
        # latency from it.  Derived batches inherit/propagate it (slice:
        # same stamp; concat: earliest constituent).
        self.created_at: float = time.perf_counter()

    # Mapping interface -----------------------------------------------------
    def __getitem__(self, k: str) -> np.ndarray:
        return self._data[k]

    def __setitem__(self, k: str, v: Any) -> None:
        v = np.asarray(v)
        if self._data and v.shape[0] != self.count:
            raise ValueError(f"column {k} len {v.shape[0]} != batch len {self.count}")
        self._data[k] = v

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, k: object) -> bool:
        return k in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    # Batch ops -------------------------------------------------------------
    @property
    def count(self) -> int:
        if not self._data:
            return 0
        return next(iter(self._data.values())).shape[0]

    def slice(self, start: int, end: int) -> "SampleBatch":
        out = SampleBatch({k: v[start:end] for k, v in self._data.items()})
        out.created_at = self.created_at
        return out

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        out = SampleBatch({k: v[perm] for k, v in self._data.items()})
        out.created_at = self.created_at
        return out

    def minibatches(self, size: int, rng: Optional[np.random.Generator] = None):
        b = self.shuffle(rng) if rng is not None else self
        for i in range(0, b.count - size + 1, size):
            yield b.slice(i, i + size)

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self._data:
            return [self]
        ids = self._data[EPS_ID]
        out, start = [], 0
        for i in range(1, len(ids)):
            if ids[i] != ids[i - 1]:
                out.append(self.slice(start, i))
                start = i
        out.append(self.slice(start, len(ids)))
        return out

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        """Concatenate parts of ONE schema: the same columns, each with one
        dtype and one trailing shape.  A part that differs raises
        ``TypeError`` naming the column (the reference drops or ``KeyError``s
        on a differing key set and lets numpy promote dtypes)."""
        batches = [b for b in batches if b.count > 0]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        _check_one_schema(batches)
        out = SampleBatch(
            {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys}
        )
        out.created_at = min(
            getattr(b, "created_at", out.created_at) for b in batches
        )
        return out

    def shard(self, num_shards: int) -> List["SampleBatch"]:
        """Contiguous equal-row split for data-parallel learner groups.

        The transport-boundary half of learner sharding: each shard is a
        zero-copy view batch (numpy slicing) destined for one learner
        device/process.  Rows must tile ``num_shards`` evenly — trimming or
        padding is a *policy* decision left to the caller
        (``ShardedLearnerGroup`` trims and counts).
        """
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive (got {num_shards})")
        if self.count % num_shards:
            raise ValueError(
                f"cannot shard {self.count} rows into {num_shards} equal parts"
            )
        rows = self.count // num_shards
        return [self.slice(i * rows, (i + 1) * rows) for i in range(num_shards)]

    def copy(self) -> "SampleBatch":
        out = SampleBatch({k: v.copy() for k, v in self._data.items()})
        out.created_at = self.created_at
        return out

    def size_bytes(self) -> int:
        return int(sum(v.nbytes for v in self._data.values()))

    def __repr__(self) -> str:  # pragma: no cover
        cols = {k: tuple(v.shape) for k, v in self._data.items()}
        return f"SampleBatch(count={self.count}, cols={cols})"


def concat_batches(batches: Sequence[SampleBatch]) -> SampleBatch:
    return SampleBatch.concat_samples(batches)


class MultiAgentBatch:
    """Per-policy batches produced by multi-agent rollouts (paper §5.3)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch]):
        self.policy_batches = dict(policy_batches)

    @property
    def count(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    def select(self, policy_ids: Sequence[str]) -> "MultiAgentBatch":
        return MultiAgentBatch(
            {p: b for p, b in self.policy_batches.items() if p in policy_ids}
        )

    @staticmethod
    def concat_samples(batches: Sequence["MultiAgentBatch"]) -> "MultiAgentBatch":
        merged: Dict[str, List[SampleBatch]] = {}
        for mb in batches:
            for p, b in mb.policy_batches.items():
                merged.setdefault(p, []).append(b)
        return MultiAgentBatch(
            {p: SampleBatch.concat_samples(bs) for p, bs in merged.items()}
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"MultiAgentBatch({ {p: b.count for p, b in self.policy_batches.items()} })"
