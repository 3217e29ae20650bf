"""Deterministic synthetic token pipeline (numpy-only copy of
``repro/data/pipeline.py``).

Produces per-host shards of the global batch (standard multi-host input
pipeline contract: each host feeds its slice; the mesh assembles the global
array).  Deterministic in (seed, step, host) so restarts are reproducible —
consistent with the paper's weak-durability stance (§3): on failure we
restart from the checkpointed step and regenerate identical data.

One change from the reference: the generator is seeded with a stable digest
of the configuration's name (``name_digest``, CRC-32) where the reference
takes ``abs(hash(cfg.name))``.  Python salts ``str`` hashes per process, so
the reference's batches differ between two processes with the same
(seed, step, host); the port's do not.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig

__all__ = ["TokenPipeline", "make_batch", "name_digest"]


def name_digest(name: str) -> int:
    """A seed word for ``name`` that is the same in every process."""
    return zlib.crc32(name.encode()) % 2**31


def make_batch(
    cfg: ModelConfig,
    shape: InputShape,
    seed: int = 0,
    step: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    dtype: Any = np.int32,
) -> Dict[str, np.ndarray]:
    """One deterministic batch shard for (cfg, shape, step, host)."""
    if shape.global_batch % num_hosts:
        raise ValueError(f"global_batch {shape.global_batch} % hosts {num_hosts} != 0")
    b = shape.global_batch // num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host_id, name_digest(cfg.name)])
    )
    s = shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if shape.kind == "decode":
        tok_s = 1
    else:
        tok_s = s
    if cfg.modality == "audio":
        tokens = rng.integers(0, cfg.vocab_size, (b, tok_s, cfg.num_codebooks), dtype=dtype)
    elif cfg.modality == "vlm" and shape.kind != "decode":
        text_s = tok_s - cfg.num_media_tokens
        tokens = rng.integers(0, cfg.vocab_size, (b, text_s), dtype=dtype)
        out["media_emb"] = rng.standard_normal(
            (b, cfg.num_media_tokens, cfg.d_model), dtype=np.float32
        )
    else:
        tokens = rng.integers(0, cfg.vocab_size, (b, tok_s), dtype=dtype)
    out["tokens"] = tokens
    if shape.kind == "train":
        # Next-token labels: shift by one within the same synthetic stream.
        labels = np.roll(tokens, -1, axis=1).astype(dtype)
        if cfg.modality != "audio":
            labels[:, -1] = -100  # mask the wrapped position
        out["labels"] = labels
    return out


class TokenPipeline:
    """Iterator of batch shards; integrates with the dataflow layer as a
    creation operator (each rollout/data actor owns one pipeline shard)."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(
            self.cfg, self.shape, self.seed, self.step, self.host_id, self.num_hosts
        )
        self.step += 1
        return batch

    # Worker-protocol alias so an ActorPool of pipelines feeds ParallelIterator.
    def sample(self) -> Dict[str, np.ndarray]:
        return next(self)
