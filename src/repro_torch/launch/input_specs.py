"""Fake-tensor stand-ins for every model input (no allocation) (PyTorch
port of ``repro/launch/input_specs.py``).

``input_specs(cfg, shape)`` returns the batch the corresponding step
consumes, as fake tensors; ``abstract_params`` / ``abstract_cache`` build
the parameter and cache trees the same way, and ``eval_shape`` runs any
function on such trees (the counterpart of ``jax.eval_shape``).  A fake
tensor carries shape, dtype and device and owns no storage, so the
published widths cost nothing to describe.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import Model

__all__ = [
    "input_specs",
    "decode_window_for",
    "abstract_params",
    "abstract_cache",
    "eval_shape",
    "fake_mode",
]


def decode_window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """KV window for decode shapes: full context at 32k; sliding window for
    the 500k long-context shape."""
    if shape.kind != "decode":
        return 0
    has_attn = any(
        s.kind == "attn" for s in tuple(cfg.prologue) + tuple(cfg.block_pattern)
    )
    if not has_attn:
        return 1  # attention-free: cache is recurrent state; window unused
    if shape.seq_len > 32_768:
        return cfg.decode_window
    return shape.seq_len


_MODE: Optional[Any] = None


def fake_mode() -> Any:
    """The process's one ``FakeTensorMode`` for abstract trees (one mode, so
    trees made by different calls mix in one step)."""
    global _MODE
    if _MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def eval_shape(fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """``fn(*args)`` under the fake mode: its outputs are fake tensors."""
    with fake_mode():
        return fn(*args, **kwargs)


def input_specs(cfg: ModelConfig, shape: InputShape, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(dims, dtype):
        return eval_shape(torch.empty, dims, dtype=dtype, device=device)

    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        tok = (b, 1, cfg.num_codebooks) if cfg.modality == "audio" else (b, 1)
        out["tokens"] = spec(tok, i32)
        return out
    if cfg.modality == "audio":
        out["tokens"] = spec((b, s, cfg.num_codebooks), i32)
    elif cfg.modality == "vlm":
        out["tokens"] = spec((b, s - cfg.num_media_tokens), i32)
        out["media_emb"] = spec((b, cfg.num_media_tokens, cfg.d_model), torch.float32)
    else:
        out["tokens"] = spec((b, s), i32)
    if shape.kind == "train":
        out["labels"] = spec(tuple(out["tokens"].shape), i32)
    return out


def abstract_params(model: Model, device: Any = "cpu") -> Any:
    return eval_shape(lambda: model.init_params(torch.Generator(device=device)))


def abstract_cache(model: Model, batch: int, window: int, device: Any = "cpu") -> Any:
    return eval_shape(model.init_cache, batch, window, device)

