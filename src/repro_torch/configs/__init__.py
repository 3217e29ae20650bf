"""Model configurations: the dataclasses of ``repro/configs/base.py``, the
architectures the port runs (``qwen1.5-4b``, whose attention and vocabulary
widths the RLHF slice uses; ``rwkv6-7b`` and ``phi3.5-moe-42b-a6.6b``,
which the LM pretraining slice trains), and ``reduced_config``, the
reference's same-family reduction for CPU tests."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi
from repro_torch.configs.qwen15_4b import CONFIG as _qwen4
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv

ARCHITECTURES: Dict[str, ModelConfig] = {c.name: c for c in [_rwkv, _qwen4, _phi]}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch_id]


def reduced_config(arch_id: str, num_layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=4 experts,
    2 layers, d_model<=512); the reference's ``reduced_config``."""
    cfg = get_config(arch_id)
    head_dim = 64
    num_heads = max(d_model // head_dim, 1)
    num_kv = num_heads if cfg.num_kv_heads == cfg.num_heads else max(num_heads // 2, 1)
    if cfg.num_heads == 0:  # attention-free
        num_heads = num_kv = 0
    pattern = cfg.block_pattern[: min(len(cfg.block_pattern), num_layers)]
    blocks = num_layers // len(pattern)
    replace = dict(
        num_layers=len(pattern) * blocks,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim if num_heads else 0,
        d_ff=d_model * 3,
        vocab_size=512,
        prologue=(),
        block_pattern=pattern,
        num_media_tokens=min(cfg.num_media_tokens, 16),
        decode_window=64,
    )
    if cfg.moe is not None:
        replace["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, num_shared=min(cfg.moe.num_shared, 1),
            d_ff=d_model * 2,
        )
    if cfg.mla is not None:
        replace["mla"] = MLAConfig(
            kv_lora_rank=64, rope_head_dim=32, nope_head_dim=head_dim, v_head_dim=head_dim
        )
    if cfg.ssm is not None:
        replace["ssm"] = dataclasses.replace(cfg.ssm, head_dim=32, chunk=16)
    return dataclasses.replace(cfg, name=f"{cfg.name}-smoke", **replace)


__all__ = [
    "ARCHITECTURES",
    "INPUT_SHAPES",
    "InputShape",
    "LayerSpec",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "reduced_config",
]
