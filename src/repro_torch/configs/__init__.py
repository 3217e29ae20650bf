"""Model configurations: the dataclasses of ``repro/configs/base.py`` and
the configurations the port runs (``qwen15_4b``, whose attention and
vocabulary widths the RLHF slice uses)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "LayerSpec",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
]
