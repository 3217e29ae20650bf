from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SgdState,
    adam,
    adamw,
    chain_clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
    sgd,
)

__all__ = [
    "AdamState",
    "Optimizer",
    "SgdState",
    "adam",
    "adamw",
    "chain_clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "sgd",
]
