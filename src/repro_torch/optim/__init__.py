from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SgdState,
    adam,
    constant_schedule,
    sgd,
)

__all__ = ["AdamState", "Optimizer", "SgdState", "adam", "constant_schedule", "sgd"]
