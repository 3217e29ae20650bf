from repro_torch.optim.optimizers import AdamState, Optimizer, adam, constant_schedule

__all__ = ["AdamState", "Optimizer", "adam", "constant_schedule"]
