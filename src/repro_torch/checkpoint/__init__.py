from repro_torch.checkpoint.checkpoint import restore_pytree, save_pytree

__all__ = ["save_pytree", "restore_pytree"]
