from repro_torch.models.transformer import Model, make_train_step

__all__ = ["Model", "make_train_step"]
