from repro_torch.models.transformer import (
    Model,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["Model", "make_train_step", "make_prefill_step", "make_decode_step"]
