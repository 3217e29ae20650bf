from repro_torch.data.pipeline import TokenPipeline, make_batch, name_digest

__all__ = ["TokenPipeline", "make_batch", "name_digest"]
