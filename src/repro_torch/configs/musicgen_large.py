"""musicgen-large [audio] — decoder-only over EnCodec tokens; codec is a STUB.

[arXiv:2306.05284] Simple and Controllable Music Generation.
Assignment: 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.

Per DESIGN.md §4 the EnCodec frontend is not implemented: the decoder
consumes 4 parallel codebook token streams (delay pattern); embeddings are
summed across codebooks and the LM head predicts all 4 codebooks per step.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    modality="audio",
    num_codebooks=4,
    activation="gelu",
    source="arXiv:2306.05284",
)
