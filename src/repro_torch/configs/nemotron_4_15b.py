"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU MLP, 256k vocab.

[arXiv:2402.16819] Nemotron-4 15B Technical Report.
Assignment: 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    activation="relu2",
    source="arXiv:2402.16819",
)
