"""qwen3-14b [dense] — qk-norm, GQA kv=8.

[hf:Qwen/Qwen3-8B family] Qwen3 technical configuration, 14B scale.
Assignment: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
