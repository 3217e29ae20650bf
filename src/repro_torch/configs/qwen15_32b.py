"""qwen1.5-32b [dense] — GQA kv=40 (MHA-equal), QKV bias.

[hf:Qwen/Qwen1.5-0.5B family] Qwen1.5 technical configuration, 32B scale.
Assignment: 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
