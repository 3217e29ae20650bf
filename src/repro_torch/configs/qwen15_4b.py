"""qwen1.5-4b [dense] — GQA kv=20 (MHA-equal), QKV bias.

[hf:Qwen/Qwen1.5-0.5B family] Qwen1.5 technical configuration, 4B scale.
Assignment: 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
