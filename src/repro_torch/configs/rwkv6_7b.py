"""rwkv6-7b [ssm] — RWKV-6 "Finch": attention-free, data-dependent decay.

[arXiv:2404.05892] Eagle and Finch: RWKV with Matrix-Valued States and
Dynamic Recurrence.
Assignment: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(LayerSpec(kind="rwkv6", mlp="dense"),),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
    source="arXiv:2404.05892",
)
