"""jamba-v0.1-52b [hybrid] — Mamba:attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] Jamba: A Hybrid Transformer-Mamba Language Model.
Assignment: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2.  Jamba block = 8 layers, attention at index 3 (1 attn : 7
mamba), MoE replacing the MLP on every other layer (odd indices).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_BLOCK = tuple(
    LayerSpec(
        kind="attn" if i == 3 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_BLOCK,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)
