"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, GQA kv=8.

[hf:microsoft/Phi-3.5-MoE-instruct]
Assignment: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16e top-2 (all layers MoE).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
