"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed MoE top-6.

[arXiv:2405.04434] DeepSeek-V2: A Strong, Economical, and Efficient
Mixture-of-Experts Language Model (Lite variant).
Assignment: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, 2 shared experts.
First layer uses a dense MLP (DeepSeek-V2 convention).
"""

from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,  # dense (first-layer) MLP width, DeepSeek-V2-Lite
    vocab_size=102400,
    prologue=(LayerSpec(kind="attn", mlp="dense"),),
    block_pattern=(LayerSpec(kind="attn", mlp="moe"),),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff=1408),
    rope_theta=10000.0,
    source="arXiv:2405.04434",
)
