"""llava-next-34b [vlm] — anyres tiling; vision frontend is a STUB.

[hf:llava-hf/llava-v1.6-mistral-7b-hf family] LLaVA-NeXT, 34B backbone.
Assignment: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Per DESIGN.md §4 the ViT/projector is not implemented: ``input_specs``
provides precomputed patch embeddings (anyres: base 576 tokens + 4 tiles
x 576 = 2880 media tokens) prepended to the text tokens.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    modality="vlm",
    num_media_tokens=2880,  # anyres: (1 base + 4 tiles) x 24x24 patches
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
