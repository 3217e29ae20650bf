"""Model / run configuration dataclasses (copied from
``repro/configs/base.py``; the port keeps its own copy so that it imports
nothing of the JAX package).

A ``ModelConfig`` fully determines parameter shapes and the layer stack.  The
stack is expressed as a repeated ``block_pattern`` of ``LayerSpec`` entries;
parameters of the repeated blocks are stacked along a leading ``num_blocks``
axis, as the reference stacks them for its ``lax.scan`` over blocks, and the
port's model loops over that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "MLAConfig",
    "MoEConfig",
    "SSMConfig",
    "LayerSpec",
    "ModelConfig",
    "InputShape",
    "INPUT_SHAPES",
]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    num_shared: int = 0          # shared (always-on) experts, DeepSeek-style
    d_ff: int = 1408             # per-expert hidden width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # 'gather': build dispatch/combine with take_along_axis (contiguous
    # slots after the per-row sort) — no forward scatter, so XLA cannot
    # lower it as partial-scatter + all-reduce (§Perf iteration B1).
    # 'scatter': original .at[].add dispatch (baseline).
    dispatch: str = "gather"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"          # 'mamba' | 'rwkv6'
    d_state: int = 16            # mamba state dim
    d_conv: int = 4              # mamba conv width
    expand: int = 2              # mamba inner expansion
    head_dim: int = 64           # rwkv6 head size
    chunk: int = 64              # rwkv6 chunked-scan chunk length


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"           # 'attn' | 'mamba' | 'rwkv6'
    mlp: str = "dense"           # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prologue: Tuple[LayerSpec, ...] = ()   # unscanned leading layers
    activation: str = "silu"     # silu | gelu | relu2 (squared ReLU)
    qkv_bias: bool = False
    qk_norm: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: int = 0      # 0 = full attention (train/prefill)
    decode_window: int = 8192    # sliding-window used for long_500k decode
    # KV-cache storage dtype for decode: '' = model dtype; 'int8' halves
    # cache HBM (per-(position, head) scales; §Perf iteration A1).
    kv_cache_dtype: str = ""
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # Multimodal frontend stubs (DESIGN.md §4).
    modality: str = "text"       # text | vlm | audio
    num_media_tokens: int = 0    # prepended patch/frame embeddings (vlm)
    num_codebooks: int = 1       # EnCodec codebooks (audio)

    tie_embeddings: bool = False
    # Shard the between-block residual activations (the scan-carry remat
    # residuals) over the 'model' axis: cuts per-device activation memory by
    # the model-axis size at the cost of a gather per block (§Perf).
    shard_residuals: bool = True
    source: str = ""             # citation for the config

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        total = len(self.prologue) + len(self.block_pattern) * self.num_blocks
        if total != self.num_layers:
            raise ValueError(
                f"{self.name}: prologue({len(self.prologue)}) + "
                f"pattern({len(self.block_pattern)}) x blocks({self.num_blocks}) "
                f"= {total} != num_layers({self.num_layers})"
            )

    @property
    def num_blocks(self) -> int:
        rem = self.num_layers - len(self.prologue)
        return rem // len(self.block_pattern)

    # ------------------------------------------------------ bookkeeping
    def param_count(self) -> int:
        """Total parameters N (analytic; used for MODEL_FLOPS = 6*N*D)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d * self.num_codebooks  # embeddings
        if not self.tie_embeddings:
            n += d * self.vocab_size * self.num_codebooks  # lm head(s)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                q_dim = m.nope_head_dim + m.rope_head_dim
                p = d * self.num_heads * q_dim                 # W_q
                p += d * (m.kv_lora_rank + m.rope_head_dim)    # W_dkv + W_kr
                p += m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                p += self.num_heads * m.v_head_dim * d         # W_o
                return p
            p = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            p += self.num_heads * hd * d
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        # Gated (SwiGLU-style) MLPs use 3 matrices; relu2/gelu FFNs use 2.
        mlp_mats = 3 if self.activation == "silu" else 2

        def dense_mlp() -> int:
            return mlp_mats * d * self.d_ff

        def moe_mlp() -> int:
            assert self.moe is not None
            e = self.moe
            per_expert = mlp_mats * d * e.d_ff
            n_experts = (e.num_shared + e.top_k) if active_only else (e.num_shared + e.num_experts)
            return n_experts * per_expert + d * e.num_experts  # + router

        def ssm_params() -> int:
            assert self.ssm is not None
            s = self.ssm
            if s.kind == "rwkv6":
                # r,k,v,g,o projections + decay/mix params (head_dim heads)
                return 5 * d * d + 2 * d * 64 + 6 * d
            d_in = s.expand * d
            p = d * 2 * d_in                  # in_proj (x and z)
            p += d_in * s.d_conv              # conv1d
            p += d_in * (s.d_state * 2 + 1)   # B, C, dt projections (fused)
            p += d_in * s.d_state             # A_log
            p += d_in                          # D
            p += d_in * d                      # out_proj
            return p

        specs = list(self.prologue) + list(self.block_pattern) * self.num_blocks
        for spec in specs:
            if spec.kind == "attn":
                n += attn_params()
            else:
                n += ssm_params()
            if spec.mlp == "dense":
                n += dense_mlp()
            elif spec.mlp == "moe":
                n += moe_mlp()
            n += 2 * d  # norms
        return n


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
