"""Model assembly on tensors (PyTorch port of ``repro/models/transformer.py``):
embeddings -> prologue -> stacked blocks -> head, with the train/prefill
forward and the causal LM loss, prefill returning the cache of every layer
(attention K/V, in int8 or as MLA's latent, and the RWKV-6 and Mamba
states), single-token decode against it, text, VLM (media embeddings
prepended) and audio (summed codebook embeddings, a head per codebook)
inputs, and the step builders ``make_train_step``, ``make_prefill_step`` and
``make_decode_step``.

The parameter tree is the reference's: the repeated blocks are stacked along
a leading ``num_blocks`` axis (``params["blocks"]["0"]["attn"]["wq"]`` is
``[num_blocks, d, H * hd]``), and so are the block caches, so
``repro_torch.interop`` carries a JAX model's weights over in one round
trip.  Where the reference runs ``lax.scan`` over that axis, the port loops
over block ``i`` in Python; it does not rematerialise the layers (the
reference's ``remat``), so each layer's forward runs once per step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import axis_index, get_axis_rules, shard, shard_map
from repro_torch.kernels import ops as kops
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    _project_qkv,
    _quantize_kv,
    attention_apply,
    attention_decode,
    attention_init,
    dense,
    init_attn_cache,
    mlp_apply,
    mlp_init,
    rms_norm,
    rope,
    torch_dtype,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["Model", "make_train_step", "make_prefill_step", "make_decode_step"]


def _block(tree: PyTree, i: int) -> PyTree:
    """Block ``i`` of a tree stacked along a leading ``num_blocks`` axis."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pattern = cfg.block_pattern
        self.num_blocks = cfg.num_blocks

    # ------------------------------------------------------------------ init
    def _init_layer(self, generator: torch.Generator, spec: LayerSpec) -> PyTree:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        device = generator.device
        p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
        if spec.kind == "attn":
            p["attn"] = attention_init(generator, cfg)
        elif spec.kind == "rwkv6":
            p["attn"] = ssm_mod.rwkv6_init(generator, cfg)
        elif spec.kind == "mamba":
            p["attn"] = ssm_mod.mamba_init(generator, cfg)
        else:
            raise ValueError(spec.kind)
        if spec.mlp != "none":
            p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
            if spec.mlp == "moe":
                p["mlp"] = moe_init(generator, cfg)
            else:
                p["mlp"] = mlp_init(generator, cfg, cfg.d_ff)
        return p

    def init_params(self, generator: torch.Generator) -> PyTree:
        """Random weights on the generator's device: N(0, 0.02) embeddings
        and head (one table and one head slice per codebook for audio),
        scaled-normal projections, unit norms."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        device = generator.device
        scale = 0.02

        def normal(shape):
            return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)

        if cfg.modality == "audio":
            K, V = cfg.num_codebooks, cfg.vocab_size
            embed, head = normal((K, V, cfg.d_model)), normal((cfg.d_model, K * V))
        else:
            embed = normal((cfg.vocab_size, cfg.d_model))
            head = normal((cfg.d_model, cfg.vocab_size))
        params: Dict[str, Any] = {
            "embed": embed,
            "lm_head": head,
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }
        for i, spec in enumerate(cfg.prologue):
            params[f"prologue_{i}"] = self._init_layer(generator, spec)
        blocks = [
            {str(i): self._init_layer(generator, s) for i, s in enumerate(self.pattern)}
            for _ in range(self.num_blocks)
        ]
        params["blocks"] = _stack(blocks)
        return params

    # ------------------------------------------------------------ embedding
    def _embed(
        self, params: PyTree, tokens: torch.Tensor, media_emb: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        cfg = self.cfg
        tokens = tokens.long()
        if cfg.modality == "audio":
            # tokens [B, S, K] -> the sum of the per-codebook embeddings.
            x = _lookup(params["embed"][0], tokens[..., 0])
            for k in range(1, cfg.num_codebooks):
                x = x + _lookup(params["embed"][k], tokens[..., k])
        else:
            x = _lookup(params["embed"], tokens)
        if cfg.modality == "vlm" and media_emb is not None:
            x = torch.cat([media_emb.to(x.dtype), x], dim=1)
        return shard(x, "batch", None, None)

    def _head(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """Logits [..., V], or [..., K, V] for audio (one slice a codebook)."""
        cfg = self.cfg
        logits = dense(x, params["lm_head"], "lm_head")
        if cfg.modality == "audio":
            # Split the codebooks out of a whole (unsharded) vocab dim: a
            # vocab shard need not fall on a codebook's bounds.
            logits = shard(logits, "batch", None, None)
            logits = logits.reshape(tuple(x.shape[:-1]) + (cfg.num_codebooks, cfg.vocab_size))
            # Whole here too, so the gradient is gathered over the vocab
            # before the reshape back (a vocab shard of [K, V] is no shard
            # of K * V that DTensor can gather).
            logits = shard(logits, *(("batch",) + (None,) * (logits.dim() - 1)))
            return shard(logits, "batch", None, None, "vocab")
        return shard(logits, "batch", None, "vocab")

    # --------------------------------------------------------------- forward
    def _mlp(self, lp: PyTree, x: torch.Tensor, spec: LayerSpec) -> Tuple[torch.Tensor, Any]:
        """The residual MLP half of a layer: (x, MoE aux loss or None)."""
        cfg = self.cfg
        if spec.mlp == "none":
            return x, None
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if spec.mlp == "moe":
            h2, aux = moe_apply(lp["mlp"], h2, cfg)
            return x + h2, aux
        return x + mlp_apply(lp["mlp"], h2, cfg), None

    def _apply_layer(
        self, lp: PyTree, x: torch.Tensor, spec: LayerSpec, window: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if spec.kind == "attn":
            h = attention_apply(lp["attn"], h, cfg, window=window)
        elif spec.kind == "rwkv6":
            h = ssm_mod.rwkv6_apply(lp["attn"], h, cfg)
        else:
            h = ssm_mod.mamba_apply(lp["attn"], h, cfg)
        x, aux = self._mlp(lp, x + h, spec)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def _layers(self, params: PyTree):
        """(layer params, spec, cache key, block) for every layer in order:
        the prologue's, then each block's pattern (block None for the
        prologue)."""
        for i, spec in enumerate(self.cfg.prologue):
            yield params[f"prologue_{i}"], spec, f"prologue_{i}", None
        for b in range(self.num_blocks):
            bp = _block(params["blocks"], b)
            for i, spec in enumerate(self.pattern):
                yield bp[str(i)], spec, str(i), b

    def forward(
        self,
        params: PyTree,
        tokens: torch.Tensor,
        media_emb: Optional[torch.Tensor] = None,
        window: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden [B, S, d], MoE aux loss, a float32 scalar); for
        VLM, S counts the prepended media positions."""
        x = self._embed(params, tokens, media_emb)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, spec, _, _ in self._layers(params):
            x, a = self._apply_layer(lp, x, spec, window)
            aux = aux + a
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x, aux

    # ------------------------------------------------------------------ loss
    def loss(
        self,
        params: PyTree,
        tokens: torch.Tensor,
        labels: torch.Tensor,
        media_emb: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal LM loss: the mean next-token NLL over labels >= 0 (labels
        < 0 are masked; media positions carry no labels) plus the MoE aux
        loss; returns (loss, {"nll", "aux"})."""
        cfg = self.cfg
        x, aux = self.forward(params, tokens, media_emb)
        if cfg.modality == "vlm" and media_emb is not None:
            x = x[:, media_emb.shape[1]:]
        logits = self._head(params, x).float()
        labels = labels.long()
        mask = (labels >= 0).float()
        safe = torch.clamp(labels, min=0)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss + aux, {"nll": loss, "aux": aux}

    # ------------------------------------------------------------- caching
    def _init_layer_cache(self, spec: LayerSpec, batch: int, window: int, device: Any) -> PyTree:
        if spec.kind == "attn":
            return init_attn_cache(self.cfg, batch, window, device)
        if spec.kind == "rwkv6":
            return ssm_mod.init_rwkv6_state(self.cfg, batch, device)
        return ssm_mod.init_mamba_state(self.cfg, batch, device)

    def init_cache(self, batch: int, window: int, device: Any = "cpu") -> PyTree:
        cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
        for i, spec in enumerate(self.cfg.prologue):
            cache[f"prologue_{i}"] = self._init_layer_cache(spec, batch, window, device)
        cache["blocks"] = {
            str(i): tree_map(
                lambda leaf: leaf.expand((self.num_blocks,) + tuple(leaf.shape)).clone(),
                self._init_layer_cache(spec, batch, window, device),
            )
            for i, spec in enumerate(self.pattern)
        }
        return cache

    def _decode_layer(
        self, lp: PyTree, x: torch.Tensor, spec: LayerSpec, lcache: PyTree, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, PyTree]:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if spec.kind == "attn":
            h, lcache = attention_decode(lp["attn"], h, lcache, pos, cfg)
        elif spec.kind == "rwkv6":
            h, lcache = ssm_mod.rwkv6_decode(lp["attn"], h, lcache, cfg)
        else:
            h, lcache = ssm_mod.mamba_decode(lp["attn"], h, lcache, cfg)
        x, _ = self._mlp(lp, x + h, spec)
        return x, lcache

    def decode_step(
        self, params: PyTree, cache: PyTree, tokens: torch.Tensor, with_hidden: bool = False
    ):
        """One token for every sequence. tokens: [B, 1] (audio [B, 1, K]).

        ``cache["pos"]`` may be a scalar (all sequences at the same depth) or
        a [B] vector of per-lane positions (ragged co-batched decode).
        Returns (logits, new_cache), plus the final-norm hidden [B, 1, d]
        when ``with_hidden`` (for value heads riding the decode path).
        """
        pos = cache["pos"]
        x = self._embed(params, tokens)
        new_cache: Dict[str, Any] = {"pos": pos + 1}
        per_block: List[Dict[str, Any]] = [{} for _ in range(self.num_blocks)]
        for lp, spec, key, b in self._layers(params):
            lcache = cache[key] if b is None else _block(cache["blocks"][key], b)
            x, c = self._decode_layer(lp, x, spec, lcache, pos)
            if b is None:
                new_cache[key] = c
            else:
                per_block[b][key] = c
        new_cache["blocks"] = _stack(per_block)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = self._head(params, x)
        if with_hidden:
            return logits, new_cache, x
        return logits, new_cache

    # ------------------------------------------------------------- prefill
    def prefill(
        self,
        params: PyTree,
        tokens: torch.Tensor,
        media_emb: Optional[torch.Tensor] = None,
        window: int = 0,
        with_hidden: bool = False,
    ):
        """Forward over a prompt, returning (last-token logits, filled cache).

        The cache window equals the prompt length, media positions included
        (or ``window`` if set); attention caches are the (rope'd) K/V of the
        prompt fitted into the ring buffer (int8 codes and scales, or MLA's
        latent), recurrent layers' caches their state after the prompt.
        With ``with_hidden`` the full final-norm hidden [B, S, d] is
        appended to the return (callers with ragged prompts need logits at
        their own last position, not at S - 1).
        """
        cfg = self.cfg
        S = tokens.shape[1]
        if cfg.modality == "vlm" and media_emb is not None:
            S = S + media_emb.shape[1]
        W = window or S
        x = self._embed(params, tokens, media_emb)
        positions = torch.arange(S, device=x.device)
        cache: Dict[str, Any] = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
        per_block: List[Dict[str, Any]] = [{} for _ in range(self.num_blocks)]
        for lp, spec, key, b in self._layers(params):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if spec.kind == "attn":
                c = _prefill_attn_cache(lp["attn"], h, cfg, W, positions)
                h = attention_apply(lp["attn"], h, cfg, window=window)
            elif spec.kind == "rwkv6":
                h, c = _prefill_rwkv6(lp["attn"], h, cfg)
            else:
                h, c = _prefill_mamba(lp["attn"], h, cfg)
            x, _ = self._mlp(lp, x + h, spec)
            if b is None:
                cache[key] = c
            else:
                per_block[b][key] = c
        cache["blocks"] = _stack(per_block)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._head(params, x[:, -1:])
        if with_hidden:
            return logits, cache, x
        return logits, cache


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  Under sharding rules whose mesh splits
    the table's vocab dim, each rank looks its tokens up in its own slice of
    the vocab (zeros for a token outside it) and the result is a partial sum
    over the vocab's mesh axes, reduced by the caller's ``shard``: DTensor
    has a rule for that lookup's backward, where the plain vocab-sharded
    ``F.embedding`` hands one partial layout to another it cannot convert."""
    rules = get_axis_rules()
    spec = None
    if rules is not None and rules.mesh is not None:
        spec = rules.resolve(["vocab", None], shape=table.shape)[0]
    if spec is None or not hasattr(table, "placements"):
        return F.embedding(tokens, table)
    index, size = axis_index(rules.mesh, spec)
    rows = table.shape[0] // size
    lo = index * rows  # this rank's slice of the vocab

    def local(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        hit = (tokens >= lo) & (tokens < lo + rows)
        x = F.embedding(torch.where(hit, tokens - lo, torch.zeros_like(tokens)), table)
        return x * hit[..., None].to(x.dtype)

    batch = ("batch",) + (None,) * (tokens.dim() - 1)
    return shard_map(local, (batch, ("vocab", None)), batch + (None,), tokens, table,
                     partial=(spec,) if isinstance(spec, str) else spec)


# ----------------------------------------------------------- step builders
def make_train_step(model: Model, optimizer) -> Callable:
    """The learner's step: the loss, its gradient, and ``optimizer.apply_``,
    which updates the parameters and the optimizer's moments in place (see
    ``repro_torch.optim.optimizers``).  ``train_step(params, opt_state,
    batch)`` takes parameter leaves that require grad and a batch of
    ``tokens`` and ``labels`` tensors (and ``media_emb`` for VLM), and
    returns (params, the new state, {"loss", "nll", "aux"} as tensors); the
    returned params are the same tensors, updated."""

    def train_step(params: PyTree, opt_state: PyTree, batch: Dict[str, torch.Tensor]):
        loss, parts = model.loss(
            params, batch["tokens"], batch["labels"], media_emb=batch.get("media_emb")
        )
        leaves = tree_leaves(params)
        grads: List[Any] = list(torch.autograd.grad(loss, leaves))
        opt_state = optimizer.apply_(params, grads, opt_state)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, window: int = 0) -> Callable:
    """``prefill_step(params, batch)`` -> (last-token logits, cache) over
    ``batch["tokens"]`` (and ``batch["media_emb"]`` for VLM), on the device
    of the caller's tensors."""

    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, batch["tokens"], media_emb=batch.get("media_emb"),
                             window=window)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(params, cache, batch)`` -> (logits, new cache) for one
    token a sequence, ``batch["tokens"]`` [B, 1] (audio [B, 1, K])."""

    def decode_step(params: PyTree, cache: PyTree, batch: Dict[str, torch.Tensor]):
        return model.decode_step(params, cache, batch["tokens"])

    return decode_step


# ------------------------------------------------- prefill cache builders
def _prefill_attn_cache(
    ap: PyTree, h: torch.Tensor, cfg: ModelConfig, W: int, positions: torch.Tensor
) -> PyTree:
    if cfg.mla is not None:
        m = cfg.mla
        ckv = dense(h, ap["w_dkv"], "w_dkv")
        c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
        k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
        return {"c": _fit_window(c, W), "k_rope": _fit_window(k_rope, W)}
    _, k, v = _project_qkv(ap, h, cfg, positions)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(_fit_window(k, W))
        vq, vs = _quantize_kv(_fit_window(v, W))
        return {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs}
    return {"k": _fit_window(k, W), "v": _fit_window(v, W)}


def _fit_window(x: torch.Tensor, W: int) -> torch.Tensor:
    """Fit a [B, S, ...] sequence into a [B, W, ...] ring buffer (keep the last W)."""
    S = x.shape[1]
    if S == W:
        return x
    if S > W:
        # Last W entries, rotated so ring slot (pos % W) lines up.
        tail = x[:, S - W:]
        return torch.roll(tail, shifts=(S - W) % W, dims=1)
    pad = torch.zeros((x.shape[0], W - S) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _prefill_rwkv6(ap: PyTree, h: torch.Tensor, cfg: ModelConfig):
    """RWKV-6 over the prompt through ``ops.rwkv6``, which also returns the
    final WKV state: (out, {"wkv", "x_prev"})."""
    B, T, d = h.shape
    x_prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = ssm_mod._rwkv6_streams(ap, h, x_prev, cfg)
    out, state = kops.rwkv6(r, k, v, w, ap["bonus_u"].float(), chunk=cfg.ssm.chunk)
    out = rms_norm(out.reshape(B, T, d), ap["ln_out"], cfg.norm_eps) * g
    # The sequence path's layout (``rwkv6_apply``): the product reduced here.
    return shard(dense(out, ap["wo"], "wo"), "batch", None, None), {"wkv": state, "x_prev": h[:, -1]}


def _prefill_mamba(ap: PyTree, h: torch.Tensor, cfg: ModelConfig):
    """Mamba over the prompt: (out, {"h": the scan's final state, "conv":
    the last d_conv - 1 pre-conv inputs})."""
    s = cfg.ssm
    B, T, d = h.shape
    d_in = s.expand * d
    xz = dense(h, ap["in_proj"], "in_proj")
    xc, z = xz[..., :d_in], xz[..., d_in:]
    xc = shard(xc, "batch", None, "d_ff")
    xc_act = F.silu(ssm_mod._causal_conv(xc, ap["conv_w"], ap["conv_b"]))
    h0 = torch.zeros((B, d_in, s.d_state), dtype=torch.float32, device=h.device)
    y, hN = ssm_mod._mamba_scan(ap, xc_act, h0, s)
    out = shard(dense(y * F.silu(z), ap["out_proj"], "out_proj"), "batch", None, None)  # as ``mamba_apply``
    return out, {"h": hN, "conv": xc[:, T - (s.d_conv - 1):]}
