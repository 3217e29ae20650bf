"""Model assembly on tensors (PyTorch port of ``repro/models/transformer.py``):
embeddings -> prologue -> stacked blocks -> head, with the train/prefill
forward and the causal LM loss, prefill returning the KV cache, single-token
decode against a ring-buffer cache, and ``make_train_step``.

The parameter tree is the reference's: the repeated blocks are stacked along
a leading ``num_blocks`` axis (``params["blocks"]["0"]["attn"]["wq"]`` is
``[num_blocks, d, H * hd]``), and so are the block caches, so
``repro_torch.interop`` carries a JAX model's weights over in one round
trip.  Where the reference runs ``lax.scan`` over that axis, the port loops
over block ``i`` in Python; it does not rematerialise (the reference's
``remat``), so each layer's forward runs once per step.

Ported: text models with attention (``kind="attn"``) and RWKV-6
(``kind="rwkv6"``) layers and dense or MoE (``mlp="moe"``) MLPs.  Layer kind
``mamba``, the ``vlm``/``audio`` modalities, MLA and the int8 KV cache raise
``NotImplementedError``, and so do prefill and decode through an RWKV-6 or
MoE layer (the serving slice).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    _project_qkv,
    attention_apply,
    attention_decode,
    attention_init,
    init_attn_cache,
    mlp_apply,
    mlp_init,
    rms_norm,
    torch_dtype,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["Model", "make_train_step"]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.modality != "text":
        raise NotImplementedError(f"modality {cfg.modality!r} is not ported to repro_torch yet")
    for spec in tuple(cfg.prologue) + tuple(cfg.block_pattern):
        if spec.kind not in ("attn", "rwkv6"):
            raise NotImplementedError(f"layer kind {spec.kind!r} is not ported to repro_torch yet")
        if spec.mlp not in ("dense", "none", "moe"):
            raise NotImplementedError(f"mlp={spec.mlp!r} is not ported to repro_torch yet")


def _check_cacheable(cfg: ModelConfig) -> None:
    """Prefill and decode are ported for attention layers with dense MLPs."""
    for spec in tuple(cfg.prologue) + tuple(cfg.block_pattern):
        if spec.kind != "attn" or spec.mlp == "moe":
            raise NotImplementedError(
                f"prefill/decode through a {spec.kind!r} layer with mlp={spec.mlp!r} "
                "is not ported to repro_torch yet"
            )


def _block(tree: PyTree, i: int) -> PyTree:
    """Block ``i`` of a tree stacked along a leading ``num_blocks`` axis."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class Model:
    def __init__(self, cfg: ModelConfig):
        _check_ported(cfg)
        self.cfg = cfg
        self.pattern = cfg.block_pattern
        self.num_blocks = cfg.num_blocks

    # ------------------------------------------------------------------ init
    def _init_layer(self, generator: torch.Generator, spec: LayerSpec) -> PyTree:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        device = generator.device
        p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
        if spec.kind == "rwkv6":
            p["attn"] = ssm_mod.rwkv6_init(generator, cfg)
        else:
            p["attn"] = attention_init(generator, cfg)
        if spec.mlp != "none":
            p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
            if spec.mlp == "moe":
                p["mlp"] = moe_init(generator, cfg)
            else:
                p["mlp"] = mlp_init(generator, cfg, cfg.d_ff)
        return p

    def init_params(self, generator: torch.Generator) -> PyTree:
        """Random weights on the generator's device: N(0, 0.02) embeddings
        and head, scaled-normal projections, unit norms."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        device = generator.device
        scale = 0.02

        def normal(shape):
            return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)

        params: Dict[str, Any] = {
            "embed": normal((cfg.vocab_size, cfg.d_model)),
            "lm_head": normal((cfg.d_model, cfg.vocab_size)),
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
    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), params["embed"])

    def _head(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        return x @ params["lm_head"]

    # --------------------------------------------------------------- forward
    def _apply_layer(
        self, lp: PyTree, x: torch.Tensor, spec: LayerSpec, window: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        if spec.kind == "rwkv6":
            x = x + ssm_mod.rwkv6_apply(lp["attn"], h, cfg)
        else:
            x = x + attention_apply(lp["attn"], h, cfg, window=window)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if spec.mlp != "none":
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            if spec.mlp == "moe":
                h2, aux = moe_apply(lp["mlp"], h2, cfg)
            else:
                h2 = mlp_apply(lp["mlp"], h2, cfg)
            x = x + h2
        return x, aux

    def forward(
        self, params: PyTree, tokens: torch.Tensor, window: int = 0
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden [B, S, d], MoE aux loss, a float32 scalar)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, spec in enumerate(cfg.prologue):
            x, a = self._apply_layer(params[f"prologue_{i}"], x, spec, window)
            aux = aux + a
        for b in range(self.num_blocks):
            bp = _block(params["blocks"], b)
            for i, spec in enumerate(self.pattern):
                x, a = self._apply_layer(bp[str(i)], x, spec, window)
                aux = aux + a
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux

    # ------------------------------------------------------------------ loss
    def loss(
        self, params: PyTree, tokens: torch.Tensor, labels: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal LM loss: the mean next-token NLL over labels >= 0 (labels
        < 0 are masked) plus the MoE aux loss; returns (loss, {"nll", "aux"})."""
        x, aux = self.forward(params, tokens)
        logits = self._head(params, x).float()
        labels = labels.long()
        mask = (labels >= 0).float()
        safe = torch.clamp(labels, min=0)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss + aux, {"nll": loss, "aux": aux}

    # ------------------------------------------------------------- caching
    def init_cache(self, batch: int, window: int, device: Any = "cpu") -> PyTree:
        _check_cacheable(self.cfg)
        cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
        for i, spec in enumerate(self.cfg.prologue):
            cache[f"prologue_{i}"] = init_attn_cache(self.cfg, batch, window, device)
        cache["blocks"] = {
            str(i): tree_map(
                lambda leaf: leaf.expand((self.num_blocks,) + tuple(leaf.shape)).clone(),
                init_attn_cache(self.cfg, batch, window, device),
            )
            for i in range(len(self.pattern))
        }
        return cache

    def _decode_layer(
        self, lp: PyTree, x: torch.Tensor, spec: LayerSpec, lcache: PyTree, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, PyTree]:
        cfg = self.cfg
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        h, lcache = attention_decode(lp["attn"], h, lcache, pos, cfg)
        x = x + h
        if spec.mlp != "none":
            h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h2, cfg)
        return x, lcache

    def decode_step(
        self, params: PyTree, cache: PyTree, tokens: torch.Tensor, with_hidden: bool = False
    ):
        """One token for every sequence. tokens: [B, 1].

        ``cache["pos"]`` may be a scalar (all sequences at the same depth) or
        a [B] vector of per-lane positions (ragged co-batched decode).
        Returns (logits, new_cache), plus the final-norm hidden [B, 1, d]
        when ``with_hidden`` (for value heads riding the decode path).
        """
        cfg = self.cfg
        _check_cacheable(cfg)
        pos = cache["pos"]
        x = self._embed(params, tokens)
        new_cache: Dict[str, Any] = {"pos": pos + 1}
        for i, spec in enumerate(cfg.prologue):
            x, c = self._decode_layer(params[f"prologue_{i}"], x, spec, cache[f"prologue_{i}"], pos)
            new_cache[f"prologue_{i}"] = c
        per_block = []
        for b in range(self.num_blocks):
            bp, bc = _block(params["blocks"], b), _block(cache["blocks"], b)
            out = {}
            for i, spec in enumerate(self.pattern):
                x, out[str(i)] = self._decode_layer(bp[str(i)], x, spec, bc[str(i)], pos)
            per_block.append(out)
        new_cache["blocks"] = _stack(per_block)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._head(params, x)
        if with_hidden:
            return logits, new_cache, x
        return logits, new_cache

    # ------------------------------------------------------------- prefill
    def prefill(
        self, params: PyTree, tokens: torch.Tensor, window: int = 0, with_hidden: bool = False
    ):
        """Forward over a prompt, returning (last-token logits, filled cache).

        The cache window equals the prompt length (or ``window`` if set);
        attention caches are the (rope'd) K/V of the prompt, fitted into the
        ring buffer.  With ``with_hidden`` the full final-norm hidden
        [B, S, d] is appended to the return (callers with ragged prompts need
        logits at their own last position, not at S - 1).
        """
        cfg = self.cfg
        _check_cacheable(cfg)
        S = tokens.shape[1]
        W = window or S
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        cache: Dict[str, Any] = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device)}

        def layer_with_cache(lp, x, spec):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            c = _prefill_attn_cache(lp["attn"], h, cfg, W, positions)
            x = x + attention_apply(lp["attn"], h, cfg, window=window)
            if spec.mlp != "none":
                h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
                x = x + mlp_apply(lp["mlp"], h2, cfg)
            return x, c

        for i, spec in enumerate(cfg.prologue):
            x, cache[f"prologue_{i}"] = layer_with_cache(params[f"prologue_{i}"], x, spec)
        per_block = []
        for b in range(self.num_blocks):
            bp = _block(params["blocks"], b)
            cs = {}
            for i, spec in enumerate(self.pattern):
                x, cs[str(i)] = layer_with_cache(bp[str(i)], x, spec)
            per_block.append(cs)
        cache["blocks"] = _stack(per_block)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._head(params, x[:, -1:])
        if with_hidden:
            return logits, cache, x
        return logits, cache


# ----------------------------------------------------------- step builder
def make_train_step(model: Model, optimizer) -> Callable:
    """The learner's step: the loss, its gradient, and ``optimizer.apply_``,
    which updates the parameters and the optimizer's moments in place (see
    ``repro_torch.optim.optimizers``).  ``train_step(params, opt_state,
    batch)`` takes parameter leaves that require grad and a batch of
    ``tokens`` and ``labels`` tensors, and returns (params, the new state,
    {"loss", "nll", "aux"} as tensors); the returned params are the same
    tensors, updated."""

    def train_step(params: PyTree, opt_state: PyTree, batch: Dict[str, torch.Tensor]):
        loss, parts = model.loss(params, batch["tokens"], batch["labels"])
        leaves = tree_leaves(params)
        grads: List[Any] = list(torch.autograd.grad(loss, leaves))
        opt_state = optimizer.apply_(params, grads, opt_state)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------- prefill cache builders
def _prefill_attn_cache(
    ap: PyTree, h: torch.Tensor, cfg: ModelConfig, W: int, positions: torch.Tensor
) -> PyTree:
    _, k, v = _project_qkv(ap, h, cfg, positions)
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
