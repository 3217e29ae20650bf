"""Mixture-of-Experts layer on tensors (PyTorch port of
``repro/models/moe.py``): top-k routing with per-row sort-based dispatch
into a dense ``[B, E, C, d]`` buffer, per-row capacity (tokens over it are
dropped), the Switch load-balance aux loss, and shared experts.

As in the reference, ``dispatch="gather"`` (the default) builds the
dispatch and combine with row gathers whose backwards are gathers too
(``_PermuteRows``, ``_ReplicateRows``), and ``"scatter"`` with scatter-adds.
The expert products go through ``GmmMatmul``, whose forward is
``ops.moe_gmm`` (the grouped-matmul kernel on the card, the loop over groups
on the CPU) and whose backward computes the reference's two batched
products with ``ops.moe_gmm_dx`` and ``ops.moe_gmm_dw`` (the dX and dW
kernels on the card).
The reference sends an expert product to its kernel only where the TPU's
tiling gate (``_gmm_ok``) allows and to an einsum elsewhere; the CUDA
kernels take any group size, so the port sends every one.  As the
reference, ``GmmMatmul`` passes ``block_m`` = B*C, the rows of a group, when
that is at most 128 and 128 above: on the card that picks the small-group
kernel at a decode step's groups (2 rows at batch 2, capacity 1) and the
128-row-tile kernel at prefill and training groups
(``kernels/moe_gmm.py::gmm_route``).
The reference's sharding annotations are kept, call for call; under axis
rules the dispatch and combine run on each data shard's rows and the expert
products on each (batch, experts) shard (``shard_map``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard, shard_map
from repro_torch.kernels import ops
from repro_torch.models.layers import dense, dense_init, product, torch_dtype

PyTree = Any

__all__ = ["GmmMatmul", "moe_init", "moe_apply", "route"]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[b, i] = x[b, idx[b, i]]: x [B, N, d], idx [B, M] -> [B, M, d]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class _PermuteRows(torch.autograd.Function):
    """y[b,i] = x[b, idx[b,i]] * mask_fwd[b,i], idx a (masked) bijection;
    the backward is a gather by ``inv_idx`` (no scatter)."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx, mask_fwd, mask_bwd):
        ctx.save_for_backward(inv_idx, mask_fwd, mask_bwd)
        return _take_rows(x, idx) * mask_fwd[..., None].to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        inv_idx, mask_fwd, mask_bwd = ctx.saved_tensors
        dx = _take_rows(dy * mask_fwd[..., None].to(dy.dtype), inv_idx)
        return dx * mask_bwd[..., None].to(dy.dtype), None, None, None, None


class _ReplicateRows(torch.autograd.Function):
    """y[b,i] = x[b, st[b,i]], each source row appearing exactly k times;
    the backward sums the k cotangent copies through a gather."""

    @staticmethod
    def forward(ctx, x, st, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return _take_rows(x, st)

    @staticmethod
    def backward(ctx, dy):
        (inv,) = ctx.saved_tensors
        B, Sk, d = dy.shape
        picked = _take_rows(dy, inv)  # [B, S*k, d]
        return picked.reshape(B, Sk // ctx.k, ctx.k, d).sum(dim=2), None, None, None


class GmmMatmul(torch.autograd.Function):
    """[B, E, C, K] x [E, K, N] -> [B, E, C, N] through ``ops.moe_gmm``: the
    dispatch buffer transposed to [E, B*C, K] is a grouped-rows layout with
    E groups of B*C rows, passed with the reference's ``block_m``
    (``repro/models/moe.py:136``).  The backward computes the reference's
    two batched products (``repro/models/moe.py`` ``_gmm_matmul_bwd``) in
    that layout, through ``ops.moe_gmm_dx`` and ``ops.moe_gmm_dw``; it reads
    the grouped rows, so the forward saves them and not ``xe``."""

    @staticmethod
    def forward(ctx, xe, w):
        B, E, C, K = xe.shape
        xg = xe.transpose(0, 1).reshape(E * B * C, K)
        groups = torch.full((E,), B * C, dtype=torch.int32, device=xe.device)
        ctx.save_for_backward(xg, w, groups)
        ctx.dims = (B, E, C, xe.dtype)
        block_m = B * C if B * C <= 128 else 128
        out = ops.moe_gmm(xg, w, groups, block_m=block_m)
        return out.reshape(E, B, C, w.shape[-1]).transpose(0, 1).to(xe.dtype)

    @staticmethod
    def backward(ctx, dy):
        xg, w, groups = ctx.saved_tensors
        B, E, C, dtype = ctx.dims
        dyg = dy.transpose(0, 1).reshape(E * B * C, -1).contiguous()
        dxe = ops.moe_gmm_dx(dyg, w, groups).reshape(E, B, C, -1).transpose(0, 1)
        return dxe.to(dtype), ops.moe_gmm_dw(xg, dyg, groups).to(w.dtype)


def moe_init(generator: torch.Generator, cfg: ModelConfig) -> PyTree:
    assert cfg.moe is not None
    e = cfg.moe
    d = cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    device = generator.device

    def experts_mat(din: int, dout: int) -> torch.Tensor:
        w = torch.randn((e.num_experts, din, dout), generator=generator, device=device)
        return (w / math.sqrt(din)).to(dtype)

    p: Dict[str, Any] = {
        "router": dense_init(generator, d, e.num_experts, dtype),
        "up": experts_mat(d, e.d_ff),
        "down": experts_mat(e.d_ff, d),
    }
    gated = cfg.activation == "silu"
    if gated:
        p["gate"] = experts_mat(d, e.d_ff)
    if e.num_shared:
        shared_ff = e.d_ff * e.num_shared
        p["shared_up"] = dense_init(generator, d, shared_ff, dtype)
        p["shared_down"] = dense_init(generator, shared_ff, d, dtype)
        if gated:
            p["shared_gate"] = dense_init(generator, d, shared_ff, dtype)
    return p


def _activate(h: torch.Tensor, gate: Any, cfg: ModelConfig) -> torch.Tensor:
    """The FFN's nonlinearity; ``gate`` is a zero-argument callable giving
    the gate projection (computed only for the gated silu)."""
    if cfg.activation == "silu":
        return F.silu(gate()) * h
    if cfg.activation == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def _expert_mm(xe: torch.Tensor, w: torch.Tensor, w_axes: Tuple) -> torch.Tensor:
    """[B, E, C, K] x [E, K, N] through ``GmmMatmul``, on each rank's
    (batch, experts) shard where the rules split them: each rank multiplies
    its own experts' slots, as the reference's expert-parallel layout
    (``w_axes``, the weight's spec: its 'fsdp' dim on K or on N)."""
    return product(GmmMatmul.apply, xe, w, ("batch", "experts", None), w_axes)


def _expert_ffn(p: PyTree, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe: [B, E, C, d] -> [B, E, C, d] via the per-expert (gated) FFN."""
    h = shard(_expert_mm(xe, p["up"], _K_SPLIT), "batch", "experts", None, None)
    h = _activate(h, lambda: _expert_mm(xe, p["gate"], _K_SPLIT), cfg)
    return shard(_expert_mm(h, p["down"], _N_SPLIT), "batch", "experts", None, None)


# The expert weights' logical layouts (``distributed/specs.py``).
_K_SPLIT = ("experts", "fsdp", None)
_N_SPLIT = ("experts", None, "fsdp")


def route(params: PyTree, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities [B, S, E] and the top-k (weights, experts), each
    [B, S, k], largest first.  ``torch.topk`` does not promise
    ``lax.top_k``'s lower-index-first order among equal probabilities; the
    two agree wherever the top k are distinct."""
    logits = (x @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_p, top_e


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Route each row's tokens and fill its [E, C, d] dispatch buffer: (xe
    [B, E, C, d], probs [B, S, E], the top-k expert counts [B, S, E], and
    the tensors ``_combine`` reads, each [B, S * k]).  Everything is local
    to a row, so to a data shard."""
    e = cfg.moe
    B, S, d = x.shape
    k = e.top_k
    E = e.num_experts
    Sk = S * k
    device = x.device

    # ------------------------------------------------------------- routing
    probs, top_p, top_e = route({"router": router}, x, cfg)
    top_p = (top_p / torch.sum(top_p, dim=-1, keepdim=True)).to(x.dtype)
    hot = torch.sum(F.one_hot(top_e, E).float(), dim=2)  # [B, S, E]

    # --------------------------------------- per-row sort-based dispatch
    C = max(1, int(math.ceil(e.capacity_factor * S * k / E)))
    flat_e = top_e.reshape(B, Sk)
    flat_t = torch.arange(S, device=device)[:, None].expand(S, k).reshape(Sk)
    flat_w = top_p.reshape(B, Sk)

    # Every dispatch intermediate is batch-sharded, as the reference states.
    order = torch.argsort(flat_e, dim=-1, stable=True)  # [B, Sk], as jnp.argsort
    se = shard(torch.gather(flat_e, 1, order), "batch", None)
    st = shard(flat_t[order], "batch", None)  # token index per sorted slot
    sw = shard(torch.gather(flat_w, 1, order), "batch", None)
    counts = torch.sum(F.one_hot(se, E), dim=1)  # [B, E]
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(Sk, device=device)[None, :] - torch.gather(starts, 1, se)
    keep = pos < C
    slot = shard(se * C + torch.clamp(pos, max=C - 1), "batch", None)  # drops -> C-1

    if e.dispatch == "gather":
        # After the per-row sort, expert e's kept tokens sit at sorted
        # positions starts[e] .. starts[e]+C-1, so the dispatch buffer is a
        # gather, and so are the backwards.
        cpos = torch.arange(E * C, device=device) % C  # capacity slot
        eid = torch.arange(E * C, device=device) // C
        src_idx = starts[:, eid] + cpos[None, :]  # slot -> sorted idx
        slot_filled = cpos[None, :] < torch.clamp(counts[:, eid], 0, C)
        src_idx = torch.clamp(src_idx, max=Sk - 1)
        inv = torch.argsort(order, dim=-1)  # flat pos -> sorted idx

        gathered = shard(_ReplicateRows.apply(x, st, inv, k), "batch", None, None)  # [B, Sk, d]
        xe = _PermuteRows.apply(gathered, src_idx, slot, slot_filled, keep)
        # Slots -> token positions (backward: a gather by the slot's reader).
        tok_slot = torch.gather(slot, 1, inv)
        inv_p = torch.gather(order, 1, src_idx)  # slot -> flat pos
        tok_w = torch.gather(sw * keep.to(sw.dtype), 1, inv)
        return xe.reshape(B, E, C, d), probs, hot, (tok_slot, inv_p, slot_filled, tok_w)
    if e.dispatch == "scatter":
        gathered = _take_rows(x, st) * keep[..., None].to(x.dtype)  # dropped -> 0
        gathered = shard(gathered, "batch", None, None)
        xe = torch.zeros((B, E * C, d), dtype=x.dtype, device=device)
        xe = xe.scatter_add(1, slot[..., None].expand(-1, -1, d), gathered)
        xe = shard(xe, "batch", None, None)
        return xe.reshape(B, E, C, d), probs, hot, (slot, st, sw * keep.to(sw.dtype))
    raise ValueError(f"unknown MoE dispatch {e.dispatch!r}")


def _combine(ye: torch.Tensor, *index: torch.Tensor, cfg: ModelConfig, S: int) -> torch.Tensor:
    """The expert outputs ye [B, E * C, d] back at their tokens, weighted:
    [B, S, d], local to a row as ``_dispatch``."""
    e = cfg.moe
    B, _, d = ye.shape
    k = e.top_k
    if e.dispatch == "gather":
        tok_slot, inv_p, slot_filled, tok_w = index
        picked_raw = _PermuteRows.apply(ye, tok_slot, inv_p,
                                        torch.ones_like(tok_slot, dtype=torch.bool), slot_filled)
        picked = picked_raw * tok_w[..., None].to(ye.dtype)
        return shard(torch.sum(picked.reshape(B, S, k, d), dim=2), "batch", None, None)
    slot, st, w = index
    back = shard(_take_rows(ye, slot) * w[..., None].to(ye.dtype), "batch", None, None)
    out = torch.zeros((B, S, d), dtype=ye.dtype, device=ye.device)
    return shard(out.scatter_add(1, st[..., None].expand(-1, -1, d), back), "batch", None, None)


def moe_apply(
    params: PyTree, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], router aux loss scalar).

    Under sharding rules the dispatch and the combine run on each data
    shard's rows and the expert products on each (batch, experts) shard
    (``shard_map``): the layouts the reference's annotations give GSPMD,
    stated where DTensor would otherwise propagate its own through the
    sorts and gathers."""
    e = cfg.moe
    B, S, d = x.shape
    E = e.num_experts
    rows, row_idx = ("batch", None, None), ("batch", None)
    index_axes = (row_idx,) * (4 if e.dispatch == "gather" else 3)
    xe, probs, hot, index = shard_map(
        lambda x, router: _dispatch(x, router, cfg), (rows, (None, None)),
        (("batch", None, None, None), rows, rows) + index_axes, x, params["router"])

    # Load-balance auxiliary loss (Switch-style).
    density = torch.mean(hot, dim=(0, 1))
    aux = e.router_aux_coef * E * torch.mean(density * torch.mean(probs, dim=(0, 1)))

    xe = shard(xe, "batch", "experts", None, None)  # the expert-parallel all-to-all
    ye = shard(_expert_ffn(params, xe, cfg).reshape(B, -1, d), "batch", None, None)
    out = shard_map(lambda ye, *index: _combine(ye, *index, cfg=cfg, S=S),
                    (rows,) + index_axes, rows, ye, *index)

    # ------------------------------------------------------ shared experts
    if e.num_shared:
        h = shard(dense(x, params["shared_up"], "shared_up"), "batch", None, "d_ff")
        h = _activate(h, lambda: dense(x, params["shared_gate"], "shared_gate"), cfg)
        out = out + dense(h, params["shared_down"], "shared_down")

    return out, aux
