"""bfloat16, the dtype every model configuration defaults to, on the CPU.

* ``interop`` carries the reference's bf16 parameter trees both ways, bit
  for bit (numpy has no bfloat16 of its own: the JAX leaves are
  ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take).
* The plain versions of the four bf16 kernels (flash forward, decode
  attention, the grouped matmul's two routes) take bf16 inputs, compute in
  float32 and round their output once; each is held against the reference's
  Pallas kernel in interpret mode at the reference's own bf16 tolerances
  (``tests/test_kernels.py``): 2e-2 for attention, 5e-2 for the grouped
  matmul.
* The reduced DeepSeek-V2-Lite, Jamba (its Mamba + dense, attention + MoE
  window) and Nemotron-4 run a prefill and 4 decode steps at bf16 from the
  reference's bf16 weights, in both packages: the port's logits within
  5e-2 x max |logits| of the reference's, and each package's bf16 logits
  against a float32 run of the same weights widened, the port's error at
  most 2 x the reference's plus 2^-8 x max |logits|.

MoE routing is a top-k over router probabilities computed from bf16 hidden
states, so a near tie can fall either way between two runs whose roundings
differ (port and reference, bf16 and float32), and the token then takes
other experts; its logits, and those of the row's later positions, which
read its keys and values, then measure that choice and not the arithmetic.
So the routing is held apart: the port's own expert choices must equal the
reference's but at near ties in the reference's probabilities (every first
disagreement), and the logits are compared on runs that all take the
reference's bf16 choices (recorded by the port's ``moe.route`` and, for the
reference, its ``lax.top_k`` through ordered callbacks), each with its own
probabilities at those experts.  Inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from jax.experimental import io_callback

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro.models import Model as JaxModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.models import Model, moe
from repro_torch.tree import tree_leaves

BF16 = ml_dtypes.bfloat16
ATTENTION_TOL = 2e-2  # tests/test_kernels.py's bf16 tolerance for both attention kernels
GMM_TOL = 5e-2  # and for the grouped matmul
MODEL_TOL = 5e-2  # port vs reference logits, x max |logits|
NEAR_TIE = 0.1  # a routing flip's two probabilities within this share of the larger


def _bf16(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32).astype(BF16)


def _close(got: torch.Tensor, want, tol: float, name: str) -> None:
    assert got.dtype == torch.bfloat16, f"{name}: the plain version returned {got.dtype}"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


# ------------------------------------------------------------------ interop
def test_interop_carries_the_references_bf16_tree_bitwise():
    cfg = jax_reduced_config("deepseek-v2-lite-16b")
    assert cfg.dtype == "bfloat16"
    params = jax.tree_util.tree_map(np.asarray, JaxModel(cfg).init_params(jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(a.dtype == BF16 for a in leaves) > 10
    tree = params_from_numpy(params)
    wide = jax.tree_util.tree_leaves(params_to_numpy(tree))
    for a, t, w in zip(leaves, tree_leaves(tree), wide, strict=True):
        if a.dtype == BF16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
            assert w.dtype == np.float32 and np.array_equal(w, a.astype(np.float32))
            assert np.array_equal(w.astype(BF16).view(np.uint16), a.view(np.uint16))
        else:
            assert t.dtype == torch.from_numpy(a).dtype and w.dtype == a.dtype
            assert np.array_equal(w, a)


def test_interop_bf16_leaves_do_not_alias_the_callers_arrays():
    a = np.arange(6, dtype=np.float32).astype(BF16)
    t = params_from_numpy(a)
    a[0] = 5
    assert float(t[0]) == 0.0


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("S,H,KV,D,causal,window", [
    pytest.param(128, 4, 4, 64, True, 0, id="causal-D64"),
    pytest.param(256, 4, 2, 64, True, 64, id="window-gqa-D64"),
    pytest.param(128, 8, 1, 128, True, 0, id="gqa-D128"),
    pytest.param(128, 4, 2, 128, False, 0, id="full-gqa-D128"),
])
def test_flash_plain_bf16_matches_pallas(S, H, KV, D, causal, window):
    rng = np.random.default_rng(S + H + D + window)
    q, k, v = _bf16(rng, 2, S, H, D), _bf16(rng, 2, S, KV, D), _bf16(rng, 2, S, KV, D)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  window=window, block_q=64, block_k=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    qkv = params_from_numpy([q, k, v])
    _close(flash_attention_plain(*qkv, causal=causal, window=window), want, ATTENTION_TOL, "flash")
    _close(ops.flash_attention(*qkv, causal=causal, window=window), want, ATTENTION_TOL,
           "ops.flash_attention")


@pytest.mark.parametrize("W,H,KV,D,mask", [
    pytest.param(256, 8, 2, 64, "shared", id="shared-gqa-D64"),
    pytest.param(512, 4, 4, 128, "rows", id="per-row-D128"),
    pytest.param(128, 8, 8, 64, "rows", id="per-row-D64"),
])
def test_decode_plain_bf16_matches_pallas(W, H, KV, D, mask):
    rng = np.random.default_rng(W + H + D)
    B = 3
    q, kc, vc = _bf16(rng, B, 1, H, D), _bf16(rng, B, W, KV, D), _bf16(rng, B, W, KV, D)
    if mask == "shared":
        valid = np.arange(W) < (W * 3) // 4
    else:
        valid = np.arange(W)[None] < rng.integers(1, W + 1, (B, 1))
        valid[1] = False  # an empty cache: zeros in both
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(valid), block_w=64, interpret=True)
    args = params_from_numpy([q, kc, vc, valid])
    got = decode_attention_plain(*args)
    _close(got, want, ATTENTION_TOL, "decode")
    if mask == "rows":
        assert bool((got[1] == 0).all())
    _close(ops.decode_attention(*args), want, ATTENTION_TOL, "ops.decode_attention")


@pytest.mark.parametrize("sizes,D,F,block_m", [
    pytest.param([128, 0, 256, 128], 64, 128, 128, id="tiles-ragged-empty"),
    pytest.param([16, 0, 32, 16, 48], 64, 128, 16, id="block16-ragged-empty"),
    pytest.param([2, 0, 4, 2, 2, 6], 32, 256, 2, id="block2-ragged-empty"),
])
def test_gmm_plain_bf16_matches_pallas(sizes, D, F, block_m):
    rng = np.random.default_rng(sum(sizes) + D + F)
    x = _bf16(rng, sum(sizes), D)
    w = (rng.standard_normal((len(sizes), D, F)) / np.sqrt(D)).astype(np.float32).astype(BF16)
    gs = np.array(sizes, np.int32)
    want = moe_gmm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), block_m=block_m,
                          block_n=64, interpret=True)
    args = params_from_numpy([x, w, gs])
    _close(moe_gmm_plain(*args), want, GMM_TOL, "moe_gmm")
    _close(ops.moe_gmm(*args, block_m=block_m), want, GMM_TOL, "ops.moe_gmm")


def test_plain_versions_round_once_from_float32():
    """Each plain version at bf16 is its float32 computation on the widened
    inputs, rounded once: bitwise."""
    rng = np.random.default_rng(3)
    q, k, v = (params_from_numpy(_bf16(rng, 2, 64, 4, 64)) for _ in range(3))
    assert torch.equal(flash_attention_plain(q, k, v),
                       flash_attention_plain(q.float(), k.float(), v.float()).to(torch.bfloat16))
    valid = torch.arange(64) < 40
    qd = q[:, :1]
    assert torch.equal(
        decode_attention_plain(qd, k, v, valid),
        decode_attention_plain(qd.float(), k.float(), v.float(), valid).to(torch.bfloat16))
    x, w = params_from_numpy(_bf16(rng, 12, 32)), params_from_numpy(_bf16(rng, 3, 32, 16))
    gs = torch.tensor([4, 0, 8])
    assert torch.equal(moe_gmm_plain(x, w, gs),
                       moe_gmm_plain(x.float(), w.float(), gs).to(torch.bfloat16))


# ------------------------------------------------------------------- models
# name -> (architecture, layer window of its block or None)
MODELS = {
    "deepseek": ("deepseek-v2-lite-16b", None),  # MLA, MoE with a shared expert
    "jamba": ("jamba-v0.1-52b", (2, 4)),  # (Mamba, dense), (attention, MoE)
    "nemotron": ("nemotron-4-15b", None),  # GQA, squared ReLU
}
B, S, T = 2, 12, 4  # prompt S, then T decode steps


def _cfg(module, arch: str, window, dtype: str):
    cfg = dataclasses.replace(module(arch), dtype=dtype)
    if window is not None:
        cfg = dataclasses.replace(cfg, block_pattern=get_config(arch).block_pattern[slice(*window)])
    if cfg.moe is not None:  # as the reference's decode test: nothing dropped
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _run_reference(model, params, tokens, monkeypatch, forced=None):
    """Logits [B, 1 + T, V] (the prefill's last, then each step's) as
    float32, and every routing decision (probabilities, experts) in order;
    with ``forced``, each top-k takes the experts of that list instead."""
    routes = []
    top_k = jax.lax.top_k
    pending = iter(forced or [])

    def record(probs, experts):
        routes.append((np.asarray(probs, np.float32), np.asarray(experts)))

    def recorded_top_k(probs, k):
        if forced is None:
            values, experts = top_k(probs, k)
        else:
            experts = io_callback(lambda _: next(pending)[1].astype(np.int32),
                                  jax.ShapeDtypeStruct(probs.shape[:-1] + (k,), jnp.int32), probs,
                                  ordered=True)
            values = jnp.take_along_axis(probs, experts, axis=-1)
        jax.debug.callback(record, probs, experts, ordered=True)
        return values, experts

    monkeypatch.setattr(jax.lax, "top_k", recorded_top_k)
    logits, cache = model.prefill(params, jnp.asarray(tokens[:, :S]), window=S + T)
    out = [np.asarray(logits, np.float32)[:, 0]]
    for i in range(S, S + T):
        logits, cache = model.decode_step(params, cache, jnp.asarray(tokens[:, i:i + 1]))
        out.append(np.asarray(logits, np.float32)[:, 0])
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return np.stack(out, axis=1), routes


def _run_port(model, params, tokens, monkeypatch, forced=None):
    """``_run_reference`` for the port, and its final cache."""
    routes = []
    route = moe.route
    pending = iter(forced or [])

    def recorded_route(p, x, cfg):
        probs, top_p, top_e = route(p, x, cfg)
        if forced is not None:
            top_e = torch.from_numpy(np.array(next(pending)[1])).long()
            top_p = torch.gather(probs, -1, top_e)
        routes.append((probs.float().numpy(), top_e.numpy()))
        return probs, top_p, top_e

    monkeypatch.setattr(moe, "route", recorded_route)
    with torch.no_grad():
        logits, cache = model.prefill(params, torch.from_numpy(tokens[:, :S]), window=S + T)
        out = [logits.float().numpy()[:, 0]]
        for i in range(S, S + T):
            logits, cache = model.decode_step(params, cache, torch.from_numpy(tokens[:, i:i + 1]))
            out.append(logits.float().numpy()[:, 0])
    monkeypatch.setattr(moe, "route", route)
    return np.stack(out, axis=1), routes, cache


def _flips(ref: list, other: list, name: str) -> tuple:
    """The routing decisions of ``other`` that differ from ``ref``'s and
    follow from no earlier difference in their row (a difference at
    position p reaches the row's later positions through their keys and
    values), each required to be a near tie in the reference's
    probabilities; and the [B, 1 + T] logits no difference reaches.  A
    run's calls come in order: each MoE layer's over the prompt's S
    positions, then each step's layers."""
    assert len(other) == len(ref), f"{name}: {len(other)} routing calls vs {len(ref)}"
    layers = sum(1 for _, experts in ref if experts.shape[1] == S)
    earliest = np.full(B, S + T)  # the first position a difference reaches, per row
    flips = []
    for call, ((probs, experts), (_, experts_o)) in enumerate(zip(ref, other)):
        pos0 = 0 if call < layers else S + (call - layers) // layers
        differ = (np.sort(experts, -1) != np.sort(experts_o, -1)).any(-1)  # [B, positions]
        for b, s in zip(*np.nonzero(differ)):
            p = pos0 + int(s)
            if p < earliest[b]:
                ranked = np.sort(probs[b, s])[::-1]
                k = experts.shape[-1]
                flips.append((int(b), p, float(ranked[k - 1]), float(ranked[k])))
                assert ranked[k - 1] - ranked[k] <= NEAR_TIE * ranked[k - 1], (
                    f"{name}: the port routes row {b} position {p} to other experts than the "
                    f"reference where its top-{k} margin is no near tie: {ranked.tolist()}")
                earliest[b] = p
    logit_pos = np.array([S - 1] + [S + i for i in range(T)])  # the position of each column
    return flips, logit_pos[None, :] < earliest[:, None]


@pytest.mark.parametrize("name", list(MODELS))
def test_model_bf16_prefill_and_decode_match_reference(name, monkeypatch):
    arch, window = MODELS[name]
    model_j = JaxModel(_cfg(jax_reduced_config, arch, window, "bfloat16"))
    model_t = Model(_cfg(reduced_config, arch, window, "bfloat16"))
    params = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(1)))
    assert np.dtype(BF16) in {a.dtype for a in jax.tree_util.tree_leaves(params)}
    tokens = np.random.default_rng(len(name)).integers(0, model_t.cfg.vocab_size,
                                                       (B, S + T)).astype(np.int32)
    p_t = params_from_numpy(params)
    ref, routes = _run_reference(model_j, params, tokens, monkeypatch)
    free, free_routes, cache = _run_port(model_t, p_t, tokens, monkeypatch)
    flips, unreached = _flips(routes, free_routes, name)
    for leaf in tree_leaves(cache["blocks"]):  # caches in the model's dtype, states float32
        assert leaf.dtype in (torch.bfloat16, torch.float32), leaf.dtype
    # Every other run takes the reference's bf16 expert choices; the float32
    # runs have the same weights, widened (exactly).
    got, _, _ = _run_port(model_t, p_t, tokens, monkeypatch, forced=routes)
    assert np.array_equal(got[unreached], free[unreached]), f"{name}: forcing moved the logits"
    wide = jax.tree_util.tree_map(lambda a: a.astype(np.float32) if a.dtype == BF16 else a, params)
    ref32, _ = _run_reference(JaxModel(_cfg(jax_reduced_config, arch, window, "float32")), wide,
                              tokens, monkeypatch, forced=routes)
    got32, _, _ = _run_port(Model(_cfg(reduced_config, arch, window, "float32")),
                            params_from_numpy(wide), tokens, monkeypatch, forced=routes)
    assert all(np.isfinite(x).all() for x in (ref, got, ref32, got32))

    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    err_port = float(np.abs(got - got32).max())
    err_ref = float(np.abs(ref - ref32).max())
    limit = 2 * err_ref + 2.0 ** -8 * scale
    msg = (f"{name}: port vs reference {err:.4e} (limit {MODEL_TOL * scale:.4e}); bf16 vs float32: "
           f"port {err_port:.4e}, reference {err_ref:.4e} (the port's limit {limit:.4e}); max "
           f"|logits| {scale:.4e}; the port's own routing flipped at near ties {flips}")
    assert err <= MODEL_TOL * scale, msg
    assert err_port <= limit, msg
