"""Parity of the port's MoE layer and grouped matmul with the JAX package on
the CPU.

The CUDA kernels (``csrc/moe_gmm.cu``: the forward, dX and dW) run only on
the GPU, where ``chip_smoke.py`` holds them against their plain versions;
here the plain versions (loops over the groups) are held against the
reference's Pallas kernel in interpret mode, its oracle ``ref.moe_gmm_ref``
and the oracle's VJP, ``GmmMatmul``'s gradients against the reference's
custom VJP, and ``moe_apply`` (output, aux loss, gradients) against the
reference's at the reduced Phi-3.5-MoE configuration in both dispatch modes,
with carried weights.  The kernels' 3xTF32 arithmetic is emulated on the
CPU at the path's contraction lengths.  Inputs are made
with numpy from a seed; random float32 router inputs give no ties in the
top-k, which the tests check, since ``torch.topk`` and ``lax.top_k`` may
order equal probabilities differently.  Tolerance 1e-5 (abs and rel) in
float32; 5e-2 in bfloat16, as the reference's kernel test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro.kernels.ref import moe_gmm_ref
from repro.models import moe as jax_moe
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build, moe_gmm_variants, ops
from repro_torch.kernels.moe_gmm import (
    MOE_GMM_DW_LAUNCHES,
    MOE_GMM_DX_LAUNCHES,
    MOE_GMM_LAUNCHES,
    ROW_TILE,
    _offsets,
    moe_gmm_cuda,
    moe_gmm_dw_cuda,
    moe_gmm_dw_plain,
    moe_gmm_dx_cuda,
    moe_gmm_dx_plain,
    moe_gmm_plain,
)
from repro_torch.models import moe
from test_torch_attention import _mm_1xtf32, _mm_3xtf32, _tf32, _tf32_toward_zero

TOL = 1e-5
GMM_TOL = 1e-4  # chip_smoke.py's tolerance for the grouped-matmul kernels


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=name
    )


@pytest.mark.parametrize("sizes,D,F", [([64, 128, 64], 32, 64), ([128, 0, 128, 64], 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_pallas_and_reference(sizes, D, F, dtype):
    rng = np.random.default_rng(sum(sizes) + D)
    x = rng.standard_normal((sum(sizes), D)).astype(np.float32)
    w = rng.standard_normal((len(sizes), D, F)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, wj, gs = jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.array(sizes)
    tdt = getattr(torch, dtype)
    got = moe_gmm_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.tensor(sizes))
    tol = 5e-2 if dtype == "bfloat16" else TOL
    pallas = moe_gmm_pallas(xj, wj, gs, block_m=64, block_n=64, interpret=True)
    _close(got.float(), pallas.astype(jnp.float32), tol, name="vs pallas")
    _close(got.float(), moe_gmm_ref(xj, wj, gs).astype(jnp.float32), tol, name="vs ref")


def test_gmm_matmul_gradients_match_reference_custom_vjp():
    B, E, C, K, N = 2, 3, 5, 8, 12
    rng = np.random.default_rng(7)
    xe = rng.standard_normal((B, E, C, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    cot = rng.standard_normal((B, E, C, N)).astype(np.float32)
    out_j, vjp = jax.vjp(jax_moe._gmm_matmul, jnp.asarray(xe), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (xe, w))
    out_t = moe.GmmMatmul.apply(xt, wt)
    dx_t, dw_t = torch.autograd.grad(out_t, (xt, wt), torch.from_numpy(cot))
    _close(out_t.detach(), out_j, name="out")
    _close(dx_t, dx_j, name="dxe")
    _close(dw_t, dw_j, name="dw")


def _phi_configs(dispatch):
    cfg_j = jax_reduced_config("phi3.5-moe-42b-a6.6b")
    cfg_j = dataclasses.replace(cfg_j, dtype="float32", moe=dataclasses.replace(cfg_j.moe, dispatch=dispatch))
    cfg_t = reduced_config("phi3.5-moe-42b-a6.6b")
    cfg_t = dataclasses.replace(cfg_t, dtype="float32", moe=dataclasses.replace(cfg_t.moe, dispatch=dispatch))
    return cfg_j, cfg_t


@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
def test_moe_apply_matches_reference(dispatch):
    cfg_j, cfg_t = _phi_configs(dispatch)
    params_j = jax_moe.moe_init(jax.random.PRNGKey(1), cfg_j)
    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg_t.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    # Routing first: the same experts on both sides, with no ties.
    probs_t, _, top_e_t = moe.route(params_from_numpy(params_np), torch.from_numpy(x), cfg_t)
    probs_j = jax.nn.softmax((jnp.asarray(x) @ params_j["router"]).astype(jnp.float32), axis=-1)
    _, top_e_j = jax.lax.top_k(probs_j, cfg_j.moe.top_k)
    np.testing.assert_array_equal(top_e_t.numpy(), np.asarray(top_e_j))
    p_sorted = np.sort(probs_t.numpy(), axis=-1)
    assert (np.diff(p_sorted, axis=-1) > 0).all()

    def f(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, cfg_j)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out_j, aux_j)), (gp_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params_j, jnp.asarray(x)
    )
    params_t = params_from_numpy(params_np)
    leaves = sorted(params_t)
    for name in leaves:
        params_t[name].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t, aux_t = moe.moe_apply(params_t, xt, cfg_t)
    loss = torch.sum(out_t * torch.from_numpy(cot)) + aux_t
    grads = torch.autograd.grad(loss, [params_t[n] for n in leaves] + [xt])
    _close(out_t.detach(), out_j, name="out")
    _close(aux_t.detach(), aux_j, name="aux")
    _close(grads[-1], gx_j, name="dx")
    for name, g in zip(leaves, grads):
        _close(g, gp_j[name], name=f"d{name}")


def test_moe_gmm_wrapper_refuses_cpu_tensors_and_ops_dispatch_by_device():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32))
    sizes = torch.tensor([7, 3])
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_cuda(x, w, sizes)
    count = MOE_GMM_LAUNCHES.value
    torch.testing.assert_close(ops.moe_gmm(x, w, sizes), moe_gmm_plain(x, w, sizes), rtol=0, atol=0)
    assert MOE_GMM_LAUNCHES.value == count


# Ragged groups with empty ones, summing to T (the reference's oracle gives
# rows past the groups the last expert's weights, not zeros).
RAGGED = [[5, 0, 7, 3], [0, 9, 0, 2, 4], [6, 6, 6]]


@pytest.mark.parametrize("sizes", RAGGED)
def test_moe_gmm_backward_plain_matches_reference_vjp(sizes):
    D, F = 8, 12
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    x = rng.standard_normal((sum(sizes), D)).astype(np.float32)
    w = rng.standard_normal((len(sizes), D, F)).astype(np.float32)
    cot = rng.standard_normal((sum(sizes), F)).astype(np.float32)
    gs = jnp.array(sizes)
    _, vjp = jax.vjp(lambda a, b: moe_gmm_ref(a, b, gs), jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    t = torch.tensor(sizes)
    _close(moe_gmm_dx_plain(torch.from_numpy(cot), torch.from_numpy(w), t), dx_j, name="dx")
    dw = moe_gmm_dw_plain(torch.from_numpy(x), torch.from_numpy(cot), t)
    _close(dw, dw_j, name="dw")
    for e, size in enumerate(sizes):
        if not size:
            assert not dw[e].any(), f"dw of empty group {e} is not zero"


def test_moe_gmm_backward_plain_matches_gmm_matmul_custom_vjp_in_grouped_layout():
    """The grouped rows of the [B, E, C, K] buffer, as ``GmmMatmul`` hands
    them to the dX and dW products, against the reference's custom VJP."""
    B, E, C, K, N = 2, 3, 5, 8, 12
    rng = np.random.default_rng(11)
    xe = rng.standard_normal((B, E, C, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    cot = rng.standard_normal((B, E, C, N)).astype(np.float32)
    _, vjp = jax.vjp(jax_moe._gmm_matmul, jnp.asarray(xe), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))

    def grouped(a):
        return torch.from_numpy(a).transpose(0, 1).reshape(E * B * C, a.shape[-1])

    groups = torch.full((E,), B * C)
    dx = moe_gmm_dx_plain(grouped(cot), torch.from_numpy(w), groups)
    _close(dx.reshape(E, B, C, K).transpose(0, 1), dx_j, name="dxe")
    _close(moe_gmm_dw_plain(grouped(xe), grouped(cot), groups), dw_j, name="dw")


@pytest.mark.parametrize("overrun", [0, 1, 200])
def test_moe_gmm_offsets_cut_groups_at_T_and_the_grid_covers_the_tail(overrun):
    """``_offsets`` (row ends cut at T, running 128-row tile counts) and the
    kernels' grid of ceil(T / 128) + E row tiles: the tiles past the last
    group's are enough to write the zeros of the rows past it."""
    rng = np.random.default_rng(overrun)
    for _ in range(200):
        sizes = rng.integers(0, 400, size=int(rng.integers(1, 9))).tolist()
        T = max(0, sum(sizes) - overrun) if overrun else sum(sizes) + int(rng.integers(0, 500))
        ends, tile_ends = _offsets(torch.tensor(sizes), T)
        want_ends = np.minimum(np.cumsum(sizes), T)
        np.testing.assert_array_equal(ends.numpy(), want_ends)
        cut = np.diff(want_ends, prepend=0)
        np.testing.assert_array_equal(tile_ends.numpy(), np.cumsum(-(-cut // ROW_TILE)))
        assert ends.dtype == tile_ends.dtype == torch.int32
        spare = -(-T // ROW_TILE) + len(sizes) - int(tile_ends[-1])
        assert spare >= -(-(T - int(ends[-1])) // ROW_TILE), (sizes, T)


@pytest.mark.parametrize("small", ["nearest", "toward_zero"])
@pytest.mark.parametrize("K", [4096, 6400])
def test_3xtf32_grouped_product_keeps_gmm_tol_and_one_tf32_pass_does_not(K, small):
    """The kernels' 3xTF32 arithmetic (``test_torch_attention``'s emulation)
    over the Phi-3.5-MoE path's contractions of 4,096 and 6,400, in ragged
    groups of a few rows, inputs N(0, 1) and weights N(0, 1/K) as the
    experts': within GMM_TOL of float64, where one TF32 pass is not."""
    sizes, N = [3, 0, 5], 16
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.standard_normal((sum(sizes), K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(np.float32))

    def grouped(mm):
        out, start = torch.zeros((sum(sizes), N), dtype=torch.float64), 0
        for e, size in enumerate(sizes):
            out[start:start + size] = mm(x[start:start + size], w[e]).double()
            start += size
        return out

    oracle = grouped(lambda a, b: a.double() @ b.double())
    round_small = _tf32 if small == "nearest" else _tf32_toward_zero
    three = grouped(lambda a, b: _mm_3xtf32(a, b, round_small))
    one = grouped(_mm_1xtf32)
    _close(three, oracle, tol=GMM_TOL, name=f"3xTF32, small rounded {small}")
    assert not torch.allclose(one, oracle, atol=GMM_TOL, rtol=GMM_TOL), (
        f"one TF32 pass came within GMM_TOL: {(one - oracle).abs().max().item():.2e}")


def test_moe_gmm_backward_wrappers_refuse_cpu_tensors_and_ops_dispatch_by_device():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    sizes = torch.tensor([7, 3])
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_dx_cuda(dy, w, sizes)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_dw_cuda(x, dy, sizes)
    counts = [c.value for c in (MOE_GMM_DX_LAUNCHES, MOE_GMM_DW_LAUNCHES)]
    torch.testing.assert_close(ops.moe_gmm_dx(dy, w, sizes), moe_gmm_dx_plain(dy, w, sizes),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.moe_gmm_dw(x, dy, sizes), moe_gmm_dw_plain(x, dy, sizes),
                               rtol=0, atol=0)
    assert [c.value for c in (MOE_GMM_DX_LAUNCHES, MOE_GMM_DW_LAUNCHES)] == counts


@pytest.mark.parametrize("name", sorted(moe_gmm_variants.VARIANTS))
def test_moe_gmm_variants_edit_the_shipped_source(name):
    """``python -m repro_torch.kernels.moe_gmm_variants`` builds each variant
    by replacing text of ``csrc/moe_gmm.cu``: each text must be there once,
    or the variant would not be the one its name says."""
    text = (build.CSRC_DIR / "moe_gmm.cu").read_text()
    for old, new in moe_gmm_variants.VARIANTS[name]:
        assert text.count(old) == 1, old
        assert new != old


# ------------------------------- tests/test_moe_layer.py, on the port
# The reference's five MoE invariants, each also held to the reference's
# moe_apply on the same weights and inputs (1e-4, float32).
def _layer_configs(E=4, k=2, cf=8.0, d=64, dff=128, num_shared=0):
    from repro.configs.base import LayerSpec as JaxLayerSpec
    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.configs.base import MoEConfig as JaxMoEConfig
    from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

    def make(model_cls, spec_cls, moe_cls):
        return model_cls(
            name="t", arch_type="moe", num_layers=1, d_model=d, num_heads=2, num_kv_heads=2,
            d_ff=dff, vocab_size=64, block_pattern=(spec_cls(kind="attn", mlp="moe"),),
            moe=moe_cls(num_experts=E, top_k=k, d_ff=dff, capacity_factor=cf, num_shared=num_shared),
            dtype="float32",
        )

    return make(JaxModelConfig, JaxLayerSpec, JaxMoEConfig), make(ModelConfig, LayerSpec, MoEConfig)


def _layer_pair(seed, S, B=1, **kw):
    """(cfg_j, cfg_t, reference params, port params, x as numpy) with
    reference weights carried over."""
    cfg_j, cfg_t = _layer_configs(**kw)
    params_j = jax_moe.moe_init(jax.random.PRNGKey(seed), cfg_j)
    x = np.random.default_rng(seed).standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    return cfg_j, cfg_t, params_j, params_t, x


def _layer_apply(cfg_j, cfg_t, params_j, params_t, x):
    out_j, aux_j = jax_moe.moe_apply(params_j, jnp.asarray(x), cfg_j)
    with torch.no_grad():
        out_t, aux_t = moe.moe_apply(params_t, torch.from_numpy(x), cfg_t)
    _close(out_t, out_j, 1e-4, name="out vs reference")
    _close(aux_t, aux_j, 1e-4, name="aux vs reference")
    return out_t.numpy(), float(aux_t)


def test_moe_output_shape_and_finite():
    out, aux = _layer_apply(*_layer_pair(0, 16, B=2))
    assert out.shape == (2, 16, 64)
    assert np.isfinite(out).all()
    assert aux >= 0.0


def test_moe_matches_dense_expert_computation():
    """With capacity ample and k = E (all experts selected), the MoE output
    equals the explicitly computed weighted sum of every expert's FFN."""
    E = 2
    cfg_j, cfg_t, params_j, params_t, x = _layer_pair(0, 8, E=E, k=E, cf=float(E) * 2)
    out, _ = _layer_apply(cfg_j, cfg_t, params_j, params_t, x)
    xt = torch.from_numpy(x)
    w = torch.softmax(xt @ params_t["router"], dim=-1)  # renormalized top-E == softmax
    expected = torch.zeros_like(xt)
    for e in range(E):
        h = torch.nn.functional.silu(xt @ params_t["gate"][e]) * (xt @ params_t["up"][e])
        expected = expected + w[..., e : e + 1] * (h @ params_t["down"][e])
    np.testing.assert_allclose(out, expected.numpy(), atol=1e-4, rtol=1e-3)


def test_moe_capacity_drops_tokens():
    """With capacity 1 and many tokens per row, most contributions drop: the
    output stays finite and at most E * C = 2 tokens have one."""
    out, _ = _layer_apply(*_layer_pair(0, 32, E=2, k=1, cf=0.01))
    assert np.isfinite(out).all()
    assert (np.abs(out[0]).sum(-1) > 1e-6).sum() <= 2


def test_moe_shared_experts_always_active():
    """The shared expert gives every token an output despite the drops."""
    out, _ = _layer_apply(*_layer_pair(0, 16, E=4, k=1, cf=0.01, num_shared=1))
    assert (np.abs(out[0]).sum(-1) > 1e-6).all()


hypothesis = pytest.importorskip("hypothesis", reason="property-based tests need hypothesis")


@hypothesis.given(hypothesis.strategies.integers(min_value=1, max_value=4),
                  hypothesis.strategies.integers(min_value=4, max_value=24))
@hypothesis.settings(max_examples=10, deadline=None)
def test_moe_gradients_finite(k, S):
    """Finite gradients for any k and S, equal to the reference's."""
    cfg_j, cfg_t, params_j, params_t, x = _layer_pair(0, S, E=4, k=k, cf=4.0)

    def loss_j(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, cfg_j)
        return jnp.sum(out**2) + aux

    grads_j = jax.jit(jax.grad(loss_j))(params_j, jnp.asarray(x))
    names = sorted(params_t)
    for name in names:
        params_t[name].requires_grad_(True)
    out, aux = moe.moe_apply(params_t, torch.from_numpy(x), cfg_t)
    grads = torch.autograd.grad(torch.sum(out**2) + aux, [params_t[n] for n in names])
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all(), name
        _close(g, grads_j[name], 1e-4, name=f"d{name}")
