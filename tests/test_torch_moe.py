"""Parity of the port's MoE layer and grouped matmul with the JAX package on
the CPU.

The CUDA kernel (``csrc/moe_gmm.cu``) runs only on the GPU, where
``chip_smoke.py`` holds it against the plain version; here the plain
version (a loop over the groups) is held against the reference's Pallas
kernel in interpret mode and its oracle ``ref.moe_gmm_ref``, ``GmmMatmul``'s
gradients against the reference's custom VJP, and ``moe_apply`` (output, aux
loss, gradients) against the reference's at the reduced Phi-3.5-MoE
configuration in both dispatch modes, with carried weights.  Inputs are made
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
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import MOE_GMM_LAUNCHES, moe_gmm_cuda, moe_gmm_plain
from repro_torch.models import moe

TOL = 1e-5


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
