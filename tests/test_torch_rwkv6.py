"""Parity of the port's RWKV-6 recurrence with the JAX package on the CPU.

The CUDA kernels (``csrc/rwkv6.cu``, forward and backward) run only on the
GPU, where ``chip_smoke.py`` holds them against the plain version; here the
plain version (the step loop, differentiated by autograd) is held against
the reference's Pallas kernel in interpret mode, its oracle
``ref.rwkv6_ref`` and ``jax.grad`` of that oracle, and the port's
``rwkv6_apply`` against the reference's with carried weights, on inputs made
with numpy from a seed.  Tolerance 1e-5 (abs and rel), float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.ref import rwkv6_ref
from repro.kernels.rwkv6 import rwkv6_pallas
from repro.models import ssm as jax_ssm
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6 import (
    RWKV6_BWD_LAUNCHES,
    RWKV6_FWD_LAUNCHES,
    rwkv6_cuda,
    rwkv6_plain,
)
from repro_torch.models import ssm

TOL = 1e-5


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _inputs(B, T, H, N, seed):
    """r, k, v ~ N(0, 0.25), decays in (0.5, 1) as the reference's kernel
    test draws them, u ~ N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3))
    w = (0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.5).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("T,H,N,chunk", [(64, 2, 32, 16), (128, 4, 64, 64), (96, 1, 16, 32)])
def test_rwkv6_plain_matches_pallas_and_reference(T, H, N, chunk):
    xs = _inputs(2, T, H, N, seed=T + H + N)
    out, state = rwkv6_plain(*map(torch.from_numpy, xs))
    p_out, p_state = rwkv6_pallas(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    r_out, r_state = rwkv6_ref(*map(jnp.asarray, xs), chunk=chunk)
    _close(out, p_out, name="out vs pallas")
    _close(state, p_state, name="state vs pallas")
    _close(out, r_out, name="out vs ref")
    _close(state, r_state, name="state vs ref")


def test_rwkv6_plain_with_start_state_matches_reference():
    xs = _inputs(2, 40, 2, 16, seed=3)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 16, 16)).astype(np.float32)
    out, state = ops.rwkv6(*map(torch.from_numpy, xs), state=torch.from_numpy(s0))
    r_out, r_state = rwkv6_ref(*map(jnp.asarray, xs), state=jnp.asarray(s0))
    _close(out, r_out, name="out")
    _close(state, r_state, name="state")


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_plain_gradients_match_jax_grad_of_reference(with_state):
    B, T, H, N = 2, 24, 2, 8
    xs = list(_inputs(B, T, H, N, seed=11))
    rng = np.random.default_rng(12)
    if with_state:
        xs.append(rng.standard_normal((B, H, N, N)).astype(np.float32))
    cot_o = rng.standard_normal((B, T, H, N)).astype(np.float32)
    cot_s = rng.standard_normal((B, H, N, N)).astype(np.float32)

    def f(*args):
        state = args[5] if with_state else None
        out, final = rwkv6_ref(*args[:5], state=state)
        return jnp.sum(out * cot_o) + jnp.sum(final * cot_s)

    grads_j = jax.grad(f, argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out, final = rwkv6_plain(*ts[:5], state=ts[5] if with_state else None)
    grads_t = torch.autograd.grad((out, final), ts, (torch.from_numpy(cot_o), torch.from_numpy(cot_s)))
    for name, g_t, g_j in zip(["r", "k", "v", "w", "u", "state"], grads_t, grads_j):
        _close(g_t, g_j, name=f"d{name}")


def test_rwkv6_apply_matches_reference_with_carried_weights():
    cfg_j = dataclasses.replace(jax_reduced_config("rwkv6-7b"), dtype="float32")
    cfg_t = dataclasses.replace(reduced_config("rwkv6-7b"), dtype="float32")
    params_j = jax_ssm.rwkv6_init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    x = np.random.default_rng(5).standard_normal((2, 48, cfg_t.d_model)).astype(np.float32)
    want = jax_ssm.rwkv6_apply(params_j, jnp.asarray(x), cfg_j)
    got = ssm.rwkv6_apply(params_t, torch.from_numpy(x), cfg_t)
    _close(got, want)


def test_rwkv6_wrapper_refuses_cpu_tensors_and_ops_dispatch_by_device():
    xs = [torch.from_numpy(a) for a in _inputs(1, 8, 1, 16, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_cuda(*xs)
    counts = (RWKV6_FWD_LAUNCHES.value, RWKV6_BWD_LAUNCHES.value)
    ts = [x.clone().requires_grad_(True) for x in xs]
    out, state = ops.rwkv6(*ts)
    (out.sum() + state.sum()).backward()
    want_out, want_state = rwkv6_plain(*xs)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(state, want_state, rtol=0, atol=0)
    assert (RWKV6_FWD_LAUNCHES.value, RWKV6_BWD_LAUNCHES.value) == counts
