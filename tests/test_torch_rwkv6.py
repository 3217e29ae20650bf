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


# --------------------------------------------------------------------------
# Decays by the model's own law, and the CUDA kernels' order of arithmetic.


def _model_inputs(B, T, H, N, seed, clip_share):
    """r, k, v ~ N(0, 0.25) and u ~ N(0, 0.01) as ``_inputs``, but decays by
    the model's law (``models/ssm.py``) at its initial bias,
    w = exp(-exp(clip(-2 + 0.5 z, -8, 2))), with a share ``clip_share`` of
    them at the clip's extremes: half exp(-e^2) ~ 6.17e-4, half
    exp(-e^-8) ~ 0.99966."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3))
    logit = np.clip(-2.0 + 0.5 * rng.standard_normal((B, T, H, N)), -8.0, 2.0)
    z = rng.random((B, T, H, N))
    logit = np.where(z < clip_share / 2, 2.0, np.where(z < clip_share, -8.0, logit))
    w = np.exp(-np.exp(logit)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    return r, k, v, w, u


DECAY_LAWS = {"model": 0.0, "clip": 0.5}


@pytest.mark.parametrize("law", sorted(DECAY_LAWS))
def test_rwkv6_plain_matches_reference_under_model_decays(law):
    xs = _model_inputs(2, 96, 2, 32, seed=21, clip_share=DECAY_LAWS[law])
    assert xs[3].min() < 1e-3 if law == "clip" else xs[3].min() > 1e-3
    out, state = rwkv6_plain(*map(torch.from_numpy, xs))
    p_out, p_state = rwkv6_pallas(*map(jnp.asarray, xs), chunk=32, interpret=True)
    r_out, r_state = rwkv6_ref(*map(jnp.asarray, xs), chunk=32)
    _close(out, p_out, name="out vs pallas")
    _close(state, p_state, name="state vs pallas")
    _close(out, r_out, name="out vs ref")
    _close(state, r_state, name="state vs ref")


def _jax_grads(xs, cot_o, cot_s, with_state):
    def f(*args):
        out, final = rwkv6_ref(*args[:5], state=args[5] if with_state else None)
        return jnp.sum(out * cot_o) + jnp.sum(final * cot_s)

    return jax.grad(f, argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))


def _cotangents_and_state(B, T, H, N, seed, with_state):
    rng = np.random.default_rng(seed)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32) if with_state else None
    cot_o = rng.standard_normal((B, T, H, N)).astype(np.float32)
    cot_s = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return s0, cot_o, cot_s


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("law", sorted(DECAY_LAWS))
def test_rwkv6_plain_gradients_match_jax_grad_under_model_decays(law, with_state):
    B, T, H, N = 2, 24, 2, 8
    xs = list(_model_inputs(B, T, H, N, seed=13, clip_share=DECAY_LAWS[law]))
    s0, cot_o, cot_s = _cotangents_and_state(B, T, H, N, 14, with_state)
    if with_state:
        xs.append(s0)
    grads_j = _jax_grads(xs, cot_o, cot_s, with_state)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out, final = rwkv6_plain(*ts[:5], state=ts[5] if with_state else None)
    grads_t = torch.autograd.grad((out, final), ts, (torch.from_numpy(cot_o), torch.from_numpy(cot_s)))
    for name, g_t, g_j in zip(["r", "k", "v", "w", "u", "state"], grads_t, grads_j):
        _close(g_t, g_j, name=f"d{name}")


# A float32 emulation of csrc/rwkv6.cu, vectorised over (b, h): the same
# loops (tiles of the forward, the backward's units of forward passes and
# reverse walks over sub-chunks of KSUB steps from start states kept per
# chunk) and the same order of every sum.  Forward: a thread's 4 x 2 tile of
# the state, its sums over its 4 rows in order, then over row quads in order.
# Backward: a thread's 2 x 4 tile, its sums over its 4 columns or 2 rows in
# order, the butterfly over the N / 4 lanes of a row pair (highest lane bit
# first), the butterfly over a warp's row pairs (lowest bit first), then the
# warps in order.  Both: one warp's butterfly for the per-step dot products.
# What it cannot mirror is the kernels' fused multiply-adds, rounded once;
# here each rounds twice.
KSUB = 16


def _lane_tree(x):
    """Sum over the last axis (the N / 2 lanes of a quad) as the butterfly
    does: the two halves of the lane index's highest bit first."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _step_dot(a, b):
    """sum_x a[x] b[x] over the last axis as one warp takes it: lane l adds
    x = l, l + 32, ... in order, then a butterfly over the 32 lanes."""
    t = a * b
    N = t.shape[-1]
    lanes = torch.zeros(t.shape[:-1] + (32,), dtype=t.dtype)
    for x0 in range(0, N, 32):
        part = t[..., x0:x0 + 32]
        lanes[..., :part.shape[-1]] = lanes[..., :part.shape[-1]] + part
    return _lane_tree(lanes)


def _cols4(a, b):
    """sum_x a b over each thread's 4 columns of the last axis, in order:
    [..., N] -> [..., N / 4]."""
    t = a * b
    acc = t[..., 0::4]
    for x in range(1, 4):
        acc = acc + t[..., x::4]
    return acc


def _quads(x, N):
    """[B, H, N, ...] -> [B, H, N / 4, 4, ...]: rows by quad."""
    return x.reshape(x.shape[:2] + (N // 4, 4) + x.shape[3:])


def _update(S, k, v, w):
    """S_t = w_t S_{t-1} + k_t v_t, S [B, H, N, N], k, v, w [B, H, N]."""
    return w[..., :, None] * S + k[..., :, None] * v[..., None, :]


def _emulate_fwd(r, k, v, w, u, s0, chunk):
    """(out [B, T, H, N], final state, chunk-start states) in the forward
    kernel's order."""
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N)) if s0 is None else s0.clone()
    out, ckpt = torch.empty_like(r), []
    for t in range(T):
        rt, kt, vt, wt = (x[:, t] for x in (r, k, v, w))  # [B, H, N]
        if t % chunk == 0:
            ckpt.append(S.clone())
        rq, Sq = _quads(rt, N), _quads(S, N)  # [B, H, N/4, 4], [B, H, N/4, 4, N]
        part = torch.zeros((B, H, N // 4, N))
        for ri in range(4):
            part = part + rq[..., ri, None] * Sq[..., ri, :]
        acc = torch.zeros((B, H, N))
        for q in range(N // 4):
            acc = acc + part[:, :, q]
        out[:, t] = acc + vt * _step_dot(rt * u, kt)[..., None]
        S = _update(S, kt, vt, wt)
    return out, S, torch.stack(ckpt, dim=2)


def _units(T, chunk):
    """The backward's units, as rwkv6.cu's next_unit walks them:
    (chunk, sub-chunk, is a forward pass)."""
    for c in reversed(range(-(-T // chunk))):
        ns = -(-min(chunk, T - c * chunk) // KSUB)
        yield from ((c, s, True) for s in range(ns - 1))
        yield from ((c, s, False) for s in reversed(range(ns)))


def _emulate_bwd(r, k, v, w, u, dout, ckpt, ds_final, chunk):
    """(dr, dk, dv, dw, du [H, N], d start state) in the backward kernel's
    order, from the forward's chunk-start states."""
    B, T, H, N = r.shape
    G = torch.zeros((B, H, N, N)) if ds_final is None else ds_final.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_acc, du_err = torch.zeros((B, H, N)), torch.zeros((B, H, N))
    marks = {}
    for c, s, fwd in _units(T, chunk):
        ts = c * chunk + s * KSUB
        L = min(KSUB, min(chunk, T - c * chunk) - s * KSUB)
        if s == 0:
            marks[0] = ckpt[:, :, c]
        St = [marks[s]]
        for m in range(L if fwd else L - 1):
            t = ts + m
            St.append(_update(St[-1], k[:, t], v[:, t], w[:, t]))
        if fwd:
            marks[s + 1] = St[-1]
            continue
        for m in reversed(range(L)):
            t = ts + m
            rt, kt, vt, wt, ot = (x[:, t] for x in (r, k, v, w, dout))
            S = St[m]
            # A thread's sums over its columns 4c .. 4c + 3, then the pair's lanes.
            a = _lane_tree(_cols4(ot[..., None, :], S))
            b_ = _lane_tree(_cols4(G, vt[..., None, :]))
            c_ = _lane_tree(_cols4(G, S))
            # dv: a thread's 2 rows, its warp's row pairs, then the warps in order.
            part = G[..., 0::2, :] * kt[..., 0::2, None] + G[..., 1::2, :] * kt[..., 1::2, None]
            pairs = 128 // N  # row pairs in a warp
            part = part.reshape(B, H, N // 2 // pairs, pairs, N)
            while part.shape[-2] > 1:
                part = part[..., 0::2, :] + part[..., 1::2, :]
            acc = torch.zeros((B, H, N))
            for wq in range(part.shape[2]):
                acc = acc + part[:, :, wq, 0]
            dov, ruk = _step_dot(ot, vt)[..., None], _step_dot(rt * u, kt)[..., None]
            dv[:, t] = acc + ot * ruk
            dr[:, t] = a + u * kt * dov
            dk[:, t] = b_ + u * rt * dov
            dw[:, t] = c_
            term = rt * kt * dov - du_err
            nxt = du_acc + term
            du_err = (nxt - du_acc) - term
            du_acc = nxt
            G = wt[..., :, None] * G + rt[..., :, None] * ot[..., None, :]
    return dr, dk, dv, dw, du_acc.sum(dim=0), G


@pytest.mark.parametrize(
    "B,T,H,N,chunk,with_state",
    [
        (1, 1024, 1, 64, 64, True),   # the path's head size and chunk, T >= 1,024
        (2, 1030, 1, 64, 20, False),  # ragged T and sub-chunks of 16 and 4
        (2, 64, 2, 32, 16, True),     # quads of 16 lanes
        (2, 37, 2, 16, 5, False),     # quads of 8 lanes, chunks shorter than a sub-chunk
    ],
)
def test_rwkv6_kernel_order_emulation_matches_jax_grad(B, T, H, N, chunk, with_state):
    xs = list(_model_inputs(B, T, H, N, seed=T + N + chunk, clip_share=DECAY_LAWS["clip"]))
    s0, cot_o, cot_s = _cotangents_and_state(B, T, H, N, T + 1, with_state)
    r_out, r_state = rwkv6_ref(*map(jnp.asarray, xs), state=None if s0 is None else jnp.asarray(s0))
    ts = [torch.from_numpy(x) for x in xs]
    state = None if s0 is None else torch.from_numpy(s0)
    out, final, ckpt = _emulate_fwd(*ts, state, chunk)
    _close(out, r_out, name="out")
    _close(final, r_state, name="final state")
    got = _emulate_bwd(*ts, torch.from_numpy(cot_o), ckpt, torch.from_numpy(cot_s), chunk)
    want = _jax_grads(xs + ([s0] if with_state else []), cot_o, cot_s, with_state)
    names = ["r", "k", "v", "w", "u", "state"]
    for name, g_t, g_j in zip(names, got, want):
        _close(g_t, g_j, tol=1e-4, name=f"d{name}")


def test_rwkv6_emulated_walk_visits_every_step_once():
    """The backward's units cover every step of every chunk exactly once in
    reverse time, each sub-chunk's forward pass before its walk."""
    for T, chunk in [(1, 1), (7, 3), (64, 64), (100, 64), (1030, 20), (9, 8), (17, 9)]:
        walked, passed = [], set()
        for c, s, fwd in _units(T, chunk):
            ts = c * chunk + s * KSUB
            L = min(KSUB, min(chunk, T - c * chunk) - s * KSUB)
            assert L >= 1
            if fwd:
                passed.add((c, s))
            else:
                assert s == 0 or (c, s - 1) in passed
                walked.extend(reversed(range(ts, ts + L)))
        assert walked == list(reversed(range(T)))
