"""Parity of the PyTorch port's kernel modules with the JAX package on the CPU.

Each case makes its inputs with numpy from a seed and feeds the same arrays
to the JAX function (the Pallas kernel in interpret mode and the jnp oracle)
and to the port's counterpart, which on CPU tensors runs the kernel's plain
PyTorch version.  Tolerance: 1e-5 absolute and relative, the reference's own
kernel-vs-oracle gate, in float32.  The CUDA kernels themselves run only on
a GPU: ``chip_smoke.py`` holds them against these plain versions there.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.advantages import gae_pallas, vtrace_pallas
from repro.kernels.ref import ppo_surrogate_ref
from repro.kernels.surrogate import ppo_surrogate_pallas
from repro.rl.advantages import gae as jax_gae
from repro.rl.advantages import vtrace as jax_vtrace
from repro_torch.kernels import build, gae_variants, ops, vtrace_variants
from repro_torch.kernels.advantages import gae_cuda, vtrace_cuda
from repro_torch.kernels.surrogate import ppo_surrogate_cuda, ppo_surrogate_plain

TOL = 1e-5


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)


# ------------------------------------------------------------------- GAE
def _gae_data(T, B, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((T, B)).astype(np.float32)
    v = rng.standard_normal((T, B)).astype(np.float32)
    d = (rng.random((T, B)) < 0.15).astype(np.float32)
    last = rng.standard_normal((B,)).astype(np.float32)
    return r, v, d, last


# T=1 (bootstrap only), B off the 128-lane panel (130, 257), the PPO path's
# [64, 8] rollout, and a 1-column rollout.
@pytest.mark.parametrize("T,B", [(1, 5), (64, 8), (33, 130), (7, 257), (40, 1)])
def test_gae_matches_pallas_and_scan(T, B):
    r, v, d, last = _gae_data(T, B, seed=T * 1000 + B)
    adv_k, ret_k = gae_pallas(*map(jnp.asarray, (r, v, d, last)), gamma=0.97, lam=0.9,
                              interpret=True)
    adv_s, ret_s = jax_gae(*map(jnp.asarray, (r, v, d, last)), gamma=0.97, lam=0.9)
    adv_t, ret_t = ops.fused_gae(*map(torch.from_numpy, (r, v, d, last)), gamma=0.97, lam=0.9)
    for name, want in (("pallas", (adv_k, ret_k)), ("scan", (adv_s, ret_s))):
        _close(adv_t, want[0], f"adv vs {name}")
        _close(ret_t, want[1], f"ret vs {name}")


def test_gae_trailing_dims_flatten_like_reference():
    r, v, d, last = _gae_data(6, 12, seed=3)
    shaped = [x.reshape((6, 3, 4)) for x in (r, v, d)] + [last.reshape(3, 4)]
    adv_j, _ = jax_gae(*map(jnp.asarray, shaped))
    adv_t, _ = ops.fused_gae(*map(torch.from_numpy, shaped))
    assert tuple(adv_t.shape) == (6, 3, 4)
    _close(adv_t, adv_j)


# The CUDA kernels (csrc/gae.cu, csrc/vtrace.cu) stage a panel of columns in
# shared memory, kTileT rows at a time from the end, and scan each column
# with a warp whose lanes compose contiguous pieces of rows into affine
# maps, scan the maps across the warp and walk their pieces again
# (csrc/reverse_scan.cuh); their variants (variants/gae_serial_scan.cu,
# variants/vtrace_serial_scan.cu) have one thread walk the rows in the
# reference's order.  Both orders, emulated in float32, must match the
# Pallas kernels and the JAX scans.
TILE_T = 128  # kTileT


def _tiles(T):
    """The kernels' tiles of rows, from the end."""
    return [slice(t0, min(T, t0 + TILE_T)) for t0 in range((T - 1) // TILE_T * TILE_T, -1, -TILE_T)]


def _scan_tile_emulated(x, a, carry, warp):
    """acc_t = x_t + a_t * acc_{t+1} over one tile's rows, acc_rows = carry,
    in the warp's order or the serial one."""
    rows = x.shape[0]
    acc = np.empty_like(x)
    if not warp:
        for row in reversed(range(rows)):
            carry = x[row] + a[row] * carry
            acc[row] = carry
        return acc
    n = -(-rows // 32)
    pieces = [(min(rows, lane * n), min(rows, lane * n + n)) for lane in range(32)]
    mul, add = np.ones((32,) + carry.shape, np.float32), np.zeros((32,) + carry.shape, np.float32)
    for lane, (lo, hi) in enumerate(pieces):
        for row in reversed(range(lo, hi)):
            add[lane] = x[row] + a[row] * add[lane]
            mul[lane] = a[row] * mul[lane]
    o = 1
    while o < 32:  # lane L takes lane L + o's map (Hillis-Steele, suffix)
        add[: 32 - o], mul[: 32 - o] = (add[: 32 - o] + mul[: 32 - o] * add[o:],
                                        mul[: 32 - o] * mul[o:])
        o *= 2
    acc_in = np.concatenate([add[1:] + mul[1:] * carry, carry[None]])
    for lane, (lo, hi) in enumerate(pieces):
        c = acc_in[lane]
        for row in reversed(range(lo, hi)):
            c = x[row] + a[row] * c
            acc[row] = c
    return acc


def _gae_emulated(r, v, d, last, gamma, lam, warp):
    f32 = np.float32
    nd = f32(1) - d
    x = r + f32(gamma) * nd * np.concatenate([v[1:], last[None]]) - v
    a = f32(gamma * lam) * nd
    adv = np.empty_like(r)
    carry = np.zeros_like(last)
    for tile in _tiles(r.shape[0]):
        adv[tile] = _scan_tile_emulated(x[tile], a[tile], carry, warp)
        carry = adv[tile][0]
    return adv, adv + v


# The existing cases, and T = 100 and 1,000 (eight tiles, the last ragged)
# with dones.
@pytest.mark.parametrize("warp", [False, True], ids=["serial", "warp"])
@pytest.mark.parametrize("T,B", [(1, 5), (64, 8), (33, 130), (7, 257), (40, 1), (100, 4),
                                 (1000, 3)])
def test_gae_scan_orders_match_pallas_and_scan(T, B, warp):
    r, v, d, last = _gae_data(T, B, seed=T * 1000 + B + 1)
    assert d.any()
    adv_e, ret_e = _gae_emulated(r, v, d, last, 0.97, 0.9, warp)
    adv_k, ret_k = gae_pallas(*map(jnp.asarray, (r, v, d, last)), gamma=0.97, lam=0.9,
                              interpret=True)
    adv_s, ret_s = jax_gae(*map(jnp.asarray, (r, v, d, last)), gamma=0.97, lam=0.9)
    for name, want in (("pallas", (adv_k, ret_k)), ("scan", (adv_s, ret_s))):
        _close(adv_e, want[0], f"adv vs {name}")
        _close(ret_e, want[1], f"ret vs {name}")


# ----------------------------------------------------------- V-trace
def _vtrace_data(shape, seed):
    """Time-major inputs with about 10 % dones and log-ratios spread so rho
    lands below and above the clips (every fifth exactly 1)."""
    rng = np.random.default_rng(seed)
    blp = (-np.abs(rng.standard_normal(shape)) - 0.1).astype(np.float32)
    tlp = (blp + 0.8 * rng.standard_normal(shape)).astype(np.float32)
    flat_t, flat_b = tlp.reshape(-1), blp.reshape(-1)
    flat_t[::5] = flat_b[::5]
    flat_t[1], flat_t[2] = flat_b[1] + 1.5, flat_b[2] - 1.5  # rho ~ 4.5 and ~ 0.22
    r, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    d = (rng.random(shape) < 0.1).astype(np.float32)
    last = rng.standard_normal(shape[1:]).astype(np.float32)
    return blp, tlp, r, v, d, last


# vtrace.cu forms delta_t and the decay a_t = disc_t * c_t while staging,
# scans them as GAE does, then writes vs_t = acc_t + v_t and pg_t from
# vs_{t+1} in one pass, vs of the later tile's first row (`last` for the
# latest tile) crossing tiles beside the scan's carry.
def _vtrace_emulated(blp, tlp, r, v, d, last, gamma, rho_clip, c_clip, warp):
    f32 = np.float32
    T = r.shape[0]
    blp, tlp, r, v, d = (x.reshape(T, -1) for x in (blp, tlp, r, v, d))
    last = last.reshape(-1)
    rho = np.exp(tlp - blp)
    crho = np.minimum(f32(rho_clip), rho)
    disc = f32(gamma) * (f32(1) - d)
    x = crho * (r + disc * np.concatenate([v[1:], last[None]]) - v)
    a = disc * np.minimum(f32(c_clip), rho)
    vs, pg = np.empty_like(r), np.empty_like(r)
    carry, next_vs = np.zeros_like(last), last
    for tile in _tiles(T):
        acc = _scan_tile_emulated(x[tile], a[tile], carry, warp)
        vs[tile] = acc + v[tile]
        nvs = np.concatenate([vs[tile][1:], next_vs[None]])
        pg[tile] = crho[tile] * (r[tile] + disc[tile] * nvs - v[tile])
        carry, next_vs = acc[0], vs[tile][0]
    return vs, pg


@functools.lru_cache(maxsize=None)
def _vtrace_references(shape, rho_clip, c_clip):
    """The inputs, then (vs, pg_adv) of the Pallas kernel (interpret mode)
    and of the JAX scan, made once for both scan orders."""
    data = _vtrace_data(shape, seed=sum(shape) * 11 + int(4 * rho_clip) + int(4 * c_clip))
    kw = dict(gamma=0.97, rho_clip=rho_clip, c_clip=c_clip)
    want_k = vtrace_pallas(*map(jnp.asarray, data), **kw, interpret=True)
    want_s = jax_vtrace(*map(jnp.asarray, data), **kw)
    return data, {"pallas": want_k, "scan": want_s}


# The IMPALA paths' [32, 16] and [32, 512]; T = 1; a ragged [33, 7]; one
# whole tile [128, 3]; [129, 8], whose row 127's v_{t+1} and vs_{t+1} come
# from the later tile; eight tiles, the last ragged, at T = 1,000; trailing
# dims flattened.  Clips 1/1 and 2/0.5, and c_clip 1.5 (decays above 1) at
# T = 1,000.
VTRACE_SHAPES = [(32, 16), (32, 512), (1, 5), (33, 7), (128, 3), (129, 8), (1000, 3), (16, 4, 2)]


@pytest.mark.parametrize("warp", [False, True], ids=["serial", "warp"])
@pytest.mark.parametrize("shape,rho_clip,c_clip",
                         [(s, 1.0, 1.0) for s in VTRACE_SHAPES]
                         + [(s, 2.0, 0.5) for s in VTRACE_SHAPES] + [((1000, 3), 1.0, 1.5)])
def test_vtrace_scan_orders_match_pallas_and_scan(shape, rho_clip, c_clip, warp):
    data, wants = _vtrace_references(shape, rho_clip, c_clip)
    rhos = np.exp(data[1] - data[0])
    assert (rhos < min(rho_clip, c_clip)).any() and (rhos > max(rho_clip, c_clip)).any()
    assert data[4].any() or shape[0] == 1  # dones, but at T = 1 (5 elements)
    vs_e, pg_e = _vtrace_emulated(*data, 0.97, rho_clip, c_clip, warp)
    for name, want in wants.items():
        _close(vs_e, np.asarray(want[0]).reshape(vs_e.shape), f"vs vs {name}")
        _close(pg_e, np.asarray(want[1]).reshape(pg_e.shape), f"pg_adv vs {name}")


# ----------------------------------------------------------- surrogate
def _boundary_blp(bound):
    """A behaviour logp putting the ratio of a row whose logp is exactly 0
    exactly on ``bound`` in both frameworks (each computes exp(0 - blp))."""
    target = np.float32(bound)
    cands = (-np.log(target) + np.arange(-64, 65) * 5e-9).astype(np.float32)
    r_j = np.asarray(jnp.exp(-jnp.asarray(cands)))
    r_t = torch.exp(-torch.from_numpy(cands)).numpy()
    hit = np.nonzero((r_j == target) & (r_t == target))[0]
    assert hit.size, f"no behaviour logp puts the ratio exactly on {bound}"
    return cands[hit[hit.size // 2]]


def _surrogate_data(B, A, seed, clip_eps):
    """Random rows, then at the top rows with zero logits and ratio exactly 1
    (the min() ties inside the band), and rows exactly on the hi and lo clip
    bounds: logits [30, 0, ...] with action 0 make logp exactly 0 (the exp
    sum rounds to 1), so the ratio is exp(-blp) and a searched blp pins it."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, A)).astype(np.float32)
    actions = rng.integers(0, A, B).astype(np.int64)
    values = rng.standard_normal(B).astype(np.float32)
    adv = rng.standard_normal(B).astype(np.float32)
    ret = rng.standard_normal(B).astype(np.float32)
    n = max(B // 8, 1)
    logits[:n] = 0.0
    logits[n: 3 * n] = 0.0
    logits[n: 3 * n, 0] = 30.0
    actions[n: 3 * n] = 0
    logp = np.asarray(
        jax.nn.log_softmax(jnp.asarray(logits))[np.arange(B), actions], np.float32
    )
    assert (logp[n: 3 * n] == 0.0).all()
    blp = (logp + 0.3 * rng.standard_normal(B)).astype(np.float32)
    blp[:n] = logp[:n]
    blp[n: 2 * n] = _boundary_blp(1.0 + clip_eps)
    blp[2 * n: 3 * n] = _boundary_blp(1.0 - clip_eps)
    return logits, actions, values, blp, adv, ret


def _jax_terms(fn, data, clip_eps):
    logits, actions, values, blp, adv, ret = map(jnp.asarray, data)
    return fn(logits, values, actions.astype(jnp.int32), blp, adv, ret, clip_eps=clip_eps)


def _jax_grads(fn, data, clip_eps, cots):
    logits, actions, values, blp, adv, ret = map(jnp.asarray, data)

    def f(lg, v, b, a, r):
        terms = fn(lg, v, actions.astype(jnp.int32), b, a, r, clip_eps=clip_eps)
        return sum(jnp.sum(t * c) for t, c in zip(terms, cots))

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(logits, values, blp, adv, ret)


def _torch_terms_and_grads(data, clip_eps, cots):
    logits, actions, values, blp, adv, ret = map(torch.from_numpy, data)
    xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
    terms = ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)
    grads = torch.autograd.grad(terms, xs, grad_outputs=[torch.from_numpy(c) for c in cots])
    return [t.detach() for t in terms], grads


# The PPO path's minibatch [256, 2], lanes off the panel (130), a wide action
# space, and clip_eps = 0 where the ratio-1 rows sit on both bounds at once.
@pytest.mark.parametrize(
    "B,A,clip_eps", [(256, 2, 0.2), (130, 5, 0.2), (64, 18, 0.1), (40, 3, 0.0)]
)
def test_surrogate_terms_and_grads_match_pallas(B, A, clip_eps):
    data = _surrogate_data(B, A, seed=B * 100 + A, clip_eps=clip_eps)
    cots = [np.random.default_rng(B + i).standard_normal(B).astype(np.float32) for i in range(4)]
    terms_t, grads_t = _torch_terms_and_grads(data, clip_eps, cots)
    for fn in (ppo_surrogate_ref, lambda *a, **k: ppo_surrogate_pallas(*a, **k, interpret=True)):
        for name, t, j in zip(("pg", "vf", "ent", "kl"), terms_t, _jax_terms(fn, data, clip_eps)):
            _close(t, j, name)
        grads_j = _jax_grads(fn, data, clip_eps, cots)
        for name, t, j in zip(("logits", "values", "blp", "adv", "ret"), grads_t, grads_j):
            _close(t, j, f"d{name}")


def test_surrogate_tie_rows_take_the_balanced_gradient():
    """On a row exactly on a clip bound, the clip's max or min ties and so
    does the outer min: JAX takes half of each, so d pg / d ratio is
    -(0.5 + 0.5 * 0.5) * adv and d blp = 0.75 * adv * bound.  ``torch.clamp``
    would pass a full gradient and give adv * bound."""
    B, A, clip_eps = 16, 2, 0.2
    data = _surrogate_data(B, A, seed=7, clip_eps=clip_eps)
    cots = [np.ones(B, np.float32), *(np.zeros(B, np.float32) for _ in range(3))]
    _, grads_t = _torch_terms_and_grads(data, clip_eps, cots)
    grads_j = _jax_grads(ppo_surrogate_ref, data, clip_eps, cots)
    adv = data[4]
    n = B // 8
    for rows, bound in ((slice(n, 2 * n), 1.0 + clip_eps), (slice(2 * n, 3 * n), 1.0 - clip_eps)):
        want = 0.75 * adv[rows] * np.float32(bound)
        np.testing.assert_allclose(grads_t[2].numpy()[rows], want, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(grads_j[2])[rows], want, rtol=1e-6)


# The CUDA backward takes the forward's saved row logsumexp and entropy and
# reads the logits once (csrc/surrogate.cu).  Its arithmetic, emulated in
# float32 from those saved statistics as each forward variant forms them,
# must match jax.grad of the oracle and of the Pallas kernel.
ROWS_MIN_A = 1024  # kRowsMinA: the chunked forward from this width
FWD_COLS = 4096  # kFwdCols: columns of a chunk


def _chunked_stats(x: torch.Tensor):
    """The chunked forward's row statistics: per chunk of FWD_COLS columns
    its max m_k, s_k = sum e and t_k = sum e (x - m_k), e = exp(x - m_k);
    merged in chunk order into m = max m_k, s = sum s_k f_k and
    t = sum f_k (t_k + s_k (m_k - m)), f_k = exp(m_k - m).  (The kernel adds
    chunks in this order while a row has at most 256 of them.)"""
    parts = []
    for c0 in range(0, x.shape[1], FWD_COLS):
        xc = x[:, c0: c0 + FWD_COLS]
        mk = xc.max(dim=-1).values
        dk = xc - mk[:, None]
        e = torch.exp(dk)
        parts.append((mk, e.sum(dim=-1), (e * dk).sum(dim=-1)))
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    s, t = torch.zeros_like(m), torch.zeros_like(m)
    for mk, sk, tk in parts:
        dk = mk - m
        f = torch.exp(dk)
        s = s + sk * f
        t = t + f * (tk + sk * dk)
    return m, s, t


def _forward_stats(logits: np.ndarray):
    """The forward kernels' lse and entropy: one thread per row below
    ROWS_MIN_A (max, exp sum, then -sum p lp), the chunked map above it
    (H = log s - t / s from the merged chunk statistics)."""
    x = torch.from_numpy(logits)
    if x.shape[1] < ROWS_MIN_A:
        m = x.max(dim=-1, keepdim=True).values
        lse = m[:, 0] + torch.log(torch.exp(x - m).sum(dim=-1))
        lp = x - lse[:, None]
        return lse, -(torch.exp(lp) * lp).sum(dim=-1)
    m, s, t = _chunked_stats(x)
    return m + torch.log(s), torch.log(s) - t / s


def _surrogate_fwd_emulated(data, clip_eps):
    """The forward's terms (pg, vf, ent, kl) and lse from ``_forward_stats``,
    as the kernels form them (the action's logit minus lse, 0 off range)."""
    logits, actions, values, blp, adv, ret = map(torch.from_numpy, data)
    B, A = logits.shape
    lse, ent = _forward_stats(data[0])
    valid = (actions >= 0) & (actions < A)
    logp = torch.where(valid, logits[torch.arange(B), torch.where(valid, actions, 0)] - lse, 0.0)
    ratio = torch.exp(logp - blp)
    lo, hi = torch.tensor(1 - clip_eps), torch.tensor(1 + clip_eps)
    pg = -torch.minimum(ratio * adv, torch.minimum(torch.maximum(ratio, lo), hi) * adv)
    return (pg, torch.square(values - ret), ent, blp - logp), lse


def _chunked_case(case):
    """Inputs for the chunked forward: (16, 4099) has a ragged tail after
    the last whole float4; (4, 8197) three chunks, the last of 5 columns;
    the others at (8, 8197): a row's max in its last chunk, a row of equal
    logits, a row whose first chunk lies 120 below the rest (its
    exp(m_k - m) underflows to 0), and actions outside [0, A)."""
    B, A = {"ragged_tail": (16, 4099), "three_chunks": (4, 8197)}.get(case, (8, 8197))
    data = list(_surrogate_data(B, A, seed=B + A, clip_eps=0.2))
    logits, actions = data[0], data[1]
    if case == "max_in_last_chunk":
        logits[3:, -2] = 9.0
    elif case == "equal_logits":
        logits[3:] = 0.75
    elif case == "underflowing_chunk":
        logits[3:, :FWD_COLS] -= 120.0
    elif case == "action_out_of_range":
        actions[3], actions[5] = A, -1
    return tuple(data)


@pytest.mark.parametrize("case", ["ragged_tail", "three_chunks", "max_in_last_chunk",
                                  "equal_logits", "underflowing_chunk", "action_out_of_range"])
def test_chunked_surrogate_forward_matches_pallas_and_ref(case):
    data = _chunked_case(case)
    if case == "underflowing_chunk":
        parts_m = data[0][:, :FWD_COLS].max(axis=1)
        assert (np.exp(parts_m[3:] - data[0].max(axis=1)[3:]) == 0).all()
    terms, lse = _surrogate_fwd_emulated(data, 0.2)
    _close(lse, jax.nn.logsumexp(jnp.asarray(data[0]), axis=-1), "lse")
    # The oracle's gather is undefined off range (NaN past A, wrapping below
    # 0); the Pallas kernel's one-hot contraction gives logp = 0 there.
    for fn in (_pallas,) if case == "action_out_of_range" else (ppo_surrogate_ref, _pallas):
        for name, t, j in zip(("pg", "vf", "ent", "kl"), terms, _jax_terms(fn, data, 0.2)):
            _close(t, j, f"{name} vs {getattr(fn, '__name__', fn)}")


def _balanced(x, z, y):
    """d/dx of min/max(x, y) at its result z: 1 off a tie, 0.5 on one."""
    return torch.where(x == z, torch.where(y == z, 0.5, 1.0), 0.0)


def _surrogate_bwd_from_saved_stats(data, clip_eps, cots):
    logits, actions, values, blp, adv, ret = map(torch.from_numpy, data)
    gpg, gvf, gent, gkl = map(torch.from_numpy, cots)
    B, A = logits.shape
    lse, ent = _forward_stats(data[0])
    valid = (actions >= 0) & (actions < A)
    logp = torch.where(valid, logits[torch.arange(B), torch.where(valid, actions, 0)] - lse, 0.0)
    lo, hi = torch.tensor(1 - clip_eps), torch.tensor(1 + clip_eps)
    ratio = torch.exp(logp - blp)
    mx = torch.maximum(ratio, lo)
    rc = torch.minimum(mx, hi)
    u, c = ratio * adv, rc * adv
    mn = torch.minimum(u, c)
    du, dc = _balanced(u, mn, c), _balanced(c, mn, u)
    dcl = _balanced(ratio, mx, lo) * _balanced(mx, rc, hi)
    g_ratio = -gpg * (du * adv + dc * adv * dcl)
    g_logp = g_ratio * ratio - gkl
    # The row sum of t_j from the saved entropy: sum_j p_j (lp_j + 1) = 1 - H.
    t_sum = torch.where(valid, g_logp, 0.0) - gent * (1 - ent)
    lp = logits - lse[:, None]
    p = torch.exp(lp)
    hit = torch.arange(A)[None] == actions[:, None]
    t = torch.where(hit, g_logp[:, None], 0.0) - gent[:, None] * p * (lp + 1)
    dv = gvf * 2 * (values - ret)
    return (t - p * t_sum[:, None], dv, -g_ratio * ratio + gkl,
            -gpg * (du * ratio + dc * rc), -dv)


def _pallas(*a, **k):
    return ppo_surrogate_pallas(*a, **k, interpret=True)


# RL action spaces (2, 18) and a vocabulary-wide row (4099: past kRowsMinA,
# with a ragged tail after the last whole 1024 and float4s).
@pytest.mark.parametrize("B,A", [(64, 2), (64, 18), (16, 4099)])
def test_surrogate_backward_from_saved_stats_matches_jax_grad(B, A):
    clip_eps = 0.2
    data = _surrogate_data(B, A, seed=A + 3, clip_eps=clip_eps)
    cots = [np.random.default_rng(A + i).standard_normal(B).astype(np.float32) for i in range(4)]
    got = _surrogate_bwd_from_saved_stats(data, clip_eps, cots)
    for fn in (ppo_surrogate_ref, _pallas):
        want = _jax_grads(fn, data, clip_eps, cots)
        for name, t, j in zip(("logits", "values", "blp", "adv", "ret"), got, want):
            _close(t, j, f"d{name}")


def test_surrogate_backward_from_saved_stats_out_of_range_action():
    """An action outside [0, A) gathers nothing: logp is 0 and no logit gets
    the action's cotangent, as the Pallas kernel's one-hot contraction
    gives."""
    clip_eps = 0.2
    logits, actions, *rest = _surrogate_data(32, 18, seed=9, clip_eps=clip_eps)
    actions = actions.copy()
    actions[20], actions[27] = 18, -1
    data = (logits, actions, *rest)
    cots = [np.random.default_rng(40 + i).standard_normal(32).astype(np.float32) for i in range(4)]
    got = _surrogate_bwd_from_saved_stats(data, clip_eps, cots)
    want = _jax_grads(_pallas, data, clip_eps, cots)
    for name, t, j in zip(("logits", "values", "blp", "adv", "ret"), got, want):
        _close(t, j, f"d{name}")


def test_surrogate_backward_from_saved_stats_takes_the_balanced_gradient_on_ties():
    """The tie rows of ``test_surrogate_tie_rows_take_the_balanced_gradient``:
    exactly on a clip bound, d blp = 0.75 * adv * bound."""
    B, A, clip_eps = 16, 2, 0.2
    data = _surrogate_data(B, A, seed=7, clip_eps=clip_eps)
    cots = [np.ones(B, np.float32), *(np.zeros(B, np.float32) for _ in range(3))]
    got = _surrogate_bwd_from_saved_stats(data, clip_eps, cots)
    adv = data[4]
    n = B // 8
    for rows, bound in ((slice(n, 2 * n), 1.0 + clip_eps), (slice(2 * n, 3 * n), 1.0 - clip_eps)):
        np.testing.assert_allclose(got[2].numpy()[rows], 0.75 * adv[rows] * np.float32(bound),
                                   rtol=1e-6)
    for name, t, j in zip(("logits", "values", "blp", "adv", "ret"), got,
                          _jax_grads(ppo_surrogate_ref, data, clip_eps, cots)):
        _close(t, j, f"d{name}")


def test_fused_ppo_loss_matches_reference_dispatch():
    from repro.kernels import ops as jax_ops

    data = _surrogate_data(256, 2, seed=11, clip_eps=0.2)
    logits, actions, values, blp, adv, ret = data
    loss_j, aux_j = jax_ops.fused_ppo_loss(
        *map(jnp.asarray, (logits, values)), jnp.asarray(actions, jnp.int32),
        *map(jnp.asarray, (blp, adv, ret)), clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
    )
    loss_t, aux_t = ops.fused_ppo_loss(
        *map(torch.from_numpy, (logits, values, actions, blp, adv, ret)),
        clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
    )
    _close(loss_t, loss_j, "loss")
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        _close(aux_t[k], aux_j[k], k)


# ------------------------------------------------------------ wrappers
def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; the plain version
    is reached only through ``ops`` for CPU tensors, never as a fallback."""
    r, v, d, last = map(torch.from_numpy, _gae_data(4, 3, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        gae_cuda(r, v, d, last)
    with pytest.raises(ValueError, match="CUDA"):
        vtrace_cuda(v, v, r, v, d, last)
    data = list(map(torch.from_numpy, _surrogate_data(8, 2, seed=0, clip_eps=0.2)))
    logits, actions, values, blp, adv, ret = data
    with pytest.raises(ValueError, match="CUDA"):
        ppo_surrogate_cuda(logits, values, actions, blp, adv, ret)


def test_ctypes_signatures_match_the_cuda_sources():
    """The C entry points the wrappers bind exist in csrc/ with as many
    parameters as their ctypes signature declares (the sources compile only
    on the GPU machine, so this is the CPU-side check of the binding)."""
    found = {}
    for src in build.CSRC_DIR.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {name: len(sig) for name, sig in build._SIGNATURES.items()}
    assert any(f.startswith("-gencode=arch=compute_90a,code=sm_90a") for f in build.NVCC_FLAGS)


def _launch_params(src, entry):
    """The parameter types of the C entry point ``entry`` in ``src``."""
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src.read_text())
    assert found, f"{entry} not in {src.name}"
    return [" ".join(p.split()[:-1]) for p in found.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(gae_variants.VARIANTS))
def test_gae_variants_take_gae_launch_arguments(name):
    """``python -m repro_torch.kernels.gae_variants`` binds every variant with
    gae_launch's ctypes signature: each source defines its entry point with
    gae_launch's parameter list."""
    src, entry = gae_variants.VARIANTS[name]
    assert _launch_params(src, entry) == _launch_params(build.CSRC_DIR / "gae.cu", "gae_launch")
    assert len(_launch_params(src, entry)) == len(build._SIGNATURES["gae_launch"])


@pytest.mark.parametrize("name", sorted(vtrace_variants.VARIANTS))
def test_vtrace_variants_take_vtrace_launch_arguments(name):
    """``python -m repro_torch.kernels.vtrace_variants`` binds every variant
    with vtrace_launch's ctypes signature: each source defines its entry
    point with vtrace_launch's parameter list."""
    src, entry = vtrace_variants.VARIANTS[name]
    want = _launch_params(build.CSRC_DIR / "vtrace.cu", "vtrace_launch")
    assert _launch_params(src, entry) == want
    assert len(want) == len(build._SIGNATURES["vtrace_launch"])


def test_launch_counter_counts_under_threads():
    import threading

    counter = build.LaunchCounter("t")
    threads = [threading.Thread(target=lambda: [counter.add() for _ in range(1000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert counter.value == 8000
    counter.reset()
    assert counter.value == 0
