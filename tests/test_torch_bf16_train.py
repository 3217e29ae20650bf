"""Training at bfloat16, the dtype every model configuration defaults to, on
the CPU: the plain versions of the bf16 backward kernels, the learner's
optimizer step, the driver's dtype, weight syncs and checkpoints.

* The flash backward's plain version (autograd through
  ``flash_attention_plain`` at bf16: exact fp32 gradients, each rounded to
  bf16 once) against ``jax.grad`` of the reference's
  ``ref.chunked_attention`` at bf16, causal, windowed, with a ``q_offset``
  and GQA at D 64 and 128, within the reference's own bf16 attention
  tolerance, 2e-2 (``tests/test_kernels.py``).
* RWKV-6 at bf16 (r, k, v, w bf16; u and the state float32, as the model
  passes them): the plain forward against ``rwkv6_pallas(...,
  interpret=True)`` and its autograd against ``jax.grad`` of
  ``ref.rwkv6_ref``, at 2e-2 (du, float32 in both, at 1e-4), decays at the
  model's clip included (the largest rounds to exactly 1.0 in bf16).
* ``GmmMatmul``'s bf16 backward, on the CPU and through the einsums the
  card runs (``moe.gmm_bwd_einsums``), against the reference's
  ``_gmm_matmul_bwd`` at 5e-2, the reference's grouped-matmul tolerance.
* The driver's optimizer at bf16: parameters stay bf16, AdamW's moments
  float32, the clip scale multiplies in float32 as the reference's bf16
  gradient times its float32 scale does, and a step from the same bf16
  gradients gives the reference's weights bit for bit.
* ``train_config`` keeps each architecture's own dtype; a bf16 weight sync
  through ``interop`` and a bf16 checkpoint keep a bf16 learner's dtype and
  bits.

Inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.ref import chunked_attention, rwkv6_ref
from repro.kernels.rwkv6 import rwkv6_pallas
from repro.models.moe import _gmm_matmul_bwd
from repro_torch import optim
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import ARCHITECTURES, InputShape, get_config, reduced_config
from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
from repro_torch.data import make_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rwkv6 import rwkv6_plain
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.tree import tree_leaves

BF16 = ml_dtypes.bfloat16
ATTENTION_TOL = 2e-2  # tests/test_kernels.py's bf16 tolerance for the attention kernels
GMM_TOL = 5e-2  # and for the grouped matmul
FP32_GRAD_TOL = 1e-4  # the port's float32 gradient tolerance


def _bf16(rng, *shape, scale=1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32).astype(BF16)


def _close(got: torch.Tensor, want, tol: float, name: str, dtype=torch.bfloat16) -> None:
    assert got.dtype == dtype, f"{name}: {got.dtype}, expected {dtype}"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


def _leaves(*arrays, grad=False):
    out = params_from_numpy(list(arrays))
    return [x.requires_grad_(grad) for x in out]


# ------------------------------------------------------------ flash backward
FLASH_CASES = {
    "causal-D64": (128, 128, 4, 4, 64, True, 0, 0),
    "window-gqa-D64": (192, 192, 4, 2, 64, True, 64, 0),
    "q_offset-gqa-D128": (64, 192, 8, 2, 128, True, 0, 128),
    "causal-gqa-D128": (128, 128, 8, 1, 128, True, 0, 0),
    "full-D64": (64, 128, 4, 4, 64, False, 0, 0),
}


def _flash_inputs(case: str):
    Sq, Sk, H, KV, D, causal, window, q_offset = FLASH_CASES[case]
    rng = np.random.default_rng(Sq + Sk + H + D + window + q_offset)
    q, k, v = _bf16(rng, 2, Sq, H, D), _bf16(rng, 2, Sk, KV, D), _bf16(rng, 2, Sk, KV, D)
    return (q, k, v, _bf16(rng, 2, Sq, H, D)), dict(causal=causal, window=window,
                                                     q_offset=q_offset)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_bf16_backward_matches_jax_grad(case):
    (q, k, v, dout), kw = _flash_inputs(case)
    out_j, vjp = jax.vjp(lambda a, b, c: chunked_attention(a, b, c, chunk=64, **kw),
                         *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    assert out_j.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in want)
    for attention in (flash_attention_plain, ops.flash_attention):
        qt, kt, vt = _leaves(q, k, v, grad=True)
        out = attention(qt, kt, vt, **kw)
        assert out.dtype == torch.bfloat16
        got = torch.autograd.grad(out, (qt, kt, vt), params_from_numpy(dout))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(a, b, ATTENTION_TOL, f"{case} {attention.__name__} {name}")


@pytest.mark.parametrize("case", ["window-gqa-D64", "q_offset-gqa-D128"])
def test_flash_plain_bf16_backward_rounds_once_from_float32(case):
    """Each bf16 gradient of the plain version is its float32 computation's
    (the same function on the widened inputs) rounded once."""
    (q, k, v, dout), kw = _flash_inputs(case)
    qt, kt, vt = _leaves(q, k, v, grad=True)
    got = torch.autograd.grad(flash_attention_plain(qt, kt, vt, **kw), (qt, kt, vt),
                              params_from_numpy(dout))
    wide = [x.detach().float().requires_grad_(True) for x in (qt, kt, vt)]
    want = torch.autograd.grad(flash_attention_plain(*wide, **kw), wide,
                               params_from_numpy(dout).float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


# ------------------------------------------------------------------- RWKV-6
RWKV_CASES = {"T64-N16": (2, 64, 2, 16, 16), "T96-N32": (1, 96, 2, 32, 32)}


def _rwkv_inputs(case: str, clip: bool):
    """r, k, v ~ 0.5 N(0, 1), decays by the model's law (``models/ssm.py``)
    at its initial bias, or half of them at the clip's two ends (exp(-e^2)
    and exp(-e^-8), which rounds to exactly 1.0 in bf16), all bf16; u float32."""
    B, T, H, N, chunk = RWKV_CASES[case]
    rng = np.random.default_rng(T + N + int(clip))
    r, k, v = (_bf16(rng, B, T, H, N, scale=0.5) for _ in range(3))
    logit = np.clip(-2.0 + 0.5 * rng.standard_normal((B, T, H, N)), -8.0, 2.0)
    if clip:
        ends = rng.choice([-8.0, 2.0], size=logit.shape)
        logit = np.where(rng.random(logit.shape) < 0.5, ends, logit)
    w = np.exp(-np.exp(logit)).astype(np.float32).astype(BF16)
    if clip:
        assert (w == BF16(1.0)).any()
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    return r, k, v, w, u, _bf16(rng, B, T, H, N), chunk


@pytest.mark.parametrize("clip", [False, True], ids=["law", "clip"])
@pytest.mark.parametrize("case", list(RWKV_CASES))
def test_rwkv6_plain_bf16_forward_matches_pallas(case, clip):
    r, k, v, w, u, _, chunk = _rwkv_inputs(case, clip)
    want, want_s = rwkv6_pallas(*(jnp.asarray(x) for x in (r, k, v, w, u)), chunk=chunk,
                                interpret=True)
    assert want.dtype == jnp.bfloat16
    for fn in (rwkv6_plain, ops.rwkv6):
        out, s = fn(*params_from_numpy([r, k, v, w, u]), chunk=chunk)
        _close(out, want, ATTENTION_TOL, f"{case} {fn.__name__} out")
        _close(s, want_s, FP32_GRAD_TOL, f"{case} {fn.__name__} state", torch.float32)


@pytest.mark.parametrize("clip", [False, True], ids=["law", "clip"])
@pytest.mark.parametrize("case", list(RWKV_CASES))
def test_rwkv6_plain_bf16_backward_matches_jax_grad(case, clip):
    r, k, v, w, u, dout, chunk = _rwkv_inputs(case, clip)
    B, T, H, N, _ = RWKV_CASES[case]
    _, vjp = jax.vjp(lambda *xs: rwkv6_ref(*xs), *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = vjp((jnp.asarray(dout), jnp.zeros((B, H, N, N), jnp.float32)))
    xs = _leaves(r, k, v, w, u, grad=True)
    out, _ = rwkv6_plain(*xs, chunk=chunk)
    got = torch.autograd.grad(out, xs, params_from_numpy(dout))
    for name, a, b in zip(("dr", "dk", "dv", "dw"), got, want):
        _close(a, b, ATTENTION_TOL, f"{case} {name}")
    _close(got[4], want[4], FP32_GRAD_TOL, f"{case} du", torch.float32)


def test_rwkv6_plain_bf16_rounds_once_from_float32():
    """The bf16 output and gradients of the plain version are its float32
    computation's rounded once; du and the state stay float32."""
    r, k, v, w, u, dout, chunk = _rwkv_inputs("T64-N16", True)
    xs = _leaves(r, k, v, w, u, grad=True)
    out, s = rwkv6_plain(*xs, chunk=chunk)
    got = torch.autograd.grad(out, xs, params_from_numpy(dout))
    wide = [x.detach().float().requires_grad_(True) for x in xs]
    out32, s32 = rwkv6_plain(*wide, chunk=chunk)
    want = torch.autograd.grad(out32, wide, params_from_numpy(dout).float())
    assert torch.equal(out, out32.to(torch.bfloat16)) and torch.equal(s, s32)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    assert got[4].dtype == torch.float32 and torch.equal(got[4], want[4])


# ---------------------------------------------------- the grouped matmul
def test_gmm_matmul_bf16_backward_matches_reference():
    """``GmmMatmul``'s backward at bf16 (the CPU's grouped loops) and the
    einsums the card runs at bf16 against ``_gmm_matmul_bwd``."""
    rng = np.random.default_rng(7)
    B, E, C, K, N = 2, 4, 6, 32, 48
    xe, w, dy = _bf16(rng, B, E, C, K), _bf16(rng, E, K, N, scale=0.2), _bf16(rng, B, E, C, N)
    want = _gmm_matmul_bwd((jnp.asarray(xe), jnp.asarray(w)), jnp.asarray(dy))
    assert all(g.dtype == jnp.bfloat16 for g in want)
    xt, wt = _leaves(xe, w, grad=True)
    out = moe.GmmMatmul.apply(xt, wt)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, (xt, wt), params_from_numpy(dy))
    einsums = moe.gmm_bwd_einsums(*params_from_numpy([xe, w, dy]))
    for how, pair in (("autograd", got), ("einsums", einsums)):
        for name, a, b in zip(("dx", "dw"), pair, want):
            _close(a, b, GMM_TOL, f"{how} {name}")


# ------------------------------------------------------------- optimizer
def _opt_inputs(seed: int, scale: float):
    rng = np.random.default_rng(seed)
    params = {"a": _bf16(rng, 64, 48, scale=0.1), "b": {"c": _bf16(rng, 300, scale=0.1)}}
    grads = [{"a": _bf16(rng, 64, 48, scale=scale), "b": {"c": _bf16(rng, 300, scale=scale)}}
             for _ in range(3)]
    return params, grads


def _steps_both(chain, params, grads):
    """Three steps of ``chain(module)`` in both packages from the same bf16
    parameters and gradients: (the reference's params and state, the
    port's in-place params and state)."""
    opt_j, opt_t = chain(jax_optim), chain(optim)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = params_from_numpy(params)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in grads:
        pj, sj = opt_j.apply(pj, jax.tree_util.tree_map(jnp.asarray, g), sj)
        st = opt_t.apply_(pt, tree_leaves(params_from_numpy(g)), st)
    return pj, sj, pt, st


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def test_clip_scale_multiplies_in_float32_as_the_reference():
    """The reference's clipped gradient is a bf16 gradient times a float32
    scale, which promotes to float32; torch keeps a bf16 tensor times a 0-d
    float32 one in bf16, and rounding it there before the update moves
    weights (SGD at lr 1 from the same bf16 gradients, clipping active).
    The gradients are +-1 over 60^2 elements, so the global norm, 60, and
    the scale are exact in any order of summation."""
    rng = np.random.default_rng(3)
    params = {"a": _bf16(rng, 48, 50, scale=0.1), "b": {"c": _bf16(rng, 1200, scale=0.1)}}
    grads = [jax.tree_util.tree_map(
        lambda p: np.sign(rng.standard_normal(p.shape)).astype(BF16), params) for _ in range(2)]
    pj, _, pt, _ = _steps_both(
        lambda m: m.chain_clip_by_global_norm(m.sgd(1.0), max_norm=1.0), params, grads)
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16), _bits(b))


def test_pretrain_optimizer_at_bf16_matches_reference_bitwise():
    """The driver's AdamW under its schedule and clip, from the same bf16
    parameters and gradients: bf16 parameters and float32 moments, the
    reference's weights bit for bit and its moments within 1e-6."""
    params, grads = _opt_inputs(5, 3.0)
    pj, sj, pt, st = _steps_both(lambda m: m.chain_clip_by_global_norm(
        m.adamw(m.linear_warmup_cosine(1e-2, 2, 5), weight_decay=0.1), max_norm=1.0),
        params, grads)
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16), _bits(b))
    for a, b in zip(tree_leaves(st.mu) + tree_leaves(st.nu),
                    jax.tree_util.tree_leaves(sj.mu) + jax.tree_util.tree_leaves(sj.nu)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_learner_step_at_bf16_keeps_bf16_params_and_float32_moments():
    """One step of the driver's learner at a reduced configuration's own
    dtype: loss in float32 and finite, parameters bf16, moments float32,
    each weight within one step's update (lr at the first step, times 1 +
    weight decay, each way) and one bf16 ulp of the reference learner's
    step from the same weights."""
    from repro.core.spmd import SPMDLearnerWorker as JaxLearner
    from repro.core.spmd import SPMDTrainContext as JaxContext
    from repro.launch.mesh import make_local_mesh

    cfg = train.train_config("qwen3-14b", smoke=True)
    assert cfg.dtype == "bfloat16"
    opt_j = jax_optim.chain_clip_by_global_norm(
        jax_optim.adamw(jax_optim.linear_warmup_cosine(3e-4, 20, 100), weight_decay=0.1),
        max_norm=1.0)
    ref = JaxLearner(JaxContext(jax_reduced_config("qwen3-14b"), opt_j, make_local_mesh()), seed=0)
    learner, _, _, _ = train.make_pretrain(cfg, 16, 2, 1, steps=20, device="cpu")
    start = jax.tree_util.tree_map(np.asarray, ref.params)
    learner.set_weights(params_from_numpy(start))
    batch = make_batch(cfg, InputShape("t", 16, 2, "train"), seed=0, step=0)
    info_j, info_t = ref.learn_on_batch(batch), learner.learn_on_batch(batch)
    assert np.isfinite(info_t["loss"]) and abs(info_t["loss"] - info_j["loss"]) < 5e-2
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(learner.params))
    st = learner.opt_state
    assert all(m.dtype == torch.float32 for m in tree_leaves(st.mu) + tree_leaves(st.nu))
    step = optim.linear_warmup_cosine(3e-4, 20, 100)(0) * (1 + 0.1)
    for a, b in zip(tree_leaves(learner.params), jax.tree_util.tree_leaves(ref.params)):
        b = np.asarray(b, np.float32)
        ulp = np.abs(b) * 2.0 ** -7 + 1e-30
        assert (np.abs(a.detach().float().numpy() - b) <= 2 * step + ulp).all()


# ------------------------------------------------------- driver and state
@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_train_config_keeps_each_architectures_dtype(arch):
    assert get_config(arch).dtype == "bfloat16"
    assert train.train_config(arch).dtype == get_config(arch).dtype
    assert train.train_config(arch, smoke=True).dtype == reduced_config(arch).dtype
    cfg, _ = train.train_config(arch, layers=get_config(arch).num_layers, with_note=True)
    assert cfg.dtype == "bfloat16"


def _bf16_learner(seed: int) -> SPMDLearnerWorker:
    cfg = train.train_config("rwkv6-7b", smoke=True)
    return SPMDLearnerWorker(SPMDTrainContext(cfg, optim.sgd(1.0), device="cpu"), seed=seed)


def test_bf16_weight_sync_through_interop_keeps_dtype_and_bits():
    """``params_to_numpy`` widens a bf16 tree to float32 (exactly); a bf16
    learner that takes such weights copies them into its own bf16 tensors,
    so it keeps its dtype and gets the sender's bits."""
    sender, receiver = _bf16_learner(0), _bf16_learner(1)
    sender.learn_on_batch(make_batch(sender.ctx.model.cfg, InputShape("t", 16, 2, "train")))
    wire = params_to_numpy(sender.get_weights())
    assert all(a.dtype == np.float32 for a in tree_leaves(wire))
    receiver.set_weights(params_from_numpy(wire))
    for a, b in zip(tree_leaves(receiver.params), tree_leaves(sender.params), strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a.detach(), b.detach())


def test_bf16_checkpoint_restores_bitwise_into_a_bf16_template(tmp_path):
    learner = _bf16_learner(0)
    learner.learn_on_batch(make_batch(learner.ctx.model.cfg, InputShape("t", 16, 2, "train")))
    path = str(tmp_path / "bf16.npz")
    save_pytree(path, learner.params)
    with np.load(path) as data:
        assert all(data[k].dtype == np.float32 for k in data.files)
    like = _bf16_learner(1).params
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(like), tree_leaves(learner.params)))
    restored = restore_pytree(path, like)
    for a, b in zip(tree_leaves(restored), tree_leaves(learner.params), strict=True):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.detach().view(torch.int16), b.detach().view(torch.int16))


# ------------------------------------------------------------- explain
@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-7b", "phi3.5-moe-42b-a6.6b"])
def test_explain_prices_a_bf16_pretraining_step(arch):
    """``Algorithm.explain()`` on the pretraining flow at the configuration's
    own dtype prices the learner's step; each kernel is charged its bound's
    formula (``distributed/hlo_cost.py``, the counts ``chip_smoke.py``'s
    bounds take) at 2 bytes an element."""
    from repro_torch.distributed import hlo_cost
    from repro_torch.distributed.hlo_analysis import HW_H100
    from repro_torch.flow import Algorithm

    assert HW_H100.bf16_flops == 989e12
    cfg = train.train_config(arch, smoke=True)
    learner, _, workers, spec = train.make_pretrain(cfg, 32, 2, 1, steps=4, device="cpu")
    with Algorithm.from_plan(spec, workers) as algo:
        algo.train()
        report = algo.explain()
    (row,) = [r for r in report.rows if r.label.endswith("SPMDTrainStep")]
    assert not row.note and row.flops > 0 and row.hbm_bytes > 0
    formulas = {"flash_attention": hlo_cost.flash_costs, "rwkv6": hlo_cost.rwkv6_costs}
    want = {"qwen3-14b": {"flash_attention", "flash_attention_bwd"},
            "rwkv6-7b": {"rwkv6", "rwkv6_bwd"},
            "phi3.5-moe-42b-a6.6b": {"flash_attention", "flash_attention_bwd", "moe_gmm",
                                     "moe_gmm_dx", "moe_gmm_dw"}}[arch]
    assert want <= set(row.kernels)
    for name, agg in row.kernels.items():
        base = name[:-4] if name.endswith("_bwd") else name
        flops = nbytes = 0
        for key, n in agg["sizes"]:
            assert key["es"] == 2, (name, key)
            if base in formulas:
                cost = formulas[base](**key)[1 if name.endswith("_bwd") else 0]
            else:
                cost = hlo_cost.gmm_cost(**key)
            flops += n * cost[0]
            nbytes += n * cost[1]
        assert (agg["flops"], agg["bytes"]) == (flops, nbytes), name
