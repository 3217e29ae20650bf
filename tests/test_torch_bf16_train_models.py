"""``Model.loss`` and its gradients at bfloat16, the configurations' own
dtype, against the reference's, for the first five of the ten reduced
configurations (the other five: ``test_torch_bf16_train_models_b.py``).

The reference's weights are drawn at bf16 and carried over bit for bit;
the batch comes from the port's data pipeline.  Each package runs the loss
and every gradient at bf16 and at float32 from the same weights widened
(exactly).  The bf16 tolerance policy (``ROADMAP.md``, queue C): on the loss
and on every gradient leaf, the port's bf16 error against its float32 run
is at most 2 x the reference's own bf16-vs-float32 error plus 2^-8 x the
leaf's largest |value|; the two float32 runs agree within 1e-4 (abs and
rel, ``test_torch_model_zoo.py``'s tolerance), which ties each package's
float32 run to the other's; and the port's bf16 loss is within 5e-2 x
|loss| of the reference's, as its bf16 logits are held in
``test_torch_bf16.py``.  The reference's largest gap over a leaf, as a share
of the leaf's largest gradient, is what ``chip_smoke.py``'s bf16 learner
parity (card vs CPU) allows twice of at RWKV-6, Phi-3.5-MoE, Qwen3-14B and
DeepSeek-V2-Lite (``PARITY_BF16_GAP``, its batch of 2 x 64 tokens here),
and its bf16 vs float32 loss gap what that parity allows twice of on each
statistic (``PARITY_BF16_LOSS_GAP``).

MoE routing is held apart, as in ``test_torch_bf16.py``: a bf16 rounding can
tip a router's near tie, so every run takes the reference's bf16 expert
choices (recorded by its ``lax.top_k``, forced through ordered callbacks;
the port's through ``moe.route``), and the port's own bf16 choices must
equal the reference's but at near ties.  The reference's loss runs without
remat here, so that each routing call runs once a step (remat changes no
value, only what the backward recomputes).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from jax.experimental import io_callback

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.configs import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro_torch.configs import InputShape, reduced_config
from repro_torch.data import make_batch
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, moe
from repro_torch.tree import tree_leaves

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF16 = ml_dtypes.bfloat16
MODEL_TOL = 5e-2  # port vs reference loss at bf16, x |loss|
FP32_TOL = 1e-4  # port vs reference at float32
NEAR_TIE = 0.1  # a routing flip's two probabilities within this share of the larger
SEQ, BATCH = 64, 2
ALL = sorted(JAX_ARCHITECTURES)
FIRST = ALL[:5]


def _cfg(module, arch: str, dtype: str):
    return dataclasses.replace(module(arch), dtype=dtype)


def _reference(model, params, batch, monkeypatch, forced=None):
    """(loss, gradient leaves as float32 numpy, routing decisions) of the
    reference at ``params``; with ``forced``, each top-k takes that list's
    experts in order."""
    routes = []
    top_k = jax.lax.top_k
    pending = iter(forced or [])

    def record(probs, experts):
        routes.append((np.asarray(probs, np.float32), np.asarray(experts)))

    def recorded_top_k(probs, k):
        seen = jax.lax.stop_gradient(probs)
        if forced is None:
            _, experts = top_k(seen, k)
        else:
            experts = io_callback(lambda _: next(pending)[1].astype(np.int32),
                                  jax.ShapeDtypeStruct(probs.shape[:-1] + (k,), jnp.int32), seen,
                                  ordered=True)
        jax.debug.callback(record, seen, experts, ordered=True)
        return jnp.take_along_axis(probs, experts, axis=-1), experts

    media = batch.get("media_emb")

    def loss(p):
        return model.loss(p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
                          media_emb=None if media is None else jnp.asarray(media), remat=False)[0]

    monkeypatch.setattr(jax.lax, "top_k", recorded_top_k)
    value, grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return (float(value), [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)],
            routes)


def _port(model, params, batch, monkeypatch, forced=None):
    """``_reference`` for the port."""
    routes = []
    route = moe.route
    pending = iter(forced or [])

    def recorded_route(p, x, cfg):
        probs, top_p, top_e = route(p, x, cfg)
        if forced is not None:
            top_e = torch.from_numpy(np.array(next(pending)[1])).long()
            top_p = torch.gather(probs, -1, top_e)
        routes.append((probs.detach().float().numpy(), top_e.numpy()))
        return probs, top_p, top_e

    media = batch.get("media_emb")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    monkeypatch.setattr(moe, "route", recorded_route)
    value, _ = model.loss(params, torch.from_numpy(batch["tokens"]),
                          torch.from_numpy(batch["labels"]),
                          media_emb=None if media is None else torch.from_numpy(media))
    grads = torch.autograd.grad(value, leaves)
    monkeypatch.setattr(moe, "route", route)
    assert value.dtype == torch.float32
    for leaf, g in zip(leaves, grads):
        assert g.dtype == leaf.dtype
    return float(value.detach()), [g.float().numpy() for g in grads], routes


def _flips(ref: list, other: list, arch: str) -> list:
    """Every routing decision of ``other`` that differs from ``ref``'s must
    be a near tie in the reference's probabilities."""
    assert len(other) == len(ref), f"{arch}: {len(other)} routing calls vs {len(ref)}"
    flips = []
    for (probs, experts), (_, experts_o) in zip(ref, other):
        differ = (np.sort(experts, -1) != np.sort(experts_o, -1)).any(-1)
        for idx in zip(*np.nonzero(differ)):
            ranked = np.sort(probs[idx])[::-1]
            k = experts.shape[-1]
            flips.append((float(ranked[k - 1]), float(ranked[k])))
            assert ranked[k - 1] - ranked[k] <= NEAR_TIE * ranked[k - 1], (
                f"{arch}: the port routes a token to other experts than the reference where "
                f"its top-{k} margin is no near tie: {ranked.tolist()}")
    return flips


def check_loss_and_gradients_at_bf16(arch: str, monkeypatch) -> None:
    """The policy above at ``arch``'s reduced configuration; and at the
    card parity's configurations, the reference's largest relative gap
    within ``chip_smoke.PARITY_BF16_GAP``."""
    model_j = JaxModel(_cfg(jax_reduced_config, arch, "bfloat16"))
    params = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    assert np.dtype(BF16) in {a.dtype for a in jax.tree_util.tree_leaves(params)}
    wide = jax.tree_util.tree_map(lambda a: a.astype(np.float32) if a.dtype == BF16 else a, params)
    model_t = Model(_cfg(reduced_config, arch, "bfloat16"))
    batch = make_batch(model_t.cfg, InputShape("t", SEQ, BATCH, "train"), seed=0, step=0)

    loss_j, grads_j, routes = _reference(model_j, params, batch, monkeypatch)
    forced = routes or None
    if forced:  # the port's own choices, then every run on the reference's
        _, _, own = _port(model_t, params_from_numpy(params), batch, monkeypatch)
        _flips(routes, own, arch)
    loss_t, grads_t, _ = _port(model_t, params_from_numpy(params), batch, monkeypatch, forced)
    loss_j32, grads_j32, _ = _reference(JaxModel(_cfg(jax_reduced_config, arch, "float32")), wide,
                                        batch, monkeypatch, forced)
    loss_t32, grads_t32, _ = _port(Model(_cfg(reduced_config, arch, "float32")),
                                   params_from_numpy(wide), batch, monkeypatch, forced)

    names = ["loss"] + ["/".join(str(getattr(k, "key", k)) for k in path)
                        for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    rows = zip(names, [np.float32(loss_t)] + grads_t, [np.float32(loss_j)] + grads_j,
               [np.float32(loss_t32)] + grads_t32, [np.float32(loss_j32)] + grads_j32)
    gaps = []
    for name, t, j, t32, j32 in rows:
        assert all(np.isfinite(x).all() for x in (t, j, t32, j32)), f"{arch} {name}"
        scale = float(np.abs(j32).max())
        if name != "loss" and scale > 0:
            gaps.append(float(np.abs(j - j32).max()) / scale)
        err_port = float(np.abs(t - t32).max())
        err_ref = float(np.abs(j - j32).max())
        err = float(np.abs(t - j).max())
        limit = 2 * err_ref + 2.0 ** -8 * scale
        msg = (f"{arch} {name}: bf16 vs float32: port {err_port:.4e}, reference {err_ref:.4e} "
               f"(the port's limit {limit:.4e}); port vs reference at bf16 {err:.4e}; largest "
               f"|value| {scale:.4e}")
        assert err_port <= limit, msg
        np.testing.assert_allclose(t32, j32, atol=FP32_TOL, rtol=FP32_TOL, err_msg=msg)
        if name == "loss":
            assert err <= MODEL_TOL * scale, msg
    print(f"{arch}: the reference's largest bf16 vs float32 gradient gap {max(gaps):.4f} of a "
          f"leaf's largest gradient")
    if arch in chip_smoke.PARITY_BF16_ARCHS:
        assert max(gaps) <= chip_smoke.PARITY_BF16_GAP
        assert abs(loss_j - loss_j32) <= chip_smoke.PARITY_BF16_LOSS_GAP


@pytest.mark.parametrize("arch", FIRST)
def test_loss_and_gradients_at_bf16_match_reference(arch, monkeypatch):
    check_loss_and_gradients_at_bf16(arch, monkeypatch)
