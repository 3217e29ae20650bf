"""Parity of the port's LM pretraining path (``repro_torch.launch.train``)
with the JAX package on the CPU: the optimizer chain, ``Model.loss``, one
learner step, the dataflow's result dict, the CLI and the data pipeline.

Weights are made by the reference and carried over as numpy; batches come
from the data pipeline.  Tolerances: 1e-5 (abs and rel) for the loss and the
optimizer on float32 inputs, 1e-4 for weights after a learner step (the
gradients of a 2-layer model sum over every token in another order).
"""

import dataclasses
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.pipeline as jax_pipeline
from repro import optim as jax_optim
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core.spmd import SPMDLearnerWorker as JaxLearner
from repro.core.spmd import SPMDTrainContext as JaxContext
from repro.launch.mesh import make_local_mesh
from repro.models import Model as JaxModel
from repro_torch import optim
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import InputShape, get_config, reduced_config
from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
from repro_torch.data import TokenPipeline, make_batch, name_digest
from repro_torch.flow import Algorithm
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.tree import tree_leaves

TOL = 1e-5
LEARNER_TOL = 1e-4
ARCHS = ["rwkv6-7b", "phi3.5-moe-42b-a6.6b"]
SEQ, BATCH = 32, 2
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _configs(arch):
    return (
        dataclasses.replace(jax_reduced_config(arch), dtype="float32"),
        dataclasses.replace(reduced_config(arch), dtype="float32"),
    )


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- optimizer
def _opt_pair(max_norm):
    def chain(mod):
        return mod.chain_clip_by_global_norm(
            mod.adamw(mod.linear_warmup_cosine(1e-2, 2, 5), weight_decay=0.1), max_norm=max_norm
        )

    return chain(jax_optim), chain(optim)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])  # clipping active / inactive
def test_adamw_clip_schedule_match_reference_and_in_place_matches_functional(max_norm):
    rng = np.random.default_rng(int(max_norm))
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}} for _ in range(3)]
    opt_j, opt_t = _opt_pair(max_norm)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt, pi = params_from_numpy(params), params_from_numpy(params)  # functional, in place
    sj, st, si = opt_j.init(pj), opt_t.init(pt), opt_t.init(pi)
    for g in grads:
        pj, sj = opt_j.apply(pj, jax.tree_util.tree_map(jnp.asarray, g), sj)
        pt, st = opt_t.apply(pt, params_from_numpy(g), st)
        gi = tree_leaves(params_from_numpy(g))
        si = opt_t.apply_(pi, gi, si)
        assert gi == [None, None]  # each gradient dropped once used
        for a, b, c in zip(tree_leaves(pt), tree_leaves(_numpy(pj)), tree_leaves(pi)):
            _close(a, b, name="functional vs reference")
            torch.testing.assert_close(c, a, rtol=0, atol=0)
    assert st.step == si.step == int(sj.step) == 3
    for a, b in zip(tree_leaves(st.mu) + tree_leaves(st.nu), tree_leaves(si.mu) + tree_leaves(si.nu)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_linear_warmup_cosine_matches_reference():
    jf, tf = jax_optim.linear_warmup_cosine(3e-4, 20, 100), optim.linear_warmup_cosine(3e-4, 20, 100)
    for step in range(0, 130, 7):
        _close(tf(step), jf(jnp.int32(step)), 1e-7, name=f"step {step}")


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_reference(arch):
    cfg_j, cfg_t = _configs(arch)
    params_j = JaxModel(cfg_j).init_params(jax.random.PRNGKey(0))
    batch = make_batch(cfg_t, InputShape("t", SEQ, BATCH, "train"), seed=0, step=0)
    loss_j, parts_j = JaxModel(cfg_j).loss(params_j, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))
    params_t = params_from_numpy(_numpy(params_j))
    loss_t, parts_t = Model(cfg_t).loss(
        params_t, torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["labels"])
    )
    _close(loss_t.detach(), loss_j, name="loss")
    for key in ("nll", "aux"):
        _close(parts_t[key].detach(), parts_j[key], name=key)
    if cfg_t.moe is not None:
        assert float(parts_t["aux"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trips_the_model_trees(arch):
    """The stacked [num_blocks, ...] block leaves, the [num_blocks, E, D, F]
    expert matrices and the RWKV-6 leaves survive one numpy round trip."""
    cfg_j, _ = _configs(arch)
    tree = _numpy(JaxModel(cfg_j).init_params(jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_numpy(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    layer = back["blocks"]["0"]
    if cfg_j.moe is not None:
        e = cfg_j.moe
        assert layer["mlp"]["up"].shape == (cfg_j.num_blocks, e.num_experts, cfg_j.d_model, e.d_ff)
    else:
        assert layer["attn"]["bonus_u"].shape == (cfg_j.num_blocks, cfg_j.d_model // cfg_j.ssm.head_dim,
                                                  cfg_j.ssm.head_dim)


# ------------------------------------------------------------------ learner
@pytest.fixture(scope="module")
def reference_learners():
    """One reference learner per arch (compiled once for the module)."""
    out = {}
    for arch in ARCHS:
        cfg_j, _ = _configs(arch)
        opt = jax_optim.chain_clip_by_global_norm(
            jax_optim.adamw(jax_optim.linear_warmup_cosine(3e-4, 20, 100), weight_decay=0.1),
            max_norm=1.0,
        )
        out[arch] = JaxLearner(JaxContext(cfg_j, opt, make_local_mesh()), seed=0)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_learner_step_matches_reference(arch, reference_learners):
    _, cfg_t = _configs(arch)
    ref = reference_learners[arch]
    learner, _, _, _ = train.make_pretrain(cfg_t, SEQ, BATCH, 1, steps=20, device="cpu")
    learner.set_weights(_numpy(ref.params))
    batch = make_batch(cfg_t, InputShape("t", SEQ, BATCH, "train"), seed=0, step=3)
    info_j = ref.learn_on_batch(batch)
    info_t = learner.learn_on_batch(batch)
    assert set(info_t) == set(info_j) == {"loss", "nll", "aux"}
    for key in info_j:
        _close(info_t[key], info_j[key], LEARNER_TOL, name=key)
    for a, b in zip(tree_leaves(params_to_numpy(learner.get_weights())), tree_leaves(_numpy(ref.params))):
        _close(a, b, LEARNER_TOL, name="weights")


def test_learner_weights_are_copies():
    _, cfg_t = _configs("rwkv6-7b")
    learner = SPMDLearnerWorker(SPMDTrainContext(cfg_t, optim.sgd(1.0), device="cpu"))
    before = learner.get_weights()
    learner.learn_on_batch(make_batch(cfg_t, InputShape("t", 16, 2, "train")))
    moved = [float((a - b.detach()).abs().max()) for a, b in zip(tree_leaves(before), tree_leaves(learner.params))]
    assert max(moved) > 0  # the learner's tensors moved; the clone did not
    learner.set_weights(before)
    for a, b in zip(tree_leaves(before), tree_leaves(learner.params)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    if not torch.cuda.is_available():  # the context defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SPMDTrainContext(cfg_t, optim.sgd(1.0))


# --------------------------------------------------------------------- flow
def test_build_lm_flow_matches_reference_result_keys_and_counters(reference_learners):
    from repro.core.actor import ActorPool as JaxPool
    from repro.core.workers import WorkerSet as JaxWorkerSet
    from repro.data import TokenPipeline as JaxPipeline
    from repro.flow import Algorithm as JaxAlgorithm
    from repro.launch.train import build_lm_flow as jax_build_lm_flow

    arch = "rwkv6-7b"
    cfg_j, cfg_t = _configs(arch)
    shape_j = JaxInputShape("train", SEQ, BATCH, "train")
    ref = reference_learners[arch]
    pipes_j = JaxPool.from_targets([JaxPipeline(cfg_j, shape_j, seed=0, host_id=i, num_hosts=2)
                                    for i in range(2)], name="data")
    workers_j = JaxWorkerSet(ref, pipes_j)
    learner, _, workers_t, spec_t = train.make_pretrain(cfg_t, SEQ, BATCH, 2, steps=20, device="cpu")
    results = []
    for algo in (JaxAlgorithm.from_plan(jax_build_lm_flow(workers_j, pipes_j), workers_j),
                 Algorithm.from_plan(spec_t, workers_t)):
        with algo:
            results.append([algo.train() for _ in range(2)])
    (r1_j, r2_j), (r1_t, r2_t) = results
    assert set(r2_t) == set(r2_j)
    assert set(r2_t["info"]) == set(r2_j["info"]) == {"loss", "nll", "aux"}
    assert set(r2_t["counters"]) == set(r2_j["counters"])
    for r_t, r_j in ((r1_t, r1_j), (r2_t, r2_j)):
        assert r_t["counters"]["num_steps_trained"] == r_j["counters"]["num_steps_trained"]
    assert r2_t["counters"]["num_steps_trained"] == 2 * BATCH
    assert learner.steps == 2
    assert all(np.isfinite(r2_t["info"][k]) for k in r2_t["info"])
    assert abs(r2_t["info"]["nll"] - np.log(cfg_t.vocab_size)) < 0.5


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    ckpt = str(tmp_path / "w.npz")
    train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--device", "cpu", "--smoke", "--steps", "2",
                "--batch", "2", "--seq", "16", "--checkpoint", ckpt])
    out = capsys.readouterr().out
    # The driver trains at the configuration's own dtype, as the reference's.
    cfg = train.train_config("phi3.5-moe-42b-a6.6b", smoke=True)
    assert cfg.dtype == "bfloat16"
    assert f"dtype {cfg.dtype}" in out and f"saved checkpoint to {ckpt}" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(abs(x - np.log(512)) < 0.5 for x in losses)
    # The checkpoint holds every parameter of the model the driver trained.
    like = Model(cfg).init_params(torch.Generator().manual_seed(1))
    restored = restore_pytree(ckpt, like)
    assert [tuple(x.shape) for x in tree_leaves(restored)] == [
        tuple(x.shape) for x in tree_leaves(like)]
    assert all(torch.isfinite(x).all() for x in tree_leaves(restored))


def test_train_cli_dot_prints_the_graph(capsys):
    train.main(["--device", "cpu", "--smoke", "--dot"])
    out = capsys.readouterr().out
    assert "digraph" in out and "SPMDTrainStep" in out and "TokenPipeline" in out


# --------------------------------------------------------------------- data
def test_token_pipeline_matches_reference_with_a_stable_digest(monkeypatch):
    cfg_j, cfg_t = _configs("rwkv6-7b")
    # The reference seeds with abs(hash(name)); give it the port's digest.
    monkeypatch.setattr(jax_pipeline, "hash", name_digest, raising=False)
    shape = (SEQ, 4)
    pipes_t = [TokenPipeline(cfg_t, InputShape("t", *shape, "train"), seed=1, host_id=i, num_hosts=2)
               for i in range(2)]
    pipes_j = [jax_pipeline.TokenPipeline(cfg_j, JaxInputShape("t", *shape, "train"), seed=1,
                                          host_id=i, num_hosts=2) for i in range(2)]
    for _ in range(3):
        for p_t, p_j in zip(pipes_t, pipes_j):
            b_t, b_j = p_t.sample(), p_j.sample()
            assert set(b_t) == set(b_j) == {"tokens", "labels"}
            for key in b_t:
                np.testing.assert_array_equal(b_t[key], b_j[key])


def test_port_batches_are_equal_across_processes():
    code = (
        "import hashlib; from repro_torch.configs import InputShape, get_config; "
        "from repro_torch.data import make_batch; "
        "b = make_batch(get_config('rwkv6-7b'), InputShape('t', 64, 2, 'train'), seed=3, step=5); "
        "print(hashlib.sha256(b['tokens'].tobytes() + b['labels'].tobytes()).hexdigest())"
    )
    # Without PYTHONHASHSEED each process salts str hashes anew, as the
    # reference's hash(cfg.name) seed would see.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    env["PYTHONPATH"] = str(ROOT / "src")
    digests = {
        subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       check=True, timeout=60).stdout.strip()
        for _ in range(2)
    }
    b = make_batch(get_config("rwkv6-7b"), InputShape("t", 64, 2, "train"), seed=3, step=5)
    here = hashlib.sha256(b["tokens"].tobytes() + b["labels"].tobytes()).hexdigest()
    assert digests == {here}
