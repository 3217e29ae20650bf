"""Durability of the PyTorch port, on the CPU.

* ``repro_torch.checkpoint``: a ``.npz`` written by the JAX package's
  ``save_pytree`` restores in the port to the same weights, and the
  reverse; a restore keeps the template's ``requires_grad`` or copies into
  the template's own tensors;
* the port-side copies of ``tests/test_algorithm_checkpoint.py`` (a DQN
  Algorithm restored mid-stream with its counters, replay state and weights;
  a bare ``.npz`` restoring weights only; the vectorized workers' env state
  and lane keys surviving ``save``/``restore`` so the next rollout is
  bit-identical; the worker and replay state round trips) and of
  ``tests/test_durability.py`` (a reduced qwen3-14b learner restarted from a
  checkpoint gives the same losses within 1e-5; replay state is
  discardable);
* ``launch/train.py --checkpoint`` writes a file ``restore_pytree`` reads;
* each eager plan shim of ``repro_torch.core.plans`` yields a result.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import repro.rl as jrl
import repro_torch.core as c
from repro.checkpoint import restore_pytree as jax_restore_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import InputShape, reduced_config
from repro_torch.core.actor import ActorPool
from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
from repro_torch.core.workers import WorkerSet
from repro_torch.data import make_batch
from repro_torch.flow import Algorithm
from repro_torch.interop import params_to_numpy
from repro_torch.launch import train
from repro_torch.optim import adamw
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    DQNPolicy,
    DummyPolicy,
    ModelBasedWorker,
    MultiAgentCartPole,
    MultiAgentRolloutWorker,
    Pendulum,
    ReplayBuffer,
    RolloutWorker,
    SACPolicy,
    StubEnv,
    VectorizedRolloutWorker,
)
from repro_torch.rl.rollout_worker import EPS_STRIDE
from repro_torch.rl.sample_batch import SampleBatch
from repro_torch.tree import tree_leaves

RESTART_RTOL = 1e-5  # tests/test_durability.py's tolerance


# ---------------------------------------------------------------- pytrees
def test_a_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    pol_j = jrl.ActorCriticPolicy(4, 2, hidden=(16, 8))
    params_j = pol_j.init_params(jax.random.PRNGKey(0))
    ref_file, port_file = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jax_save_pytree(ref_file, params_j)
    template = ActorCriticPolicy(4, 2, hidden=(16, 8)).init_params(torch.Generator().manual_seed(5))
    restored = restore_pytree(ref_file, template)
    for got, want in zip(tree_leaves(restored), jax.tree_util.tree_leaves(params_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    save_pytree(port_file, restored)
    back = jax_restore_pytree(port_file, params_j)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params_j)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with np.load(port_file) as port, np.load(ref_file) as ref:
        assert sorted(port.files) == sorted(ref.files)


def test_restore_keeps_requires_grad_or_copies_into_the_template(tmp_path):
    cfg = reduced_config("qwen3-14b")
    ctx = SPMDTrainContext(cfg, adamw(1e-3), device="cpu")
    params, opt = ctx.init(seed=0)
    path = str(tmp_path / "lm.npz")
    save_pytree(path, {"params": params, "opt": opt})
    fresh_params, fresh_opt = ctx.init(seed=1)
    own = tree_leaves(fresh_params)
    state = restore_pytree(path, {"params": fresh_params, "opt": fresh_opt})
    for got, want, tmpl in zip(tree_leaves(state["params"]), tree_leaves(params), own):
        assert got is tmpl and torch.equal(got, want) and got.requires_grad
    assert type(state["opt"]) is type(opt) and state["opt"].step == opt.step
    for got, want in zip(tree_leaves(state["opt"].mu), tree_leaves(opt.mu)):
        assert torch.equal(got, want)


# ------------------------------------------ tests/test_algorithm_checkpoint.py
def dqn_ws(n=1):
    def mk(i):
        return RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=2, rollout_len=8,
                             seed=11, worker_index=i, epsilon=0.3, device="cpu")

    return WorkerSet.create(mk, n)


def replay_pool(n=2):
    return ActorPool.from_targets(
        [ReplayBuffer(capacity=2048, sample_batch_size=32, learning_starts=64, seed=5)
         for _ in range(n)]
    )


def make_algo():
    ws, rp = dqn_ws(), replay_pool()
    return Algorithm.from_plan("dqn", ws, rp, target_update_freq=128), ws, rp


@pytest.mark.timeout(240)
def test_save_restore_mid_stream_resumes_identically(tmp_path):
    algo, ws, rp = make_algo()
    for _ in range(4):
        result = algo.train()
    path = str(tmp_path / "mid.npz")
    algo.save(path)
    saved_counters = dict(result["counters"])
    saved_replay_stats = [a.sync("stats") for a in rp]
    algo.train()
    assert algo._it.metrics.counters != saved_counters

    algo2, ws2, rp2 = make_algo()
    algo2.restore(path)
    for k, v in saved_counters.items():
        assert algo2._it.metrics.counters[k] == v, k
    for a2, stats in zip(rp2, saved_replay_stats):
        assert a2.sync("stats") == stats
    with open(path + ".state.pkl", "rb") as f:
        sidecar = pickle.load(f)
    for ckpt_state, a2 in zip(sidecar["replay"], rp2):
        ref = ReplayBuffer(capacity=2048, sample_batch_size=32, learning_starts=64)
        ref.set_state(ckpt_state)
        b_ref, b2 = ref.replay(), a2.sync("replay")
        if b_ref is None:
            assert b2 is None
        else:
            np.testing.assert_array_equal(b_ref["batch_indices"], b2["batch_indices"])

    algo.restore(path)  # rewind the original too
    w1 = tree_leaves(ws.local_worker().get_weights())
    w2 = tree_leaves(ws2.local_worker().get_weights())
    wr = tree_leaves(ws2.remote_workers()[0].sync("get_weights"))
    for a, b, r in zip(w1, w2, wr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6)
    res = algo2.train()
    assert res["counters"]["num_steps_sampled"] > saved_counters["num_steps_sampled"]
    algo.stop()
    algo2.stop()


def test_restore_without_sidecar_is_weights_only(tmp_path):
    algo, ws, rp = make_algo()
    algo.train()
    path = str(tmp_path / "bare.npz")
    algo.save(path)
    os.remove(path + ".state.pkl")
    counters_before = dict(algo._it.metrics.counters)
    algo.restore(path)
    assert dict(algo._it.metrics.counters) == counters_before
    algo.stop()


def test_restore_into_another_replay_topology_raises(tmp_path):
    algo, ws, rp = make_algo()
    algo.train()
    path = str(tmp_path / "two.npz")
    algo.save(path)
    algo.stop()
    ws3 = dqn_ws()
    algo3 = Algorithm.from_plan("dqn", ws3, replay_pool(3), target_update_freq=128)
    with pytest.raises(ValueError, match="replay actors"):
        algo3.restore(path)
    algo3.stop()


def make_vec_ckpt_worker(i):
    # rollout_len 7 against horizon 6: after any whole number of samples the
    # lanes sit mid-episode, so checkpoints capture nontrivial reset state.
    return VectorizedRolloutWorker(StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
                                   num_envs=3, rollout_len=7, seed=31, worker_index=i,
                                   device="cpu")


def make_vec_algo():
    ws = WorkerSet.create(make_vec_ckpt_worker, 2)
    return Algorithm.from_plan("ppo", ws, train_batch_size=42, num_sgd_iter=1,
                               own_workers=True), ws


@pytest.mark.timeout(240)
def test_vector_env_state_and_lane_rng_survive_checkpoint(tmp_path):
    algo, ws = make_vec_algo()
    for _ in range(3):
        algo.train()
    path = str(tmp_path / "vec.npz")
    algo.save(path)
    with open(path + ".state.pkl", "rb") as f:
        sidecar = pickle.load(f)
    assert "local_worker" in sidecar
    assert set(sidecar["remote_workers"]) == {"rollout-1", "rollout-2"}
    saved = sidecar["remote_workers"]["rollout-1"]
    assert np.any(np.asarray(saved["vstate"].ep_len) > 0)
    assert np.any(np.asarray(saved["vstate"].eps_count) > 0)

    ref = [ws.remote_workers()[0].sync("sample") for _ in range(2)]
    algo2, ws2 = make_vec_algo()
    fresh = ws2.remote_workers()[0].sync("sample")
    algo2.restore(path)
    got = [ws2.remote_workers()[0].sync("sample") for _ in range(2)]
    assert not all(np.array_equal(fresh[k], ref[0][k]) for k in ref[0]), \
        "fresh worker already matched; restore proves nothing"
    for i, (a, b) in enumerate(zip(ref, got)):
        assert set(a.keys()) == set(b.keys())
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"round {i}: {k}")
    restored_counts = got[0]["eps_id"] % EPS_STRIDE
    assert restored_counts.min() >= np.asarray(saved["vstate"].eps_count).min()
    algo.stop()
    algo2.stop()


def test_vector_worker_state_roundtrip_unit():
    w = make_vec_ckpt_worker(1)
    w.sample()
    state = w.get_state()
    nxt = w.sample()
    w2 = make_vec_ckpt_worker(1)
    w2.set_state(state)
    nxt2 = w2.sample()
    for k in nxt:
        np.testing.assert_array_equal(nxt[k], nxt2[k], err_msg=k)
    assert torch.equal(w.act_rng, w2.act_rng)
    assert torch.equal(w.vstate.rng, w2.vstate.rng)
    assert torch.equal(w._key, w2._key)


def test_replay_state_roundtrip_unit():
    buf = ReplayBuffer(capacity=256, sample_batch_size=16, learning_starts=16, seed=3)
    for i in range(4):
        buf.add_batch(SampleBatch({"obs": np.arange(16.0) + i, "rewards": np.ones(16)}))
    state = buf.get_state()
    buf2 = ReplayBuffer(capacity=256, sample_batch_size=16, learning_starts=16, seed=99)
    buf2.set_state(state)
    assert buf2.stats() == buf.stats()
    b1, b2 = buf.replay(), buf2.replay()
    for k in ("batch_indices", "obs", "weights"):
        np.testing.assert_array_equal(b1[k], b2[k])


def test_non_vectorized_worker_state_roundtrip_unit():
    """The non-vectorized worker's chain rides its state too (the
    reference's ``"key"``), so a restored worker's next rollout is
    bit-identical."""

    def mk():
        return RolloutWorker(Pendulum(), SACPolicy(3, 1, hidden=(16, 16)), algo="sac",
                             num_envs=3, rollout_len=5, seed=2, worker_index=1, device="cpu")

    w = mk()
    w.learn_on_batch(w.sample())
    state = w.get_state()
    nxt = w.sample()
    w2 = mk()
    w2.set_weights(w.get_weights())
    w2.set_state(state)
    nxt2 = w2.sample()
    for k in nxt:
        np.testing.assert_array_equal(nxt[k], nxt2[k], err_msg=k)


# ------------------------------------------------- tests/test_durability.py
def _learner():
    cfg = reduced_config("qwen3-14b")
    return cfg, SPMDLearnerWorker(SPMDTrainContext(cfg, adamw(1e-3), device="cpu"), seed=0)


@pytest.mark.timeout(240)
def test_checkpoint_restart_is_deterministic(tmp_path):
    cfg, lw = _learner()
    shape = InputShape("t", 32, 2, "train")
    for s in range(2):
        lw.learn_on_batch(make_batch(cfg, shape, seed=0, step=s))
    ck = os.path.join(tmp_path, "ck.npz")
    save_pytree(ck, {"params": lw.params, "opt": lw.opt_state})
    ref = [lw.learn_on_batch(make_batch(cfg, shape, seed=0, step=s))["loss"] for s in (2, 3)]

    cfg2, lw2 = _learner()
    state = restore_pytree(ck, {"params": lw2.params, "opt": lw2.opt_state})
    lw2.params, lw2.opt_state = state["params"], state["opt"]
    out = [lw2.learn_on_batch(make_batch(cfg2, shape, seed=0, step=s))["loss"] for s in (2, 3)]
    np.testing.assert_allclose(out, ref, rtol=RESTART_RTOL)


@pytest.mark.timeout(240)
def test_replay_state_is_discardable():
    def mk(i):
        return RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=2, rollout_len=8,
                             seed=9, worker_index=i, device="cpu")

    ws = c.WorkerSet.create(mk, 1)
    rp = ActorPool.from_targets([ReplayBuffer(capacity=1024, sample_batch_size=16,
                                              learning_starts=32)])
    c.dqn_plan(ws, rp, target_update_freq=64).take(3)
    rp.stop()
    rp2 = ActorPool.from_targets([ReplayBuffer(capacity=1024, sample_batch_size=16,
                                               learning_starts=32)])
    res = c.dqn_plan(ws, rp2, target_update_freq=64).take(3)
    assert res[-1]["counters"]["num_steps_trained"] > 0
    ws.stop()
    rp2.stop()


# ----------------------------------------------------------- the driver
def test_train_cli_checkpoint_restores(tmp_path, capsys):
    ckpt = str(tmp_path / "qwen3.npz")
    train.main(["--device", "cpu", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                "--checkpoint", ckpt])
    assert "qwen3-14b-smoke" in capsys.readouterr().out  # the reference driver's default arch
    ctx = SPMDTrainContext(train.train_config("qwen3-14b", smoke=True), adamw(1e-3), device="cpu")
    like, _ = ctx.init(seed=7)
    before = [x.clone() for x in tree_leaves(like)]
    restored = restore_pytree(ckpt, like)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), before))
    assert all(torch.isfinite(x).all() for x in tree_leaves(restored))
    # ... and the JAX package reads the same file into its own layout (the
    # driver's bf16 leaves widened to float32 in the file, exactly).
    back = jax_restore_pytree(ckpt, params_to_numpy(like))
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().float().numpy())


# ------------------------------------------------------------ plan shims
def _pg(i):
    return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), rollout_len=8),
                         algo="pg", num_envs=2, rollout_len=8, seed=1, worker_index=i,
                         device="cpu")


def _ppo(i):
    return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="ppo"),
                         algo="ppo", num_envs=2, rollout_len=8, seed=1, worker_index=i,
                         device="cpu")


def _vtrace(i):
    return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="vtrace",
                                                       rollout_len=8),
                         algo="vtrace", num_envs=2, rollout_len=8, seed=1, worker_index=i,
                         device="cpu")


def _dqn(i):
    return RolloutWorker(CartPole(), DQNPolicy(4, 2, hidden=(16, 16)), algo="dqn", num_envs=2,
                         rollout_len=8, seed=1, worker_index=i, device="cpu")


def _sac(i):
    return RolloutWorker(Pendulum(), SACPolicy(3, 1, hidden=(16, 16)), algo="sac", num_envs=2,
                         rollout_len=8, seed=1, worker_index=i, device="cpu")


def _mbpo(i):
    return ModelBasedWorker(CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16)), algo="pg",
                            num_envs=2, rollout_len=8, synth_batch=16, seed=1, worker_index=i,
                            device="cpu")


def _multi_agent(i):
    mapping = {0: "ppo_policy", 1: "dqn_policy"}
    specs = {"ppo_policy": {"policy": ActorCriticPolicy(4, 2, loss_kind="ppo"), "algo": "ppo"},
             "dqn_policy": {"policy": DQNPolicy(4, 2), "algo": "dqn"}}
    return MultiAgentRolloutWorker(MultiAgentCartPole(2, mapping), specs, mapping, rollout_len=8,
                                   seed=1, worker_index=i, device="cpu")


SHIMS = {
    "a3c_plan": (_pg, False, {}),
    "a2c_plan": (_pg, False, {}),
    "ppo_plan": (_ppo, False, dict(train_batch_size=32, num_sgd_iter=1, sgd_minibatch_size=16)),
    "dqn_plan": (_dqn, True, dict(target_update_freq=32)),
    "apex_plan": (_dqn, True, dict(target_update_freq=32)),
    "impala_plan": (_vtrace, False, dict(train_batch_size=16)),
    "sac_plan": (_sac, True, {}),
    "maml_plan": (_pg, False, {}),
    "appo_plan": (_ppo, False, dict(train_batch_size=16)),
    "mbpo_plan": (_mbpo, True, {}),
    "multi_agent_ppo_dqn_plan": (_multi_agent, True, dict(ppo_batch_size=16)),
}


def test_the_shims_are_the_references():
    import repro.core.plans as jax_plans

    assert sorted(SHIMS) == sorted(jax_plans.__all__) == sorted(c.plans.__all__)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("shim", sorted(SHIMS))
def test_plan_shim_yields_a_result(shim):
    factory, replay, kw = SHIMS[shim]
    ws = WorkerSet.create(factory, 2)
    rp = (ActorPool.from_targets([ReplayBuffer(capacity=1024, sample_batch_size=16,
                                               learning_starts=16)]) if replay else None)
    it = getattr(c, shim)(ws, rp, **kw) if replay else getattr(c, shim)(ws, **kw)
    try:
        result = next(iter(it))
        assert {"counters", "info", "episodes"} <= set(result)
        assert sum(v for k, v in result["counters"].items() if k.startswith("num_steps")) > 0
        assert hasattr(it, "flow")
    finally:
        it.flow.stop()
        ws.stop()
        if rp is not None:
            rp.stop()
