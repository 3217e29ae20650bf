"""Parity of the PyTorch port's model-based and meta-learning slice with the
JAX package on the CPU: ``ModelBasedWorker`` and ``build_mbpo`` (paper
§2.2), and ``build_maml`` with the workers' ``inner_adapt`` / ``reset_inner``
(Fig A2).

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"`` and weights cross by ``repro_torch.interop``.
Tolerances: 1e-5 for the dynamics loss and the synthetic rollout (obs,
rewards, log-probs, values, advantages, returns), 1e-4 for weights after an
Adam step; the start rows of a synthetic rollout are drawn by the same numpy
code in both packages and held bit for bit.  The synthetic rollout's actions
are injected: the reference samples them from a threefry key.  The plans
are held to the reference's own checks (``tests/test_plans.py``) and to its
result keys and counter names.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.actor import ActorPool as JaxActorPool
from repro.core.workers import WorkerSet as JaxWorkerSet
from repro.flow import Algorithm as JaxAlgorithm
from repro.rl.advantages import gae as jax_gae
from repro.rl.env import CartPole as JaxCartPole
from repro.rl.model_based import ModelBasedWorker as JaxModelBasedWorker
from repro.rl.policy import ActorCriticPolicy as JaxACPolicy
from repro.rl.replay import ReplayBuffer as JaxReplayBuffer
from repro.rl.rollout_worker import RolloutWorker as JaxWorker
from repro.rl.sample_batch import SampleBatch as JaxSampleBatch
from repro_torch.core.actor import ActorPool
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm
from repro_torch.interop import params_to_numpy
from repro_torch.kernels import ops
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    ModelBasedWorker,
    ReplayBuffer,
    RolloutWorker,
    SampleBatch,
)
from repro_torch.tree import tree_leaves

TOL = 1e-5
LEARNER_TOL = 1e-4


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tree))


def _mb_worker(i=0, **kw):
    kw = {"num_envs": 2, "rollout_len": 16, "synth_batch": 16, **kw}
    return ModelBasedWorker(CartPole(), ActorCriticPolicy(4, 2, loss_kind="pg"), algo="pg",
                            seed=21, worker_index=i, device="cpu", **kw)


def _jax_mb_worker(i=0, **kw):
    kw = {"num_envs": 2, "rollout_len": 16, "synth_batch": 16, **kw}
    return JaxModelBasedWorker(JaxCartPole(), JaxACPolicy(4, 2, loss_kind="pg"), algo="pg",
                               seed=21, worker_index=i, **kw)


def _paired(**kw):
    """A port worker and a reference worker on the port's weights: policy,
    dynamics ensemble and fresh Adam states."""
    port, ref = _mb_worker(**kw), _jax_mb_worker(**kw)
    ref.params = _to_jax(port.params)
    ref.dyn_params = [_to_jax(p) for p in port.dyn_params]
    ref.dyn_opt_states = [ref.dyn_opt.init(p) for p in ref.dyn_params]
    return port, ref


def _transitions(n=48, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-0.2, 0.2, (n, 4)).astype(np.float32)
    return {
        "obs": obs,
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": np.ones(n, np.float32),
        "next_obs": (obs + rng.normal(0, 0.02, (n, 4))).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
        "weights": np.ones(n, np.float32),
        "batch_indices": np.arange(n, dtype=np.int64),
    }


# ---------------------------------------------------------------- dynamics
@pytest.mark.parametrize("member", [0, 1])
def test_dyn_loss_matches_reference(member):
    port, ref = _paired()
    b = _transitions(seed=member)
    got = port._dyn_loss(port.dyn_params[member], {k: torch.from_numpy(v) for k, v in b.items()})
    want = ref._dyn_loss(ref.dyn_params[member], {k: jnp.asarray(v) for k, v in b.items()})
    _close(got.detach().numpy(), want, TOL)


def test_train_dynamics_adam_steps_match_reference():
    port, ref = _paired(ensemble_size=3)
    for step in range(3):
        b = _transitions(seed=10 + step)
        info_t = port.train_dynamics(SampleBatch(dict(b)))
        info_j = ref.train_dynamics(JaxSampleBatch(dict(b)))
        assert set(info_t) == set(info_j) == {"dyn_loss"}
        assert isinstance(info_t["dyn_loss"], float)
        _close(info_t["dyn_loss"], info_j["dyn_loss"], TOL, "dyn_loss")
        assert len(port.dyn_losses) == len(ref.dyn_losses) == 3
        _close(port.dyn_losses, ref.dyn_losses, TOL, "dyn_losses")
    for got, want in zip(port.dyn_params, ref.dyn_params):
        for g, w in zip(tree_leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)):
            _close(g, w, LEARNER_TOL, "dyn weights")
    # Each member took its own steps from its own Adam state.
    assert not np.array_equal(params_to_numpy(port.dyn_params[0])[0]["w"],
                              params_to_numpy(port.dyn_params[1])[0]["w"])


def test_ensemble_init_is_seeded_by_the_worker_index():
    a, b, a2 = _mb_worker(0), _mb_worker(1), _mb_worker(0)
    for x, y in zip(tree_leaves(a.dyn_params), tree_leaves(a2.dyn_params)):
        assert torch.equal(x, y)
    assert not torch.equal(a.dyn_params[0][0]["w"], b.dyn_params[0][0]["w"])
    assert not torch.equal(a.dyn_params[0][0]["w"], a.dyn_params[1][0]["w"])
    # scale_last=0.1 on the output layer, zero biases.
    last = a.dyn_params[0][-1]["w"]
    assert last.shape == (64, 5) and float(last.std()) < 0.2
    assert not any(float(layer["b"].abs().max()) for layer in a.dyn_params[0])


# --------------------------------------------------------- synthetic rollout
def test_synth_rollout_core_on_injected_actions_matches_reference():
    """The deterministic core against the reference's ``_dyn_forward``
    stepped by hand with the same actions, its policy's logits and values,
    and ``repro.rl.advantages.gae`` bootstrapped from the last obs's value."""
    port, ref = _paired(synth_rollout_len=6)
    rng = np.random.default_rng(3)
    N, T = 16, 6
    start = rng.uniform(-0.1, 0.1, (N, 4)).astype(np.float32)
    actions = rng.integers(0, 2, (T, N)).astype(np.int64)
    member = 1
    cols = port.synth_rollout(port.params, port.dyn_params[member], torch.from_numpy(start),
                              lambda t, logits: torch.from_numpy(actions[t]))

    obs = jnp.asarray(start)
    want = {k: [] for k in ("obs", "rewards", "logp", "values", "next_obs")}
    for t in range(T):
        logits, value = ref.policy.logits_value(ref.params, obs)
        a = jnp.asarray(actions[t].astype(np.int32))
        logp = jax.nn.log_softmax(logits)[jnp.arange(N), a]
        d_obs, rew = ref._dyn_forward(ref.dyn_params[member], obs, a)
        for k, v in (("obs", obs), ("rewards", rew), ("logp", logp), ("values", value),
                     ("next_obs", obs + d_obs)):
            want[k].append(v)
        obs = obs + d_obs
    want = {k: jnp.stack(v) for k, v in want.items()}
    adv, ret = jax_gae(want["rewards"], want["values"], jnp.zeros((T, N)),
                       ref.policy.value(ref.params, obs), ref.gamma, ref.lam)
    want.update(advantages=adv, returns=ret)
    for k, v in want.items():
        _close(cols[k].numpy(), v, TOL, k)
    np.testing.assert_array_equal(cols["actions"].numpy(), actions)
    assert not cols["dones"].any()


def _replayed(n=64, seed=5):
    b = _transitions(n, seed)
    return b, SampleBatch(dict(b)), JaxSampleBatch(dict(b))


def _start_rows(batch, N, T):
    return batch["obs"].reshape(N, T, -1)[:, 0]


def test_synthesize_start_rows_are_the_references_bit_for_bit(monkeypatch):
    """The start rows come from numpy's ``default_rng(len(dyn_losses))``
    in both packages: seed 0 before any dynamics training, then
    ``ensemble_size`` after every one, so each call draws the same rows (a
    quirk of the reference, reproduced)."""
    port, ref = _paired(synth_batch=16, synth_rollout_len=4)
    b, sb_t, sb_j = _replayed()
    firsts = []
    for trained in (False, True, True):
        if trained:
            port.train_dynamics(sb_t)
            ref.train_dynamics(sb_j)
        out_t, out_j = port.synthesize(sb_t), ref.synthesize(sb_j)
        assert out_t.count == out_j.count == 16 * 4
        assert set(out_t) == set(out_j)
        got = _start_rows(out_t, 16, 4)
        np.testing.assert_array_equal(got, _start_rows(out_j, 16, 4))
        idx = np.random.default_rng(len(port.dyn_losses)).integers(0, 64, 16)
        np.testing.assert_array_equal(got, b["obs"][idx])
        firsts.append(got)
    assert not np.array_equal(firsts[0], firsts[1])
    np.testing.assert_array_equal(firsts[1], firsts[2])


def test_synthesize_ends_in_fused_gae_and_emits_an_on_policy_batch(monkeypatch):
    import repro_torch.rl.model_based as port_mb

    calls = []
    monkeypatch.setattr(port_mb, "gae", lambda *a, **k: calls.append(a[0].shape) or ops.fused_gae(*a, **k))
    port = _mb_worker(synth_batch=128, synth_rollout_len=8)
    _, sb, _ = _replayed(n=256)
    out = port.synthesize(sb)
    assert calls == [(8, 128)]
    assert out.count == 128 * 8
    assert set(out) == {"obs", "actions", "rewards", "dones", "logp", "values", "next_obs",
                        "advantages", "returns"}
    assert not out["dones"].any() and np.isfinite(out["returns"]).all()
    # A synthetic batch trains the policy as a real one does.
    assert np.isfinite(port.learn_on_batch(out)["loss"])


def test_synthesize_draws_the_member_from_the_workers_generator():
    port = _mb_worker(ensemble_size=2, synth_batch=8, synth_rollout_len=2)
    _, sb, _ = _replayed()
    core, seen = port.synth_rollout, []

    def recording(policy_params, dyn_params, start, pick):
        seen.append(next(i for i, m in enumerate(port.dyn_params) if m is dyn_params))
        return core(policy_params, dyn_params, start, pick)

    port.synth_rollout = recording
    for _ in range(16):
        port.synthesize(sb)
    assert set(seen) == {0, 1}


def test_model_based_worker_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelBasedWorker(CartPole(), ActorCriticPolicy(4, 2), algo="pg")


# -------------------------------------------------------------------- plans
def _shape(result):
    return {"keys": set(result), "episodes": set(result["episodes"]),
            "counters": {k for k in result["counters"] if not k.startswith("bytes_moved/")}}


def _replay(pool_cls, buffer_cls):
    return pool_cls.from_targets([buffer_cls(capacity=4096, sample_batch_size=64,
                                             learning_starts=64)])


@pytest.mark.timeout(240)
def test_mbpo_plan_trains_like_reference():
    with JaxAlgorithm.from_plan("mbpo", JaxWorkerSet.create(_jax_mb_worker, 2),
                                _replay(JaxActorPool, JaxReplayBuffer)) as ref:
        want = [ref.train() for _ in range(6)]
    threads_before = set(threading.enumerate())
    ws = WorkerSet.create(_mb_worker, 2)
    rp = _replay(ActorPool, ReplayBuffer)
    algo = Algorithm.from_plan("mbpo", ws, rp, own_workers=False)
    try:
        got = [algo.train() for _ in range(6)]
    finally:
        algo.stop()
        rp.stop()
    lw = ws.local_worker()
    ws.stop()
    assert got[-1]["counters"]["num_steps_trained"] > 0
    assert lw.dyn_losses, "dynamics model never trained"
    assert len(lw.dyn_losses) == 2 and all(np.isfinite(v) for v in lw.dyn_losses)
    assert all(np.isfinite(r["info"]["loss"]) for r in got if r["info"])
    assert _shape(got[-1]) == _shape(want[-1])
    assert set(got[-1]["info"]) == set(want[-1]["info"])
    assert not [t for t in threading.enumerate() if t not in threads_before and t.is_alive()]


# --------------------------------------------------------------------- MAML
def _pg_worker(i, device="cpu"):
    return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2, loss_kind="pg", rollout_len=16),
                         algo="pg", num_envs=2, rollout_len=16, seed=3, worker_index=i,
                         device=device)


def _jax_pg_worker(i):
    return JaxWorker(JaxCartPole(), JaxACPolicy(4, 2, loss_kind="pg", rollout_len=16), algo="pg",
                     num_envs=2, rollout_len=16, seed=3, worker_index=i)


def test_inner_adapt_steps_the_workers_own_weights_and_reset_inner_keeps_them():
    w = _pg_worker(0)
    meta = w.get_weights()
    own = tree_leaves(w.params)
    w.inner_adapt(w.sample())
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(w.params), tree_leaves(meta)))
    w.set_weights(meta)  # TrainOneStep's broadcast
    w.reset_inner()
    for a, b in zip(tree_leaves(w.params), tree_leaves(meta)):
        assert torch.equal(a, b)
    assert not any(a is b for a, b in zip(tree_leaves(w.params), tree_leaves(meta)))
    assert not any(a is b for a, b in zip(tree_leaves(w.params), own))  # rebound by the step


@pytest.mark.timeout(240)
def test_maml_plan_leaves_every_worker_on_the_meta_weights():
    """After each iteration the remote workers hold the local worker's
    weights bit for bit (the broadcast copies into their own tensors, over
    their inner adaptation), and the counters are the reference's."""
    with JaxAlgorithm.from_plan("maml", JaxWorkerSet.create(_jax_pg_worker, 2),
                                inner_steps=1) as ref:
        want = [ref.train() for _ in range(2)]
    calls = {"inner_adapt": 0, "reset_inner": 0}
    lock = threading.Lock()

    def counted_worker(i):
        w = _pg_worker(i)
        for name in calls:
            def counted(*a, _f=getattr(w, name), _n=name):
                with lock:
                    calls[_n] += 1
                return _f(*a)
            setattr(w, name, counted)
        return w

    ws = WorkerSet.create(counted_worker, 2)
    try:
        with Algorithm.from_plan("maml", ws, own_workers=False, inner_steps=1) as algo:
            got = []
            for _ in range(2):
                got.append(algo.train())
                local = tree_leaves(params_to_numpy(ws.local_worker().get_weights()))
                for actor in ws.remote_workers():
                    remote = tree_leaves(params_to_numpy(actor.sync("get_weights")))
                    for a, b in zip(local, remote):
                        np.testing.assert_array_equal(a, b)
    finally:
        ws.stop()
    assert calls == {"inner_adapt": 4, "reset_inner": 4}  # 2 iterations x 2 workers
    ctr = got[-1]["counters"]
    assert ctr["num_steps_trained"] == want[-1]["counters"]["num_steps_trained"] == 2 * 2 * 32
    assert _shape(got[-1]) == _shape(want[-1])
    assert set(got[-1]["info"]) == set(want[-1]["info"])
