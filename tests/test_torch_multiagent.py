"""Parity of the PyTorch port's multi-agent slice with the JAX package on the
CPU: ``MultiAgentCartPole``, ``MultiAgentRolloutWorker`` and the PPO+DQN
composition ``build_multi_agent_ppo_dqn`` (paper Figs 11-12).

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"`` and weights cross by ``repro_torch.interop``.
Tolerances: 1e-6 for an env step, 1e-5 for GAE and a loss, 1e-4 for weights
after a learner step (the reference's learner tolerance).  The plan is held
to the reference's own checks (``tests/test_plans.py``): the same result keys
and counter names, and the counters the bulk-synchronous rollouts and the
round-robin union pin (256 steps sampled, 192 trained after 6 results).
"""

import re
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
from repro.rl.env import CartPoleState as JaxCartPoleState
from repro.rl.env import MultiAgentCartPole as JaxMultiAgentCartPole
from repro.rl.policy import ActorCriticPolicy as JaxACPolicy
from repro.rl.policy import DQNPolicy as JaxDQNPolicy
from repro.rl.replay import ReplayBuffer as JaxReplayBuffer
from repro.rl.rollout_worker import MultiAgentRolloutWorker as JaxMAWorker
from repro.rl.sample_batch import SampleBatch as JaxSampleBatch
from repro_torch import prng
from repro_torch.core.actor import ActorPool
from repro_torch.core.operators import StandardizeFields
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm, build_multi_agent_ppo_dqn, fuse_for_each
from repro_torch.interop import params_to_numpy
from repro_torch.kernels import ops
from repro_torch.rl import (
    ActorCriticPolicy,
    DQNPolicy,
    MultiAgentBatch,
    MultiAgentCartPole,
    MultiAgentRolloutWorker,
    ReplayBuffer,
    SampleBatch,
)
from repro_torch.rl.env import CartPoleState
from repro_torch.tree import tree_leaves, tree_map

ENV_TOL = 1e-6
TOL = 1e-5
LEARNER_TOL = 1e-4

MAPPING = {0: "ppo_policy", 1: "ppo_policy", 2: "dqn_policy", 3: "dqn_policy"}
DQN_DROPPED = {"logp", "values", "advantages", "returns"}


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _specs(ppo, dqn):
    return {"ppo_policy": {"policy": ppo(4, 2, loss_kind="ppo"), "algo": "ppo"},
            "dqn_policy": {"policy": dqn(4, 2), "algo": "dqn"}}


def _worker(i=0, rollout_len=8, mapping=MAPPING, seed=6):
    return MultiAgentRolloutWorker(
        MultiAgentCartPole(len(mapping), mapping), _specs(ActorCriticPolicy, DQNPolicy), mapping,
        rollout_len=rollout_len, seed=seed, worker_index=i, device="cpu",
    )


def _jax_worker(i=0, rollout_len=8):
    return JaxMAWorker(
        JaxMultiAgentCartPole(4, MAPPING), _specs(JaxACPolicy, JaxDQNPolicy), MAPPING,
        rollout_len=rollout_len, seed=6, worker_index=i,
    )


# ------------------------------------------------------------------- env
def test_multi_agent_cartpole_step_raw_matches_reference():
    rng = np.random.default_rng(0)
    A = 6
    x = rng.uniform(-2.5, 2.5, A).astype(np.float32)
    x_dot = rng.uniform(-1, 1, A).astype(np.float32)
    theta = rng.uniform(-0.22, 0.22, A).astype(np.float32)
    theta_dot = rng.uniform(-1, 1, A).astype(np.float32)
    t = np.array([0, 5, 198, 199, 17, 3], np.int32)
    actions = rng.integers(0, 2, A)
    mapping = {a: "p" for a in range(A)}
    env_j = JaxMultiAgentCartPole(A, mapping)
    keys = jax.random.split(jax.random.PRNGKey(0), A)
    out_j = jax.vmap(env_j.base.step_raw)(
        JaxCartPoleState(*map(jnp.asarray, (x, x_dot, theta, theta_dot, t))),
        jnp.asarray(actions.astype(np.int32)), keys,
    )
    env_t = MultiAgentCartPole(A, mapping)
    out_t = env_t.step_raw(CartPoleState(*map(torch.from_numpy, (x, x_dot, theta, theta_dot, t))),
                           torch.from_numpy(actions), prng.key(0))
    for got, want in zip(tree_leaves(tuple(out_t[0])) + [out_t[1]],
                         jax.tree_util.tree_leaves(out_j[0]) + [out_j[1]]):
        _close(got.numpy(), want, ENV_TOL)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert (env_t.obs_dim, env_t.num_actions, env_t.policy_mapping) == (
        env_j.obs_dim, env_j.num_actions, env_j.policy_mapping)


def test_multi_agent_cartpole_resets_one_lane_per_agent():
    env = MultiAgentCartPole(4, MAPPING)
    st, obs = env.reset(prng.key(0))
    assert obs.shape == (4, 4) and st.t.shape == (4,)
    assert float(obs.abs().max()) <= 0.05
    st, obs, reward, done = env.step(st, torch.ones(4, dtype=torch.int64), prng.key(1))
    assert obs.shape == (4, 4) and reward.shape == (4,) and done.dtype == torch.bool


# ---------------------------------------------------------------- worker
def test_sample_splits_per_policy_and_drops_dqn_columns():
    w = _worker(rollout_len=8)
    mb = w.sample()
    assert isinstance(mb, MultiAgentBatch) and set(mb.policy_batches) == {"ppo_policy",
                                                                          "dqn_policy"}
    ppo, dqn = mb.policy_batches["ppo_policy"], mb.policy_batches["dqn_policy"]
    common = {"obs", "actions", "rewards", "dones", "next_obs"}
    assert set(ppo) == common | DQN_DROPPED
    assert set(dqn) == common
    for b in (ppo, dqn):
        assert b.count == 8 * 2  # rollout_len x the policy's two agents
        assert b["obs"].shape == (16, 4) and b["next_obs"].shape == (16, 4)
        assert b["actions"].shape == (16,) and b["actions"].dtype == np.int64
    assert mb.count == 32


def test_sample_matches_reference_split_keys_and_shapes():
    got = _worker().sample()
    want = _jax_worker().sample()
    assert set(got.policy_batches) == set(want.policy_batches)
    for pid, b in want.policy_batches.items():
        assert set(got.policy_batches[pid]) == set(b)
        for k in b:
            assert got.policy_batches[pid][k].shape == b[k].shape, (pid, k)


def test_uneven_mapping_splits_each_agents_trace():
    """Three agents on PPO and one on DQN: the columns split along the
    mapping, each agent's length-T trace contiguous (batch-major rows), so
    within a trace the next row's obs is this row's next_obs unless the
    episode ended."""
    mapping = {0: "ppo_policy", 1: "dqn_policy", 2: "ppo_policy", 3: "ppo_policy"}
    T = 5
    mb = _worker(mapping=mapping, rollout_len=T).sample()
    assert mb.policy_batches["ppo_policy"].count == 3 * T
    assert mb.policy_batches["dqn_policy"].count == T
    for b in mb.policy_batches.values():
        for lane in range(b.count // T):
            rows = slice(lane * T, (lane + 1) * T)
            obs, nxt, done = b["obs"][rows], b["next_obs"][rows], b["dones"][rows]
            keep = done[:-1] == 0
            np.testing.assert_array_equal(obs[1:][keep], nxt[:-1][keep])


def test_gae_bootstraps_from_zero_like_reference(monkeypatch):
    """The rollout ends in one GAE over the [T, A] columns through
    ``ops.fused_gae``, bootstrapped from zero (the reference's choice)."""
    import repro_torch.rl.rollout_worker as port_rw

    calls = []
    monkeypatch.setattr(port_rw, "gae", lambda *a, **k: calls.append(a[0].shape) or ops.fused_gae(*a, **k))
    w = _worker(rollout_len=24)
    cols = w._rollout()
    assert calls == [(24, 4)]
    adv_j, ret_j = jax_gae(jnp.asarray(cols["rewards"].numpy()), jnp.asarray(cols["values"].numpy()),
                           jnp.asarray(cols["dones"].numpy()), jnp.zeros(4), 0.99, 0.95)
    _close(cols["advantages"].numpy(), adv_j, TOL, "advantages")
    _close(cols["returns"].numpy(), ret_j, TOL, "returns")
    # A bootstrap from the last obs's value would differ at the last step.
    assert float(cols["values"][-1].abs().max()) > 0


def _learn_batch(w, policy_id, seed):
    """A batch for ``policy_id``: PPO's standardized as the plan does, DQN's
    from a replay buffer (importance weights and batch indices)."""
    batches = [w.sample() for _ in range(4)]
    if policy_id == "ppo_policy":
        mb = StandardizeFields(["advantages"])(MultiAgentBatch.concat_samples(batches))
        return mb.policy_batches["ppo_policy"]
    rb = ReplayBuffer(capacity=512, sample_batch_size=32, learning_starts=32, seed=seed)
    for b in batches:
        rb.add_batch(b.policy_batches["dqn_policy"])
    return rb.replay()


@pytest.mark.parametrize("policy_id", ["ppo_policy", "dqn_policy"])
def test_learn_on_batch_matches_reference_per_policy(policy_id):
    port, ref = _worker(), _jax_worker()
    ref.params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(port.get_weights()))
    ref.target_params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(port.target_params))
    ref.opt_states = {pid: ref.optimizers[pid].init(ref.params[pid]) for pid in ref.params}
    batch = _learn_batch(port, policy_id, seed=1)
    infos_t, infos_j = [], []
    for _ in range(3):
        infos_t.append(port.learn_on_batch(SampleBatch(dict(batch)), policy_id=policy_id))
        infos_j.append(ref.learn_on_batch(JaxSampleBatch(dict(batch)), policy_id=policy_id))
    for it, ij in zip(infos_t, infos_j):
        assert set(it) == set(ij) == ({"loss", "td_error"} if policy_id == "dqn_policy" else {"loss"})
        _close(it["loss"], ij["loss"], TOL, "loss")
        if policy_id == "dqn_policy":
            assert isinstance(it["td_error"], np.ndarray) and it["td_error"].shape == (batch.count,)
            _close(it["td_error"], ij["td_error"], TOL, "td_error")
    for pid in ("ppo_policy", "dqn_policy"):
        got = tree_leaves(params_to_numpy(port.get_weights()[pid]))
        want = jax.tree_util.tree_leaves(ref.params[pid])
        for g, w in zip(got, want):
            _close(g, w, LEARNER_TOL, pid)
    # The other policy did not move.
    other = "dqn_policy" if policy_id == "ppo_policy" else "ppo_policy"
    for g, w in zip(tree_leaves(port.params[other]), tree_leaves(port.target_params[other])):
        assert torch.equal(g, w)


def test_set_weights_copies_and_never_aliases_the_callers_tensors():
    w = _worker()
    own = {pid: tree_leaves(p) for pid, p in w.params.items()}
    given = {"ppo_policy": tree_map(lambda p: p + 1.0, w.get_weights()["ppo_policy"])}
    w.set_weights(given)
    expect = tree_map(lambda p: p.clone(), given["ppo_policy"])
    for p in tree_leaves(given["ppo_policy"]):
        p.add_(5.0)  # the caller changes its dict in place afterwards
    for got, want in zip(tree_leaves(w.params["ppo_policy"]), tree_leaves(expect)):
        assert torch.equal(got, want)
    for pid in own:  # the worker's own tensors, copied into
        assert all(a is b for a, b in zip(tree_leaves(w.params[pid]), own[pid]))
    # get_weights hands out clones: changing them leaves the worker alone.
    out = w.get_weights()
    before = params_to_numpy(w.params)
    for p in tree_leaves(out):
        p.mul_(0.0)
    for a, b in zip(tree_leaves(params_to_numpy(w.params)), tree_leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_update_target_clones_the_dqn_policies_only():
    w = _worker()
    batch = _learn_batch(w, "dqn_policy", seed=2)
    w.learn_on_batch(batch, policy_id="dqn_policy")
    w.learn_on_batch(_learn_batch(w, "ppo_policy", seed=2), policy_id="ppo_policy")
    ppo_target = tree_leaves(w.target_params["ppo_policy"])
    w.update_target()
    for a, b in zip(tree_leaves(w.target_params["dqn_policy"]), tree_leaves(w.params["dqn_policy"])):
        assert torch.equal(a, b) and a is not b
    assert all(a is b for a, b in zip(tree_leaves(w.target_params["ppo_policy"]), ppo_target))
    w.learn_on_batch(batch, policy_id="dqn_policy")
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(w.target_params["dqn_policy"]),
                                                     tree_leaves(w.params["dqn_policy"])))


def test_multi_agent_worker_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiAgentRolloutWorker(MultiAgentCartPole(4, MAPPING), _specs(ActorCriticPolicy, DQNPolicy),
                                MAPPING)


# ------------------------------------------------------------------ plan
def _replay(pool_cls, buffer_cls):
    return pool_cls.from_targets([buffer_cls(capacity=4096, sample_batch_size=16,
                                             learning_starts=32)])


def _shape(result):
    return {"keys": set(result), "episodes": set(result["episodes"]),
            "counters": {k for k in result["counters"] if not k.startswith("bytes_moved/")}}


@pytest.mark.timeout(240)
def test_multi_agent_plan_trains_like_reference(monkeypatch):
    import repro_torch.rl.rollout_worker as port_rw

    calls = []
    monkeypatch.setattr(port_rw, "gae", lambda *a, **k: calls.append(1) or ops.fused_gae(*a, **k))
    kw = dict(ppo_batch_size=64, dqn_target_update_freq=128)
    with JaxAlgorithm.from_plan("multi_agent_ppo_dqn", JaxWorkerSet.create(_jax_worker, 2),
                                _replay(JaxActorPool, JaxReplayBuffer), **kw) as ref:
        want = [ref.train() for _ in range(6)]
    threads_before = set(threading.enumerate())
    rp = _replay(ActorPool, ReplayBuffer)
    algo = Algorithm.from_plan("multi_agent_ppo_dqn", WorkerSet.create(_worker, 2), rp, **kw)
    try:
        got = [algo.train() for _ in range(6)]
        stats = rp[0].sync("stats")
        prios = rp[0].sync("get_state")["priorities"]
    finally:
        algo.stop()
        rp.stop()
    counters = got[-1]["counters"]
    assert counters["num_steps_sampled"] == want[-1]["counters"]["num_steps_sampled"] == 256
    assert counters["num_steps_trained"] == want[-1]["counters"]["num_steps_trained"] == 192
    assert stats["added"] > 0  # the DQN branch stored experience
    # UpdateReplayPriorities moved priorities off the insertion default.
    assert (prios[:stats["size"]] != prios[:stats["size"]].max()).any()
    infos = [r["info"] for r in got if isinstance(r.get("info"), dict)]
    assert any("ppo_policy" in i for i in infos)
    assert any(isinstance(i.get("td_error"), np.ndarray) for i in infos)
    assert all(np.isfinite(r["time_total_s"]) for r in got)
    assert _shape(got[-1]) == _shape(want[-1])
    assert len(calls) * 32 == counters["num_steps_sampled"]  # one GAE a rollout
    left = [t for t in threading.enumerate() if t not in threads_before and t.is_alive()]
    assert not left


def _assert_valid_dot(dot):
    assert dot.startswith('digraph "')
    assert dot.count("{") == dot.count("}") == 1
    declared = set(re.findall(r'^\s*"([^"]+)"\s*\[', dot, re.M))
    for src, dst in re.findall(r'^\s*"([^"]+)"\s*->\s*"([^"]+)"', dot, re.M):
        assert src in declared, f"edge source {src} undeclared"
        assert dst in declared, f"edge target {dst} undeclared"


@pytest.mark.parametrize("fused", [False, True])
def test_to_dot_is_valid_for_the_composition(fused):
    ws = WorkerSet.create(_worker, 2)
    rp = _replay(ActorPool, ReplayBuffer)
    try:
        spec = build_multi_agent_ppo_dqn(ws, rp)
        _assert_valid_dot((fuse_for_each(spec) if fused else spec).to_dot())
    finally:
        ws.stop()
        rp.stop()
