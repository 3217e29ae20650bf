"""Parity of the PyTorch port's off-policy and gradient slice with the JAX
package on the CPU: Pendulum and StubEnv, the replay buffer, the DQN, SAC
and Dummy policies, the workers' ``algo="dqn"``/``"sac"``, and the A2C, A3C,
DQN, Ape-X and SAC plans.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``.  Tolerances: 1e-6 for an env step, bitwise
for the replay buffer (both packages run the same numpy code), 1e-5 for a
loss and its aux and 1e-4 for its gradients and for weights after a learner
step (the reference's learner tolerance).  SAC's losses get the reference's
own noise (``jax.random.normal`` of the two keys its loss splits).  The
plans are held on behaviour: the same result keys and counter names as the
reference under the same plan.  Only A2C and A3C reach a kernel (GAE at the
end of every rollout); on a GPU ``chip_smoke.py`` holds it there.
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
from repro.rl.env import Pendulum as JaxPendulum
from repro.rl.env import PendulumState as JaxPendulumState
from repro.rl.env import StubEnv as JaxStubEnv
from repro.rl.env import StubEnvState as JaxStubEnvState
from repro.rl.policy import ActorCriticPolicy as JaxACPolicy
from repro.rl.policy import DQNPolicy as JaxDQNPolicy
from repro.rl.policy import DummyPolicy as JaxDummyPolicy
from repro.rl.policy import SACPolicy as JaxSACPolicy
from repro.rl.replay import ReplayBuffer as JaxReplayBuffer
from repro.rl.rollout_worker import RolloutWorker as JaxWorker
from repro.rl.sample_batch import SampleBatch as JaxSampleBatch
from repro.rl.env import CartPole as JaxCartPole
from repro_torch import prng
from repro_torch.core.actor import ActorPool
from repro_torch.core.metrics import NUM_SAMPLES_DROPPED
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm, build_a3c
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    DQNPolicy,
    DummyPolicy,
    Pendulum,
    ReplayBuffer,
    RolloutWorker,
    SACPolicy,
    SampleBatch,
    StubEnv,
    VectorEnv,
    VectorizedRolloutWorker,
)
from repro_torch.rl.env import PendulumState, StubEnvState
from repro_torch.tree import tree_leaves, tree_map

ENV_TOL = 1e-6
TOL = 1e-5
LEARNER_TOL = 1e-4


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _tree_close(got, want, tol=TOL):
    got_l = tree_leaves(params_to_numpy(got))
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close(g, w, tol)


def _torch_keys(keys):
    """JAX's uint32 keys as the port's int64 keys."""
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def _jax_params(policy, seed):
    return jax.tree_util.tree_map(np.asarray, policy.init_params(jax.random.PRNGKey(seed)))


# ------------------------------------------------------------------- envs
def test_pendulum_step_raw_matches_reference():
    """Angles on both sides of +-pi and far past it (the floor modulo), the
    torque clip, the speed clip and the step horizon."""
    theta = np.array([0.0, 3.0, -3.0, 3.3, -3.3, 7.0, -7.5, -12.0, 1.0], np.float32)
    theta_dot = np.array([0.0, 1.0, -1.0, 7.9, -7.9, 0.5, -0.2, 3.0, 0.0], np.float32)
    t = np.array([0, 5, 5, 10, 10, 198, 199, 0, 100], np.int32)
    actions = np.array([[0.0], [0.5], [-0.5], [1.5], [-1.5], [1.0], [-1.0], [0.2], [0.9]],
                       np.float32)
    env_j = JaxPendulum()
    st_j = JaxPendulumState(*map(jnp.asarray, (theta, theta_dot, t)))
    keys = jax.random.split(jax.random.PRNGKey(0), len(t))
    out_j = jax.vmap(env_j.step_raw)(st_j, jnp.asarray(actions), keys)
    st_t = PendulumState(*map(torch.from_numpy, (theta, theta_dot, t)))
    out_t = Pendulum().step_raw(st_t, torch.from_numpy(actions), _torch_keys(keys))
    for name, got, want in zip(("state", "obs", "reward"), out_t[:3], out_j[:3]):
        for g, w in zip(jax.tree_util.tree_leaves(tuple(got) if name == "state" else got),
                        jax.tree_util.tree_leaves(want)):
            _close(g.numpy(), w, ENV_TOL, name)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert out_t[4].numpy().tolist() == [False] * 5 + [False, True, False, False]


def test_stub_env_step_raw_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(-4.5, 4.5, (8, 4)).astype(np.float32)
    x[0, 0], x[1, 0] = 3.95, -3.95  # cross the threshold this step
    t = np.array([0, 3, 15, 15, 7, 14, 2, 15], np.int32)
    actions = np.array([1, 0, 1, 0, 1, 1, 0, 0], np.int32)
    env_j = JaxStubEnv()
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    out_j = jax.vmap(env_j.step_raw)(
        JaxStubEnvState(jnp.asarray(x), jnp.asarray(t)), jnp.asarray(actions), keys
    )
    out_t = StubEnv().step_raw(StubEnvState(torch.from_numpy(x), torch.from_numpy(t)),
                               torch.from_numpy(actions).long(), _torch_keys(keys))
    _close(out_t[0].x.numpy(), out_j[0].x, ENV_TOL, "x")
    np.testing.assert_array_equal(out_t[0].t.numpy(), np.asarray(out_j[0].t))
    _close(out_t[1].numpy(), out_j[1], ENV_TOL, "obs")
    _close(out_t[2].numpy(), out_j[2], ENV_TOL, "reward")
    terminated, truncated = out_t[3].numpy(), out_t[4].numpy()
    np.testing.assert_array_equal(terminated, np.asarray(out_j[3]))
    np.testing.assert_array_equal(truncated, np.asarray(out_j[4]))
    # Both kinds of end occur, and a lane that terminates at the horizon is
    # not also truncated.
    assert terminated.any() and truncated.any() and not (terminated & truncated).any()


@pytest.mark.parametrize("env_cls", [StubEnv, Pendulum, CartPole])
def test_env_step_auto_reset_takes_whole_rows(env_cls):
    """``Env.step`` at num_envs = 4: lanes that ended take their reset state
    whole, the others keep the stepped state whole.  A ``[4]`` done mask
    against StubEnv's ``[4, 4]`` field broadcasts across columns unless it is
    reshaped to the field's rank."""
    env, n = env_cls(), 4
    state, _ = env.reset(prng.split(prng.key(1), n))
    state = type(state)(*state[:-1], torch.tensor([env.max_steps - 1, 0, env.max_steps - 1, 3],
                                                  dtype=torch.int32))
    action = torch.zeros((n, 1)) if env_cls is Pendulum else torch.tensor([1, 0, 1, 0])
    step_keys = prng.split(prng.key(7), n)
    stepped, stepped_obs, _, _, _ = env.step_raw(state, action, step_keys)
    reset_st, reset_obs = env.reset(step_keys)
    new, obs, _, done = env.step(state, action, step_keys)
    assert done.tolist() == [True, False, True, False]
    for field, got, fresh, kept in zip(state._fields, new, reset_st, stepped):
        for lane in range(n):
            want = fresh[lane] if done[lane] else kept[lane]
            assert torch.equal(got[lane], want), (field, lane)
    for lane in range(n):
        want = reset_obs[lane] if done[lane] else stepped_obs[lane]
        assert torch.equal(obs[lane], want), lane


def test_vector_env_steps_stub_env_with_per_lane_resets():
    venv = VectorEnv(StubEnv(max_steps=3), 4)
    state = venv.reset(prng.key(0))
    ends = 0
    for _ in range(7):
        state, out = venv.step(state, torch.tensor([1, 0, 1, 0]))
        assert state.env_state.x.shape == (4, 4)
        ends += int(out.done.sum())
        np.testing.assert_array_equal(state.env_state.t.numpy()[out.done.numpy()], 0)
    assert ends == 4 * 2 and state.eps_count.tolist() == [2, 2, 2, 2]


# ----------------------------------------------------------------- replay
def _rb_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.standard_normal((n, 4)).astype(np.float32),
        actions=rng.integers(0, 2, n),
        rewards=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, 4)).astype(np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32),
    )


def _replay_script(buffer_cls, batch_cls, prioritized):
    """One fixed sequence of add / replay / update / checkpoint calls; every
    output and the final state."""
    rb = buffer_cls(capacity=96, sample_batch_size=16, learning_starts=32,
                    prioritized=prioritized, seed=3)
    out = []
    for i in range(5):
        rb.add_batch(batch_cls(_rb_batch(24, seed=i)))  # wraps the 96-row store
        b = rb.replay()
        out.append(None if b is None else dict(b))
        if b is not None:
            prios = np.abs(np.random.default_rng(10 + i).standard_normal(16))
            rb.update_priorities(b["batch_indices"], prios)
        if i == 2:
            saved = rb.get_state()
    clone = buffer_cls(capacity=96, sample_batch_size=16, learning_starts=32,
                       prioritized=prioritized, seed=99)
    clone.set_state(saved)
    clone.add_batch(batch_cls(_rb_batch(24, seed=3)))
    out.append(dict(clone.replay()))  # replays what the original did at i == 3
    out.append(rb.get_state())
    out.append(rb.stats())
    return out


def _assert_bitwise(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("prioritized", [True, False])
def test_replay_is_bitwise_the_reference(prioritized):
    got = _replay_script(ReplayBuffer, SampleBatch, prioritized)
    want = _replay_script(JaxReplayBuffer, JaxSampleBatch, prioritized)
    assert [g is None for g in got] == [w is None for w in want]
    assert got[0] is None and got[1] is not None  # cold, then warm
    for g, w in zip(got, want):
        if w is not None:
            _assert_bitwise(g, w)
    # The restored buffer replays the original's stream after the checkpoint.
    _assert_bitwise(got[5], got[3])


def test_replay_cold_returns_none():
    rb = ReplayBuffer(capacity=100, sample_batch_size=16, learning_starts=32)
    rb.add_batch(SampleBatch(_rb_batch(8)))
    assert rb.replay() is None


def test_replay_sampling_and_weights():
    rb = ReplayBuffer(capacity=128, sample_batch_size=16, learning_starts=16, seed=1)
    rb.add_batch(SampleBatch(_rb_batch(64)))
    out = rb.replay()
    assert out.count == 16
    assert "weights" in out and "batch_indices" in out
    assert out["weights"].max() <= 1.0 + 1e-6


def test_prioritized_sampling_bias():
    rb = ReplayBuffer(capacity=64, sample_batch_size=32, learning_starts=32, alpha=1.0, seed=2)
    rb.add_batch(SampleBatch(_rb_batch(64)))
    rb.update_priorities(np.array([0]), np.array([1000.0]))  # index 0 dominates
    counts = sum(int((rb.replay()["batch_indices"] == 0).sum()) for _ in range(20))
    assert counts > 200


def test_replay_circular_overwrite():
    rb = ReplayBuffer(capacity=32, sample_batch_size=8, learning_starts=8)
    for i in range(4):
        rb.add_batch(SampleBatch(_rb_batch(16, seed=i)))
    assert len(rb) == 32


# ----------------------------------------------------------------- losses
def _dqn_batch(n=48, seed=0):
    b = _rb_batch(n, seed)
    b["weights"] = np.random.default_rng(seed + 1).uniform(0.2, 1.0, n).astype(np.float32)
    b["rewards"] *= 3.0  # TD errors on both sides of the Huber knee
    return b


def _port_loss_and_grads(loss_fn, params_np, *args):
    params = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(params_np))
    loss, aux = loss_fn(params, *args)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(p.shape, np.float32) if g is None else g.numpy() for p, g in zip(leaves, grads)]
    return loss.detach().numpy(), {k: v.detach().numpy() for k, v in aux.items()}, grads


def _assert_loss_parity(got, want):
    (loss_t, aux_t, grads_t), ((loss_j, aux_j), grads_j) = got, want
    _close(loss_t, loss_j, TOL, "loss")
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        _close(aux_t[k], aux_j[k], TOL, k)
    grads_j = jax.tree_util.tree_leaves(grads_j)
    assert len(grads_t) == len(grads_j)
    for g, w in zip(grads_t, grads_j):
        _close(g, w, LEARNER_TOL, "grad")


@pytest.mark.parametrize("weights", [True, False])
def test_dqn_loss_and_grads_match_reference(weights):
    pol_j, pol_t = JaxDQNPolicy(4, 2, hidden=(32, 32)), DQNPolicy(4, 2, hidden=(32, 32))
    params, target = _jax_params(pol_j, 0), _jax_params(pol_j, 1)
    batch = _dqn_batch()
    if not weights:
        del batch["weights"]
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.value_and_grad(pol_j.loss, has_aux=True)(params, target, batch_j)
    got = _port_loss_and_grads(pol_t.loss, params, params_from_numpy(target), batch_t)
    _assert_loss_parity(got, want)
    td = got[1]["td_error"]
    assert (np.abs(td) < 1.0).any() and (np.abs(td) > 1.0).any()


def _sac_case(seed=0, n=32, hidden=(32, 32)):
    pol_j, pol_t = JaxSACPolicy(3, 1, hidden=hidden), SACPolicy(3, 1, hidden=hidden)
    params, target = _jax_params(pol_j, seed), _jax_params(pol_j, seed + 1)
    rng = np.random.default_rng(seed)
    batch = dict(
        obs=rng.standard_normal((n, 3)).astype(np.float32),
        actions=rng.uniform(-1, 1, (n, 1)).astype(np.float32),
        rewards=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, 3)).astype(np.float32),
        dones=(rng.random(n) < 0.2).astype(np.float32),
    )
    key = jax.random.PRNGKey(seed + 7)
    # The reference's loss splits its key: k1 for the critic's draw on
    # next_obs, k2 for the actor's on obs, each of mu's shape [n, 1].
    k1, k2 = jax.random.split(key)
    eps_c = np.array(jax.random.normal(k1, (n, 1)))
    eps_a = np.array(jax.random.normal(k2, (n, 1)))
    return pol_j, pol_t, params, target, batch, key, eps_c, eps_a


def test_sac_loss_and_grads_match_reference_with_its_noise():
    pol_j, pol_t, params, target, batch, key, eps_c, eps_a = _sac_case()
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.value_and_grad(pol_j.loss, has_aux=True)(params, target, batch_j, key)
    got = _port_loss_and_grads(pol_t.loss_with_noise, params, params_from_numpy(target),
                               batch_t, torch.from_numpy(eps_c), torch.from_numpy(eps_a))
    _assert_loss_parity(got, want)


def test_sac_gradient_paths_match_reference():
    """The critic target is stop-gradient (no gradient into ``pi`` from the
    critic loss, ``next_logp`` included), while the actor loss sends
    gradient into ``q1`` and ``q2``: both packages alike."""
    pol_j, pol_t, params, target, batch, _, eps_c, eps_a = _sac_case(seed=3)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    k1, k2 = jax.random.split(jax.random.PRNGKey(3 + 7))
    g_critic_j = jax.grad(lambda p: pol_j.critic_loss(p, target, batch_j, k1)[0])(params)
    g_actor_j = jax.grad(lambda p: pol_j.actor_loss(p, batch_j, k2))(params)
    target_t = params_from_numpy(target)
    _, _, g_critic_t = _port_loss_and_grads(
        lambda p: (pol_t.critic_loss(p, target_t, batch_t, torch.from_numpy(eps_c))[0], {}), params)
    _, _, g_actor_t = _port_loss_and_grads(
        lambda p: (pol_t.actor_loss(p, batch_t, torch.from_numpy(eps_a)), {}), params)
    names = [n for n in ("pi", "q1", "q2") for _ in range(3 * 2)]  # 3 layers of w, b
    for got, want in ((g_critic_t, g_critic_j), (g_actor_t, g_actor_j)):
        for g, w in zip(got, jax.tree_util.tree_leaves(want)):
            _close(g, w, LEARNER_TOL)
    by_net = lambda grads: {n: max(float(np.abs(g).max()) for g, m in zip(grads, names) if m == n)
                            for n in ("pi", "q1", "q2")}
    critic, actor = by_net(g_critic_t), by_net(g_actor_t)
    assert critic["pi"] == 0.0 and critic["q1"] > 0 and critic["q2"] > 0
    assert actor["pi"] > 0 and (actor["q1"] > 0 or actor["q2"] > 0)
    assert by_net([np.asarray(g) for g in jax.tree_util.tree_leaves(g_critic_j)])["pi"] == 0.0


def test_dummy_policy_matches_reference():
    pol_j, pol_t = JaxDummyPolicy(), DummyPolicy()
    params = {"theta": np.array([0.75], np.float32)}
    want = jax.value_and_grad(pol_j.loss, has_aux=True)(params, {})
    got = _port_loss_and_grads(pol_t.loss, params, {})
    _assert_loss_parity(got, want)
    obs = torch.zeros((5, 4))
    action, logp, value, _ = pol_t.act(pol_t.init_params(torch.Generator()), obs, prng.key(0))
    assert action.shape == (5,) and action.dtype == torch.int64
    assert ((action >= 0) & (action < 2)).all() and not logp.any() and not value.any()


def test_dqn_greedy_acting_matches_reference_argmax():
    pol_j, pol_t = JaxDQNPolicy(4, 3), DQNPolicy(4, 3)
    params = _jax_params(pol_j, 2)
    obs = np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32)
    q_j = pol_j.q_values(params, jnp.asarray(obs))
    a_t, logp, v_t, q_t = pol_t.act(params_from_numpy(params), torch.from_numpy(obs),
                                   prng.key(0), 0.0)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(jnp.argmax(q_j, axis=-1)))
    _close(v_t.numpy(), jnp.max(q_j, axis=-1))
    _close(q_t.numpy(), q_j)
    assert not logp.any()
    # With epsilon 1 every action is a uniform draw: both actions occur.
    a_rand = pol_t.act(params_from_numpy(params), torch.from_numpy(obs), prng.key(0), 1.0)[0]
    assert set(a_rand.tolist()) == {0, 1, 2}


# ---------------------------------------------------------------- workers
def _dqn_worker(i=0, cls=RolloutWorker, **kw):
    kw = {"num_envs": 4, "rollout_len": 8, "epsilon": 0.3, **kw}
    return cls(CartPole(), DQNPolicy(4, 2, hidden=(32, 32)), algo="dqn", seed=4,
               worker_index=i, device="cpu", **kw)


def _sac_worker(i=0, cls=RolloutWorker, **kw):
    kw = {"num_envs": 4, "rollout_len": 8, "target_polyak": 0.01, **kw}
    return cls(Pendulum(), SACPolicy(3, 1, hidden=(32, 32)), algo="sac", seed=5,
               worker_index=i, device="cpu", **kw)


@pytest.mark.parametrize("cls", [RolloutWorker, VectorizedRolloutWorker])
@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_off_policy_workers_emit_transitions_without_logp_values_or_gae(cls, algo):
    w = _dqn_worker(cls=cls) if algo == "dqn" else _sac_worker(cls=cls)
    b = w.sample()
    assert b.count == 32
    assert {"obs", "actions", "rewards", "dones", "next_obs"} <= set(b)
    assert not {"logp", "values", "advantages", "returns"} & set(b)
    if algo == "sac":
        assert b["actions"].shape == (32, 1) and b["actions"].dtype == np.float32
        assert np.abs(b["actions"]).max() <= 1.0 and b["obs"].shape == (32, 3)
    else:
        assert b["actions"].shape == (32,)
    if cls is VectorizedRolloutWorker:
        assert "eps_id" in b and "truncateds" in b


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_learn_on_batch_returns_host_stats_and_td_error_as_numpy(algo):
    """Scalars come back as floats and the per-row ``td_error`` as a numpy
    array, which ``UpdateReplayPriorities`` sends to the replay actor."""
    w = _dqn_worker() if algo == "dqn" else _sac_worker()
    b = w.sample()
    b["weights"] = np.ones(b.count, np.float32)
    info = w.learn_on_batch(b)
    assert isinstance(info["td_error"], np.ndarray) and info["td_error"].shape == (b.count,)
    assert info["td_error"].dtype == np.float32
    scalars = {k: v for k, v in info.items() if k != "td_error"}
    assert scalars and all(isinstance(v, float) and np.isfinite(v) for v in scalars.values())
    want = {"dqn": {"loss", "mean_q"}, "sac": {"loss", "critic_loss", "actor_loss"}}[algo]
    assert set(scalars) == want


def test_dqn_learner_step_matches_reference_worker():
    """One ``learn_on_batch`` from the same online and target weights on a
    replayed batch: weights and stats agree with the reference's worker."""
    rb = ReplayBuffer(capacity=256, sample_batch_size=32, learning_starts=32, seed=0)
    port = _dqn_worker()
    rb.add_batch(port.sample())
    batch = rb.replay()
    ref = JaxWorker(JaxCartPole(), JaxDQNPolicy(4, 2, hidden=(32, 32)), algo="dqn", num_envs=4,
                    rollout_len=8, seed=4)
    port.set_weights(params_to_numpy(port.get_weights()))
    ref.params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(port.get_weights()))
    port.target_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref.target_params))
    info_t = port.learn_on_batch(SampleBatch(dict(batch)))
    info_j = ref.learn_on_batch(JaxSampleBatch(dict(batch)))
    _tree_close(port.get_weights(), ref.params, LEARNER_TOL)
    for k in info_j:
        _close(info_t[k], info_j[k], LEARNER_TOL, k)


def test_sac_polyak_step_matches_reference():
    port = _sac_worker()
    ref = JaxWorker(JaxPendulum(), JaxSACPolicy(3, 1, hidden=(32, 32)), algo="sac", num_envs=4,
                    rollout_len=8, seed=5, target_polyak=0.01)
    params, target = _jax_params(JaxSACPolicy(3, 1, hidden=(32, 32)), 0), _jax_params(
        JaxSACPolicy(3, 1, hidden=(32, 32)), 1)
    ref.params, ref.target_params = params, target
    port.params, port.target_params = params_from_numpy(params), params_from_numpy(target)
    ref._post_update()
    port._post_update()
    _tree_close(port.target_params, ref.target_params, TOL)
    _tree_close(port.params, params, 0.0)  # the online net is untouched


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_update_target_copies_by_value(algo):
    w = _dqn_worker() if algo == "dqn" else _sac_worker(target_polyak=0.0)
    w.update_target()
    before = params_to_numpy(w.target_params)
    b = w.sample()
    for _ in range(2):
        w.learn_on_batch(b)
    w.set_weights(tree_map(lambda p: p + 1.0, w.get_weights()))  # copies in place
    after = params_to_numpy(w.target_params)
    for x, y in zip(tree_leaves(before), tree_leaves(after)):
        np.testing.assert_array_equal(x, y)
    online = tree_leaves(params_to_numpy(w.get_weights()))
    assert any(not np.array_equal(x, y) for x, y in zip(tree_leaves(after), online))
    w.update_target()
    for x, y in zip(tree_leaves(params_to_numpy(w.target_params)), online):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ plans
# Recorded only once a producer finds a bounded window full, which depends
# on how fast each package's threads run, so they are left out.
TIMING_COUNTERS = {"num_credit_stalls", "credit_stall_time_s"}


def _shape(result):
    return {
        "keys": set(result),
        "info": set(result["info"]),
        "episodes": set(result["episodes"]),
        "counters": {k for k in result["counters"] if not k.startswith("bytes_moved/")}
        - TIMING_COUNTERS,
    }


def _pg_worker(i, cls=RolloutWorker, num_envs=2):
    return cls(CartPole(), ActorCriticPolicy(4, 2, hidden=(32, 32)), algo="pg", num_envs=num_envs,
               rollout_len=16, seed=3, worker_index=i, device="cpu")


def _jax_pg_worker(i):
    return JaxWorker(JaxCartPole(), JaxACPolicy(4, 2, hidden=(32, 32)), algo="pg", num_envs=2,
                     rollout_len=16, seed=3, worker_index=i)


def _jax_dqn_worker(i):
    return JaxWorker(JaxCartPole(), JaxDQNPolicy(4, 2, hidden=(32, 32)), algo="dqn", num_envs=4,
                     rollout_len=8, seed=4, worker_index=i, epsilon=0.3)


def _jax_sac_worker(i):
    return JaxWorker(JaxPendulum(), JaxSACPolicy(3, 1, hidden=(32, 32)), algo="sac", num_envs=4,
                     rollout_len=8, seed=5, worker_index=i, target_polyak=0.01)


def _replay(pool_cls, buffer_cls, n=1, batch=16, starts=32):
    return pool_cls.from_targets([
        buffer_cls(capacity=4096, sample_batch_size=batch, learning_starts=starts, seed=i)
        for i in range(n)
    ])


REPLAY = ("dqn", "apex", "sac")
PLANS = {
    "a2c": (_pg_worker, _jax_pg_worker, False, {}),
    "a3c": (_pg_worker, _jax_pg_worker, False, {}),
    "dqn": (_dqn_worker, _jax_dqn_worker, True, dict(target_update_freq=64)),
    "apex": (_dqn_worker, _jax_dqn_worker, True, dict(target_update_freq=64)),
    "sac": (_sac_worker, _jax_sac_worker, True, {}),
}


def _train_until(algo, done, rounds=200):
    results = [algo.train()]
    while not done(results[-1]) and rounds:
        results.append(algo.train())
        rounds -= 1
    return results


def _trained(plan):
    """Trained, and for the replay plans the target network synced."""

    def done(result):
        c = result["counters"]
        return c.get("num_steps_trained", 0) > 0 and (
            plan not in REPLAY or c.get("num_target_updates", 0) > 0
        )

    return done


@pytest.mark.timeout(240)
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plans_train_like_reference(monkeypatch, plan):
    port_factory, jax_factory, replay, kw = PLANS[plan]
    import repro_torch.rl.rollout_worker as port_rw

    gae_calls = []
    monkeypatch.setattr(port_rw, "gae", lambda *a, **k: gae_calls.append(1) or ops.fused_gae(*a, **k))
    ref_args = (_replay(JaxActorPool, JaxReplayBuffer),) if replay else ()
    with JaxAlgorithm.from_plan(plan, JaxWorkerSet.create(jax_factory, 2), *ref_args,
                                **kw) as ref:
        want = _train_until(ref, _trained(plan))
    args = (_replay(ActorPool, ReplayBuffer),) if replay else ()
    algo = Algorithm.from_plan(plan, WorkerSet.create(port_factory, 2), *args, **kw)
    try:
        got = _train_until(algo, _trained(plan))
        for _ in range(2):
            got.append(algo.train())
    finally:
        algo.stop()
    assert not [t.name for t in threading.enumerate() if t.name == "learner"]
    last = got[-1]
    assert _trained(plan)(last)
    assert all(np.isfinite(r["info"]["loss"]) for r in got if r["info"])
    assert _shape(last) == _shape(want[-1])
    if plan in ("a2c", "a3c"):
        # GAE ends every rollout; A3C's workers may hold gradients that are
        # computed but not applied yet.
        applied = last["counters"]["num_steps_sampled"]
        assert last["counters"]["num_steps_trained"] == applied
        if plan == "a2c":
            assert len(gae_calls) * 32 == applied
        else:
            assert len(gae_calls) * 32 >= applied
    else:
        assert gae_calls == []
        assert isinstance(last["info"]["td_error"], np.ndarray)


def test_a2c_averages_two_workers_gradients_and_broadcasts():
    ws = WorkerSet.create(_pg_worker, 2)
    with Algorithm.from_plan("a2c", ws, own_workers=False) as algo:
        res = algo.train()
        assert res["info"]["batch_count"] == 2 * 32
        local = tree_leaves(params_to_numpy(ws.local_worker().get_weights()))
        for actor in ws.remote_workers():
            remote = tree_leaves(params_to_numpy(actor.sync("get_weights")))
            for x, y in zip(local, remote):
                np.testing.assert_array_equal(x, y)
    ws.stop()


def test_a2c_vector_lowers_onto_vectorized_workers():
    ws = WorkerSet.create(lambda i: _pg_worker(i, cls=VectorizedRolloutWorker, num_envs=4), 2)
    with Algorithm.from_plan("a2c", ws, vector=8) as algo:
        res = algo.train()
        acks = [a.sync("configure_vectorization") for a in ws.remote_workers()]
    assert all(a["vector"] == 8 for a in acks)
    assert res["info"]["batch_count"] == 2 * 8 * 16


def test_a2c_server_inference_raises():
    """It raised while the serving tier was not ported; now A2C's gradient
    workers act through it: every rollout step is one served request."""
    ws = WorkerSet.create(lambda i: _pg_worker(i, cls=VectorizedRolloutWorker), 1)
    try:
        with Algorithm.from_plan("a2c", ws, own_workers=False, inference="server") as algo:
            res = algo.train()
            (actor,) = algo.compiled._inference_actors
            stats = actor.sync("stats")
        ack = ws.remote_workers()[0].sync("configure_vectorization")
        assert res["info"]["batch_count"] > 0 and stats["num_requests"] > 0
        assert ack["inference"] == "server"
    finally:
        ws.stop()


# ------------------------------------------ Algorithm (tests/test_flow.py)
@pytest.mark.timeout(120)
def test_algorithm_deferred_learner_lifecycle():
    """No side effects at build time, and no live learner thread after
    ``Algorithm.stop()``."""
    ws = WorkerSet.create(_dqn_worker, 2)
    rp = _replay(ActorPool, ReplayBuffer, n=2)
    algo = Algorithm.from_plan("apex", ws, rp, target_update_freq=256)
    learner = algo.resources["learner"]
    assert not learner.is_alive(), "learner must not start at compile time"
    res = _train_until(algo, lambda r: r["counters"].get("num_steps_trained", 0) > 0)
    assert learner.is_alive(), "the first pull starts the learner"
    assert res[-1]["counters"]["num_steps_trained"] > 0
    algo.stop()
    assert not learner.is_alive()
    assert not [t for t in threading.enumerate() if t.name == "learner"]


def test_algorithm_rejects_missing_replay():
    ws = WorkerSet.create(_pg_worker, 1)
    try:
        for plan in ("dqn", "apex", "sac"):
            with pytest.raises(ValueError, match="replay_actors"):
                Algorithm.from_plan(plan, ws)
        with pytest.raises(ValueError, match="unknown plan"):
            Algorithm.from_plan("nope", ws)
        with pytest.raises(ValueError, match="no effect"):
            Algorithm.from_plan(build_a3c(ws), ws, num_async=2)
    finally:
        ws.stop()


def test_algorithm_guards_use_after_stop():
    ws = WorkerSet.create(_pg_worker, 1)
    algo = Algorithm.from_plan("a3c", ws)
    algo.stop()
    for call in (algo.train, lambda: algo.iterate(1), lambda: iter(algo)):
        with pytest.raises(RuntimeError, match="stopped"):
            call()


# ------------------------------- Ape-X data plane (tests/test_backpressure.py)
@pytest.mark.timeout(120)
def test_apex_lossy_feed_counts_dropped_samples():
    """``block_on_enqueue=False`` lowers to the drop_newest learner feed:
    drops reach ``train()`` results beside the sample-to-learn latencies."""
    ws = WorkerSet.create(_dqn_worker, 2)
    rp = _replay(ActorPool, ReplayBuffer, batch=16, starts=16)
    algo = Algorithm.from_plan("apex", ws, rp, target_update_freq=10_000, block_on_enqueue=False)
    algo.resources["learner"].inqueue.maxsize = 1  # drops happen
    try:
        res = _train_until(algo, lambda r: r["counters"].get(NUM_SAMPLES_DROPPED, 0) > 0
                           and r["latencies"].get("sample_to_learn_s", {}).get("count", 0) > 0)[-1]
    finally:
        algo.stop()
    assert res["counters"][NUM_SAMPLES_DROPPED] > 0
    lat = res["latencies"]["sample_to_learn_s"]
    assert lat["count"] > 0 and 0 <= lat["p50"] <= lat["p99"]


@pytest.mark.parametrize(
    "kw,policy,credits",
    [({}, "block", None), (dict(block_on_enqueue=False), "drop_newest", None),
     (dict(enqueue_policy="drop_oldest", replay_credits=2), "drop_oldest", 2)],
)
def test_apex_data_plane_knobs_lower(monkeypatch, kw, policy, credits):
    """What lowering hands the learner feed's ``Enqueue`` and the replay
    gather, for each of Ape-X's data-plane knobs."""
    import repro_torch.flow.compile as compile_mod

    seen = {}
    enqueue, replay = compile_mod.Enqueue, compile_mod.Replay

    def recording_enqueue(*a, **k):
        seen["policy"] = k["policy"]
        return enqueue(*a, **k)

    def recording_replay(*a, **k):
        seen["credits"] = k["credits"]
        return replay(*a, **k)

    monkeypatch.setattr(compile_mod, "Enqueue", recording_enqueue)
    monkeypatch.setattr(compile_mod, "Replay", recording_replay)
    ws = WorkerSet.create(_dqn_worker, 1)
    with Algorithm.from_plan("apex", ws, _replay(ActorPool, ReplayBuffer), **kw) as algo:
        algo.train()
    assert seen == {"policy": policy, "credits": credits}
