"""Determinism of the PyTorch port against the JAX package, on the CPU.

Every rollout draw of the port comes from the reference's threefry key
chains (``repro_torch.prng``, whose hash is ``repro_torch.kernels.threefry``:
the CUDA kernel on the card, the plain int64 chain here).  So:

* the hash itself: ``split``, ``fold_in`` and ``random_bits`` equal
  ``jax.random``'s bit for bit through the plain version, at counts that
  cross a 2^32 boundary too, and the kernel's wrapper refuses CPU tensors;
  ``uniform`` equals JAX's at any bounds (XLA's fused multiply-add);
* the port-side copies of ``tests/test_rollout_determinism.py``'s three
  properties, on the thread backend: the vectorized engine and
  ``PerEnvRolloutWorker`` give bit-identical streams and identical
  ``train()`` metrics, and the executor moves identical bytes (the process
  rows of the reference's backend matrix wait for the port's process
  backend);
* the key cases of ``tests/test_vector_rollout.py``: lane i of N equals a
  standalone lane, truncation against termination, the legacy-step
  fallback, a checkpoint's lane count adopted;
* cross-package streams: on StubEnv + DummyPolicy (seed 21, 2 workers, 4
  lanes, 8 steps, 2 rounds) the port's vectorized, per-env and
  non-vectorized workers give the reference's streams.  Keys, actions,
  dones, ``eps_id`` and obs are bitwise; rewards (and the advantages and
  returns made from them) within 1e-6, because ``tanh`` is torch's, not
  XLA's (one ulp);
* the resets of CartPole, Pendulum and TokenEnv equal the reference's bit
  for bit, and the DQN and actor-critic batch ``act`` on converted weights
  pick the reference's actions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.rl as jrl
from repro.rl.env import Env as JaxEnv
from repro.rl.token_env import TokenEnv as JaxTokenEnv
from repro_torch import prng
from repro_torch.core.operators import ParallelRollouts
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import threefry
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    DQNPolicy,
    DummyPolicy,
    MultiAgentCartPole,
    Pendulum,
    PerEnvRolloutWorker,
    RolloutWorker,
    StubEnv,
    TokenEnv,
    VectorEnv,
    VectorizedRolloutWorker,
)
from repro_torch.rl.env import Env

REWARD_TOL = 1e-6
FLOAT_COLUMNS = {"rewards", "advantages", "returns"}


def _keys(jax_keys):
    """JAX's uint32 keys as the port's int64 keys."""
    return torch.from_numpy(np.asarray(jax_keys).astype(np.int64))


# ------------------------------------------------------------------ hash
@pytest.mark.parametrize("lanes,n", [(1, 2), (8, 2), (256, 2), (3, 7), (2, 1000)])
def test_hash_counts_plain_matches_jax_split_and_bits(lanes, n):
    keys_j = jax.random.split(jax.random.PRNGKey(lanes * 31 + n), lanes)
    keys_t = _keys(keys_j)
    split_j = jax.vmap(lambda k: jax.random.split(k, n))(keys_j)
    bits_j = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys_j)
    np.testing.assert_array_equal(threefry.hash_counts_plain(keys_t, n, xor=False).numpy(),
                                  np.asarray(split_j).astype(np.int64))
    np.testing.assert_array_equal(threefry.hash_counts_plain(keys_t, n, xor=True).numpy(),
                                  np.asarray(bits_j).astype(np.int64))


def test_threefry_plain_hashes_counters_past_two_to_the_32():
    """A counter c past 2^32 hashes as the pair (c >> 32, c & 0xFFFFFFFF),
    as both the plain version and the kernel form it: the plain hash of
    such pairs equals JAX's threefry primitive."""
    from jax._src.prng import threefry2x32_p

    key = np.asarray(jax.random.PRNGKey(2))
    counts = np.array([0, 1, 2**32 - 1, 2**32, 2**32 + 2, 2**33 + 5], np.int64)
    hi, lo = counts >> 32, counts & threefry.MASK
    want = threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               jnp.asarray(hi, jnp.uint32), jnp.asarray(lo, jnp.uint32))
    got = threefry.threefry_plain(torch.tensor(int(key[0])), torch.tensor(int(key[1])),
                                  torch.from_numpy(hi), torch.from_numpy(lo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_fold_in_plain_matches_jax_and_broadcasts():
    key_j = jax.random.PRNGKey(9)
    want = jax.vmap(lambda i: jax.random.fold_in(key_j, i))(jnp.arange(6))
    got = threefry.fold_in_plain(_keys(key_j), torch.arange(6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    lanes_j = jax.random.split(key_j, 6)
    want = jax.vmap(jax.random.fold_in)(lanes_j, jnp.arange(6) * 7)
    got = prng.fold_in(_keys(lanes_j), torch.arange(6) * 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(-0.05, 0.05), (-np.pi, np.pi), (0.0, 1.0), (-0.5, 0.5)])
def test_uniform_equals_jax_at_any_bounds(lo, hi):
    """XLA fuses ``floats * (hi - lo) + lo`` into one multiply-add; at a span
    that is not a power of two a plain float32 product and sum round twice
    and miss JAX's bits in about half the draws (CartPole's and Pendulum's
    reset bounds)."""
    keys_j = jax.random.split(jax.random.PRNGKey(5), 2048)
    want = jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=lo, maxval=hi))(keys_j)
    np.testing.assert_array_equal(prng.uniform(_keys(keys_j), (4,), lo, hi).numpy(),
                                  np.asarray(want))


def test_kernel_wrappers_refuse_cpu_tensors_and_dispatch_by_device():
    keys = prng.split(prng.key(0), 4)
    with pytest.raises(ValueError, match="CUDA"):
        threefry.hash_counts_cuda(keys, 2, xor=False)
    with pytest.raises(ValueError, match="CUDA"):
        threefry.fold_in_cuda(keys, torch.arange(4))
    before = threefry.THREEFRY_LAUNCHES.value
    assert torch.equal(threefry.hash_counts(keys, 5, xor=True),
                       threefry.hash_counts_plain(keys, 5, xor=True))
    assert threefry.THREEFRY_LAUNCHES.value == before  # the plain version launches nothing


# -------------------------------------------------------- determinism suite
def make_vectorized(i):
    return VectorizedRolloutWorker(
        StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
        num_envs=4, rollout_len=8, seed=21, worker_index=i, device="cpu",
    )


def make_per_env(i):
    return PerEnvRolloutWorker(
        StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
        num_envs=4, rollout_len=8, seed=21, worker_index=i, device="cpu",
    )


def _stream(factory, rounds=2):
    ws = WorkerSet.create(factory, 2, backend="thread")
    try:
        it = iter(ParallelRollouts(ws, mode="bulk_sync"))
        return [next(it) for _ in range(rounds)]
    finally:
        ws.stop()


def assert_batches_identical(a, b, ctx=""):
    assert set(a.keys()) == set(b.keys()), ctx
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{ctx}:{k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx}:{k}")


def test_vectorized_bit_reproduces_per_env_stream():
    vec = _stream(make_vectorized)
    per = _stream(make_per_env)
    assert len(vec) == len(per) == 2
    for i, (bv, bp) in enumerate(zip(vec, per)):
        assert_batches_identical(bv, bp, f"thread round {i}")
    total = float(np.sum([np.sum(b["rewards"]) for b in vec]))
    assert total == float(np.sum([np.sum(b["rewards"]) for b in per]))


def _train_metrics(factory, iters=2):
    ws = WorkerSet.create(factory, 2, backend="thread")
    algo = Algorithm.from_plan("ppo", ws, train_batch_size=64, num_sgd_iter=1, own_workers=True)
    try:
        out = []
        for _ in range(iters):
            r = algo.train()
            out.append({"counters": dict(r["counters"]), "loss": r["info"].get("loss"),
                        "episodes": r["episodes"]})
        return out
    finally:
        algo.stop()


def test_train_metrics_identical_vectorized_vs_per_env():
    mv = _train_metrics(make_vectorized)
    mp = _train_metrics(make_per_env)
    for i, (a, b) in enumerate(zip(mv, mp)):
        assert a["counters"] == b["counters"], f"round {i}"
        assert a["loss"] == b["loss"], f"round {i}"
        assert a["episodes"] == b["episodes"], f"round {i}"


def test_streams_identical_across_backends():
    """The thread backend's actors move the bytes the workers make: the
    stream through a WorkerSet equals the same workers' samples taken
    directly (the reference's process rows wait for the port's process
    backend)."""
    got = _stream(make_vectorized)
    direct = [make_vectorized(i) for i in (1, 2)]
    for r, batch in enumerate(got):
        want = [w.sample() for w in direct]
        rows = sum(b.count for b in want)
        assert batch.count == rows
        merged = {k: np.concatenate([b[k] for b in want]) for k in want[0]}
        assert_batches_identical(batch, merged, f"round {r}")


# ----------------------------------------------------------------- VectorEnv
def test_vector_env_lane_parity_and_autoreset():
    venv3 = VectorEnv(StubEnv(max_steps=5), 3)
    venv1 = VectorEnv(StubEnv(max_steps=5), 1)
    s3 = venv3.reset(prng.key(11))
    lane = PerEnvRolloutWorker._lane(s3, 0)
    for t in range(11):
        actions = torch.tensor([t % 2, 1, 0])
        s3, _ = venv3.step(s3, actions)
        lane, _ = venv1.step(lane, actions[0:1])
        assert torch.equal(s3.obs[0], lane.obs[0])
        assert torch.equal(s3.rng[0], lane.rng[0])
        assert int(s3.eps_count[0]) == int(lane.eps_count[0])
    assert s3.eps_count.tolist() == [2, 2, 2]
    assert bool((s3.ep_len == 1).all())


def test_vector_env_lanes_equal_the_reference_lanes():
    """The N-wide port VectorEnv walks the reference's per-lane key chains:
    keys and obs bitwise over 11 steps with auto-resets (the reference's
    step jitted, as its workers run it: XLA fuses StubEnv's multiply-add)."""
    venv_j, venv_t = jrl.VectorEnv(jrl.StubEnv(max_steps=5), 3), VectorEnv(StubEnv(max_steps=5), 3)
    s_j, s_t = venv_j.reset(jax.random.PRNGKey(11)), venv_t.reset(prng.key(11))
    step_j = jax.jit(venv_j.step)
    for t in range(11):
        actions = np.array([t % 2, 1, 0])
        s_j, out_j = step_j(s_j, jnp.asarray(actions))
        s_t, out_t = venv_t.step(s_t, torch.from_numpy(actions))
        np.testing.assert_array_equal(s_t.rng.numpy(), np.asarray(s_j.rng).astype(np.int64))
        np.testing.assert_array_equal(out_t.obs.numpy(), np.asarray(out_j.obs))
        np.testing.assert_array_equal(out_t.next_obs.numpy(), np.asarray(out_j.next_obs))
        np.testing.assert_array_equal(out_t.done.numpy(), np.asarray(out_j.done))


def test_vector_env_truncation_vs_termination():
    venv = VectorEnv(StubEnv(max_steps=4, drift=0.0), 2)  # never terminates: horizon only
    s = venv.reset(prng.key(0))
    truncs = 0
    for _ in range(8):
        s, out = venv.step(s, torch.tensor([1, 0]))
        truncs += int(out.truncated.sum())
        assert not bool(out.terminated.any())
        if bool(out.done.any()):
            assert not torch.allclose(out.obs[out.done], out.next_obs[out.done])
    assert truncs == 4


def test_vector_env_legacy_step_fallback():
    """Envs without step_raw still vectorize (the legacy auto-resetting
    step), with truncated False and next_obs the post-reset obs; lanes equal
    the reference's fallback."""

    class LegacyEnv(Env):
        obs_dim, num_actions = 4, 2

        def __init__(self):
            self._stub = StubEnv(max_steps=3)

        def reset(self, keys):
            return self._stub.reset(keys)

        def step(self, state, action, keys):
            return self._stub.step(state, action, keys)

    class JaxLegacyEnv(JaxEnv):
        obs_dim, num_actions = 4, 2

        def __init__(self):
            self._stub = jrl.StubEnv(max_steps=3)

        def reset(self, key):
            return self._stub.reset(key)

        def step(self, state, action, key):
            return self._stub.step(state, action, key)

    venv, venv_j = VectorEnv(LegacyEnv(), 2), jrl.VectorEnv(JaxLegacyEnv(), 2)
    assert not venv._has_raw and not venv_j._has_raw
    s, s_j = venv.reset(prng.key(1)), venv_j.reset(jax.random.PRNGKey(1))
    step_j = jax.jit(venv_j.step)
    for t in range(4):
        s, out = venv.step(s, torch.tensor([0, 1]))
        s_j, out_j = step_j(s_j, jnp.asarray([0, 1]))
        assert torch.equal(out.next_obs, out.obs)
        assert not bool(out.truncated.any())
        np.testing.assert_array_equal(out.obs.numpy(), np.asarray(out_j.obs))
        np.testing.assert_array_equal(out.done.numpy(), np.asarray(out_j.done))


def test_set_state_adopts_checkpoint_lane_count():
    w8 = VectorizedRolloutWorker(StubEnv(max_steps=6), DummyPolicy(4, 2), num_envs=8,
                                 rollout_len=8, seed=21, worker_index=1, device="cpu")
    w8.sample()
    state = w8.get_state()
    ref = w8.sample()
    w4 = make_vectorized(1)
    w4.set_state(state)
    assert w4.num_envs == 8
    got = w4.sample()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


# ------------------------------------------------------------ cross-package
def _assert_stream_matches(got, want, ctx):
    assert set(got.keys()) == set(want.keys()), ctx
    for k in want:
        if k in FLOAT_COLUMNS:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=REWARD_TOL, rtol=0,
                                       err_msg=f"{ctx}:{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{ctx}:{k}")


def _jax_stream(cls, rounds=2):
    def factory(i):
        return cls(jrl.StubEnv(max_steps=6), jrl.DummyPolicy(4, 2), algo="pg",
                   num_envs=4, rollout_len=8, seed=21, worker_index=i)

    ws = jc.WorkerSet.create(factory, 2, backend="thread")
    try:
        it = iter(jc.ParallelRollouts(ws, mode="bulk_sync"))
        return [next(it) for _ in range(rounds)]
    finally:
        ws.stop()


@pytest.mark.parametrize("engine", ["vectorized", "per_env", "non_vectorized"])
def test_stub_dummy_stream_equals_the_reference(engine):
    jax_cls, port_cls = {
        "vectorized": (jrl.VectorizedRolloutWorker, VectorizedRolloutWorker),
        "per_env": (jrl.PerEnvRolloutWorker, PerEnvRolloutWorker),
        "non_vectorized": (jrl.RolloutWorker, RolloutWorker),
    }[engine]

    def factory(i):
        return port_cls(StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg", num_envs=4,
                        rollout_len=8, seed=21, worker_index=i, device="cpu")

    want = _jax_stream(jax_cls)
    got = _stream(factory)
    for r, (g, w) in enumerate(zip(got, want)):
        _assert_stream_matches(g, w, f"{engine} round {r}")


def test_worker_key_chains_equal_the_reference_after_learning():
    """The chain advances on learn_on_batch as the reference's (its learner
    key), so the next rollout still equals the reference's."""
    w_j = jrl.VectorizedRolloutWorker(jrl.StubEnv(), jrl.DummyPolicy(4, 2), num_envs=4,
                                      rollout_len=8, seed=21, worker_index=3)
    w_t = VectorizedRolloutWorker(StubEnv(), DummyPolicy(4, 2), num_envs=4, rollout_len=8,
                                  seed=21, worker_index=3, device="cpu")
    b_j, b_t = w_j.sample(), w_t.sample()
    w_j.learn_on_batch(b_j)
    w_t.learn_on_batch(b_t)
    np.testing.assert_array_equal(w_t._key.numpy(), np.asarray(w_j._key).astype(np.int64))
    np.testing.assert_array_equal(w_t.act_rng.numpy(), np.asarray(w_j.act_rng).astype(np.int64))
    _assert_stream_matches(w_t.sample(), w_j.sample(), "after learn_on_batch")
    state = w_t.get_state()
    assert state["key"].dtype == np.uint32 and state["vstate"].rng.dtype == np.uint32


# --------------------------------------------------------------- env resets
def _reset_pair(env_j, env_t, n=64, seed=5, obs_tol=0.0):
    """The drawn state bitwise; the obs bitwise too where it is the state,
    within ``obs_tol`` where it is a function of it (Pendulum's cos and sin
    are torch's, not XLA's)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    st_j, obs_j = jax.vmap(env_j.reset)(keys)
    st_t, obs_t = env_t.reset(_keys(keys))
    for a, b in zip(st_t, jax.tree_util.tree_leaves(st_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=obs_tol, rtol=0)


@pytest.mark.parametrize("env_name", ["CartPole", "Pendulum", "StubEnv"])
def test_env_reset_draws_equal_the_reference(env_name):
    _reset_pair(getattr(jrl, env_name)(), {"CartPole": CartPole, "Pendulum": Pendulum,
                                           "StubEnv": StubEnv}[env_name](),
                obs_tol=REWARD_TOL if env_name == "Pendulum" else 0.0)


def test_token_env_reset_draws_equal_the_reference():
    kw = dict(vocab_size=23, ctx=24, min_prompt=3, max_prompt=8, horizon=16)
    _reset_pair(JaxTokenEnv(**kw), TokenEnv(**kw))


def test_multi_agent_cartpole_reset_equals_the_reference():
    mapping = {0: "a", 1: "a", 2: "b"}
    env_j, env_t = jrl.MultiAgentCartPole(3, mapping), MultiAgentCartPole(3, mapping)
    _, obs_j = env_j.reset(jax.random.PRNGKey(4))
    _, obs_t = env_t.reset(prng.key(4))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))


# ------------------------------------------------------------- policy act
def _jax_params(policy, seed):
    return jax.tree_util.tree_map(np.asarray, policy.init_params(jax.random.PRNGKey(seed)))


def test_actor_critic_batch_act_equals_the_reference():
    pol_j, pol_t = jrl.ActorCriticPolicy(4, 3, hidden=(32, 32)), ActorCriticPolicy(4, 3, hidden=(32, 32))
    params = _jax_params(pol_j, 1)
    obs = np.random.default_rng(0).standard_normal((128, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    a_j, lp_j, v_j, _ = pol_j.act(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(obs), key)
    a_t, lp_t, v_t, _ = pol_t.act(params_from_numpy(params), torch.from_numpy(obs), _keys(key))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5, rtol=1e-5)
    assert len(set(a_t.tolist())) == 3  # all three actions drawn


@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_dqn_batch_act_equals_the_reference(epsilon):
    pol_j, pol_t = jrl.DQNPolicy(4, 3), DQNPolicy(4, 3)
    params = _jax_params(pol_j, 2)
    obs = np.random.default_rng(1).standard_normal((96, 4)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    a_j = pol_j.act(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(obs), key,
                    jnp.asarray(epsilon))[0]
    a_t = pol_t.act(params_from_numpy(params), torch.from_numpy(obs), _keys(key), epsilon)[0]
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
