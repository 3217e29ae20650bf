"""Parity of the PyTorch port's asynchronous slice (IMPALA and APPO) with the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, so the V-trace kernel's plain version (the
reverse-time loop) serves the path.  Tolerances: 1e-5 absolute and
relative for V-trace against the Pallas kernel in interpret mode and its
``lax.scan`` oracle, and for the V-trace loss and its gradients (the
reference's kernel-vs-oracle gate, float32).  The asynchronous plans are
held on behaviour, not bits: the same result keys and counter names as the
reference under the same plan, and a learner thread that steps, learns
through the loss's kernel dispatch once per step, and is joined by
``stop()``.  The CUDA kernel runs only on a GPU: ``chip_smoke.py`` holds it
against the plain version there.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.workers import WorkerSet as JaxWorkerSet
from repro.flow import Algorithm as JaxAlgorithm
from repro.kernels.advantages import vtrace_pallas
from repro.optim import sgd as jax_sgd
from repro.rl.advantages import discounted_returns as jax_discounted_returns
from repro.rl.advantages import vtrace as jax_vtrace
from repro.rl.env import CartPole as JaxCartPole
from repro.rl.policy import ActorCriticPolicy as JaxPolicy
from repro.rl.rollout_worker import RolloutWorker as JaxWorker
from repro.rl.rollout_worker import VectorizedRolloutWorker as JaxVectorWorker
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm
from repro_torch.interop import params_to_numpy
from repro_torch.kernels import ops
from repro_torch.optim import sgd
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    RolloutWorker,
    SampleBatch,
    VectorizedRolloutWorker,
    discounted_returns,
    gae,
    vtrace,
)
from repro_torch.tree import tree_leaves

TOL = 1e-5


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


# ---------------------------------------------------------------- V-trace
def _vtrace_data(shape, seed):
    """Time-major inputs with about 10 % dones, log-ratios spread so rho
    lands both below and above the clips, and some rows whose target and
    behaviour log-probs are equal exactly (rho == 1)."""
    rng = np.random.default_rng(seed)
    blp = (-np.abs(rng.standard_normal(shape)) - 0.1).astype(np.float32)
    tlp = (blp + 0.8 * rng.standard_normal(shape)).astype(np.float32)
    flat_t, flat_b = tlp.reshape(-1), blp.reshape(-1)
    flat_t[::5] = flat_b[::5]
    flat_t[1], flat_t[2] = flat_b[1] + 1.5, flat_b[2] - 1.5  # rho ~ 4.5 and ~ 0.22
    r = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    d = (rng.random(shape) < 0.1).astype(np.float32)
    last = rng.standard_normal(shape[1:]).astype(np.float32)
    return blp, tlp, r, v, d, last


# [32, 16] is the IMPALA learner's trace panel; [33, 7] a ragged one; T = 1
# is the bootstrap alone; [16, 4, 2] has trailing dims flattened into B.
@pytest.mark.parametrize("shape", [(32, 16), (33, 7), (1, 5), (16, 4, 2)])
@pytest.mark.parametrize("rho_clip,c_clip", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_pallas_and_scan(shape, rho_clip, c_clip):
    data = _vtrace_data(shape, seed=sum(shape) * 7 + int(4 * rho_clip))
    kw = dict(gamma=0.97, rho_clip=rho_clip, c_clip=c_clip)
    rhos = np.exp(data[1] - data[0])
    assert (rhos < min(rho_clip, c_clip)).any() and (rhos > max(rho_clip, c_clip)).any()
    want_k = vtrace_pallas(*map(jnp.asarray, data), **kw, interpret=True)
    want_s = jax_vtrace(*map(jnp.asarray, data), **kw)
    got = ops.fused_vtrace(*map(torch.from_numpy, data), **kw)
    for name, want in (("pallas", want_k), ("scan", want_s)):
        _close(got[0], want[0], name=f"vs vs {name}")
        _close(got[1], want[1], name=f"pg_adv vs {name}")


def test_discounted_returns_match_reference():
    rng = np.random.default_rng(4)
    r = rng.standard_normal((20, 3)).astype(np.float32)
    d = (rng.random((20, 3)) < 0.2).astype(np.float32)
    last = rng.standard_normal(3).astype(np.float32)
    got = discounted_returns(*map(torch.from_numpy, (r, d, last)), gamma=0.9)
    _close(got, jax_discounted_returns(*map(jnp.asarray, (r, d, last)), gamma=0.9))


def test_vtrace_on_policy_equals_gae_lambda1():
    """The port's copy of the reference's property: with behaviour ==
    target policy (rho = c = 1), vs is the n-step bootstrapped value
    target, GAE's with lambda = 1."""
    T = 6
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    logp, d, last = torch.zeros(T), torch.zeros(T), torch.tensor(0.0)
    vs, _ = vtrace(logp, logp, r, v, d, last, gamma=0.9)
    _, target = gae(r, v, d, last, gamma=0.9, lam=1.0)
    _close(vs, target, tol=1e-4)


# ---------------------------------------------------------------- workers
T_ROLL = 8


def _policies(rollout_len=T_ROLL, loss_kind="vtrace", hidden=(16, 16)):
    kw = dict(hidden=hidden, loss_kind=loss_kind, rollout_len=rollout_len)
    return JaxPolicy(4, 2, **kw), ActorCriticPolicy(4, 2, **kw)


def _port_worker(i=0, cls=RolloutWorker, algo="vtrace", num_envs=3, **kw):
    loss_kind = "vtrace" if algo == "vtrace" else algo
    return cls(CartPole(), _policies(loss_kind=loss_kind)[1], algo=algo, num_envs=num_envs,
               rollout_len=T_ROLL, seed=1, worker_index=i, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["per_env", "vector"])
def test_vtrace_workers_emit_the_reference_columns_batch_major(kind):
    port_cls, jax_cls = {
        "per_env": (RolloutWorker, JaxWorker),
        "vector": (VectorizedRolloutWorker, JaxVectorWorker),
    }[kind]
    pol_j, _ = _policies()
    ref = jax_cls(JaxCartPole(), pol_j, algo="vtrace", num_envs=3, rollout_len=T_ROLL, seed=1)
    batch_j = ref.sample()
    batch_t = _port_worker(cls=port_cls).sample()
    assert set(batch_t.keys()) == set(batch_j.keys())
    assert not {"advantages", "returns"} & set(batch_t.keys())
    assert batch_t.count == batch_j.count == 3 * T_ROLL
    for k in batch_j.keys():
        assert batch_t[k].shape == np.asarray(batch_j[k]).shape, k
    # Batch-major: lane i's trace is rows [i*T, (i+1)*T), each step's
    # observation the previous step's (post-reset) successor.
    obs = batch_t["obs"].reshape(3, T_ROLL, 4)
    nxt = batch_t["next_obs"].reshape(3, T_ROLL, 4)
    if kind == "vector":  # next_obs is the true pre-reset successor there
        keep = batch_t["dones"].reshape(3, T_ROLL)[:, :-1] == 0
        np.testing.assert_array_equal(obs[:, 1:][keep], nxt[:, :-1][keep])
    else:
        np.testing.assert_array_equal(obs[:, 1:], nxt[:, :-1])


def _concat_batch(n_workers):
    """A train batch concatenated from several workers' samples, as
    ``ConcatBatches`` assembles it."""
    return SampleBatch.concat_samples([_port_worker(i).sample() for i in range(n_workers)])


def test_vtrace_learner_step_matches_reference_on_a_concatenated_batch():
    """One ``learn_on_batch`` (SGD) of an IMPALA worker on a batch from three
    workers, port against reference from the same weights: the traces of
    every worker stay contiguous through the concatenation."""
    pol_j, pol_t = _policies()
    w_j = JaxWorker(JaxCartPole(), pol_j, algo="vtrace", num_envs=3, rollout_len=T_ROLL,
                    optimizer=jax_sgd(0.1))
    w_t = RolloutWorker(CartPole(), pol_t, algo="vtrace", num_envs=3, rollout_len=T_ROLL,
                        optimizer=sgd(0.1), device="cpu")
    w_t.set_weights(jax.tree_util.tree_map(np.asarray, w_j.get_weights()))
    batch = _concat_batch(3)
    info_j = w_j.learn_on_batch(batch.copy())
    info_t = w_t.learn_on_batch(batch.copy())
    assert set(info_t) == set(info_j) == {"loss", "pg_loss", "vf_loss", "entropy"}
    for k in info_j:
        _close(info_t[k], info_j[k], name=k)
    got = tree_leaves(params_to_numpy(w_t.get_weights()))
    for g, w in zip(got, jax.tree_util.tree_leaves(w_j.get_weights())):
        _close(g, w)


# ------------------------------------------------------- weights contract
def test_learn_on_batch_never_updates_weights_in_place():
    w = _port_worker()
    held = tree_leaves(w.params)
    snapshot = [t.clone() for t in held]
    w.learn_on_batch(w.sample())
    for t, s in zip(held, snapshot):
        assert torch.equal(t, s)
    assert not any(a is b for a, b in zip(held, tree_leaves(w.params)))
    assert not all(torch.equal(a, b) for a, b in zip(snapshot, tree_leaves(w.params)))


def test_get_weights_during_learn_reads_one_whole_step():
    """The broadcast gate reads the local worker's weights while the learner
    thread steps it: every read equals, to the bit, the weights before or
    after some step, never a mix of the two."""
    w = _port_worker()
    batch = w.sample()
    states = [[t.clone() for t in tree_leaves(w.params)]]
    reads, done = [], threading.Event()

    def reader():
        while not done.is_set():
            reads.append(tree_leaves(w.get_weights()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=reader)
    try:
        t.start()
        for _ in range(20):
            w.learn_on_batch(batch)
            states.append([p.clone() for p in tree_leaves(w.params)])
    finally:
        done.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not t.is_alive() and reads

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for i in range(1, len(states)):
        assert not same(states[i - 1], states[i])
    for r in reads:
        assert any(same(r, s) for s in states)


# ------------------------------------------------------------ end to end
def _count_calls(monkeypatch, module, name):
    """Patch ``module.name`` to record the thread of every call."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(threading.current_thread())
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


# Recorded only once a producer finds the learner's in-queue full, which
# depends on how fast each package's learner runs (the reference compiles
# its first step), so they are left out of the comparison.
STALL_COUNTERS = {"num_credit_stalls", "credit_stall_time_s"}


def _shape(result):
    return {
        "keys": set(result),
        "info": set(result["info"]),
        "episodes": set(result["episodes"]),
        "counters": set(result["counters"]) - STALL_COUNTERS,
    }


def _train_until_trained(algo, rounds=40):
    results = [algo.train()]
    while results[-1]["counters"].get("num_steps_trained", 0) == 0 and rounds:
        results.append(algo.train())
        rounds -= 1
    for _ in range(2):
        results.append(algo.train())
    return results


@pytest.mark.timeout(240)
@pytest.mark.parametrize("plan,algo", [("impala", "vtrace"), ("appo", "ppo")])
def test_async_plans_train_like_reference(monkeypatch, plan, algo):
    import repro_torch.rl.advantages as port_advantages

    # The loss's kernel dispatch on CPU tensors: V-trace's plain loop, or
    # the surrogate's plain version.
    if algo == "vtrace":
        calls = _count_calls(monkeypatch, port_advantages, "vtrace")
    else:
        calls = _count_calls(monkeypatch, ops, "ppo_surrogate_plain")
    kw = dict(train_batch_size=48, num_async=2)

    def jax_factory(i):
        pol_j, _ = _policies(loss_kind=algo)
        return JaxWorker(JaxCartPole(), pol_j, algo=algo, num_envs=3, rollout_len=T_ROLL,
                         worker_index=i)

    with JaxAlgorithm.from_plan(plan, JaxWorkerSet.create(jax_factory, 2), **kw) as ref:
        want = _train_until_trained(ref)
    # The thread checks below are about the threads this Algorithm starts:
    # under pytest-xdist a worker process also holds the threads of the
    # files it ran before (an unstopped WorkerSet's "actor-*" mailbox, the
    # reference's learner still inside its join timeout), and a
    # process-wide name check then fails on threads the port never made.
    threads_before = set(threading.enumerate())
    ws = WorkerSet.create(lambda i: _port_worker(i, algo=algo), 2)
    algo_t = Algorithm.from_plan(plan, ws, **kw)
    try:
        got = _train_until_trained(algo_t)
        learner = algo_t.resources["learner"]
        assert learner.is_alive()
    finally:
        algo_t.stop()
    assert not learner.is_alive()
    assert not [t.name for t in threading.enumerate() if t not in threads_before and
                (t.name == "learner" or t.name.startswith("actor-"))]
    assert got[-1]["counters"]["num_steps_trained"] > 0
    assert all(np.isfinite(r["info"]["loss"]) for r in got if r["info"])
    assert _shape(got[-1]) == _shape(want[-1])
    assert learner.num_steps > 0
    assert calls.count(learner) == learner.num_steps


@pytest.mark.timeout(240)
def test_impala_builder_vector_lowers():
    """Ported from the reference's ``test_impala_builder_vector_lowers``
    onto the port's vectorized workers."""
    ws = WorkerSet.create(lambda i: _port_worker(i, cls=VectorizedRolloutWorker, num_envs=4), 2)
    algo = Algorithm.from_plan("impala", ws, train_batch_size=32, vector=2)
    try:
        res = algo.train()
        deadline_rounds = 20
        while res["counters"].get("num_steps_trained", 0) == 0 and deadline_rounds:
            res = algo.train()
            deadline_rounds -= 1
        assert res["counters"]["num_steps_trained"] > 0
        acks = [a.sync("configure_vectorization") for a in ws.remote_workers()]
        assert all(a["vector"] == 2 for a in acks)
    finally:
        algo.stop()


@pytest.mark.parametrize("kw", [dict(num_learners=2), dict(inference="server")])
def test_impala_unported_options_raise(kw):
    """Both options are ported since: ``num_learners=2`` trains through a
    2-rank learner group, and ``inference="server"`` through the serving
    tier."""
    ws = WorkerSet.create(lambda i: _port_worker(i, cls=VectorizedRolloutWorker), 1)
    try:
        if "inference" in kw:
            with Algorithm.from_plan("impala", ws, train_batch_size=32, own_workers=False,
                                     **kw) as algo:
                res = algo.train()
                for _ in range(20):
                    if res["counters"].get("num_steps_trained", 0):
                        break
                    res = algo.train()
                (actor,) = algo.compiled._inference_actors
                served = actor.sync("stats")["num_requests"]
            assert res["counters"]["num_steps_trained"] > 0 and served > 0
            return
        # num_learners=2: the learner thread steps a 2-rank gloo group.
        with Algorithm.from_plan("impala", ws, train_batch_size=32, own_workers=False,
                                 **kw) as algo:
            learner = algo.resources["learner"]
            assert learner.learner_group.num_learners == 2
            res = algo.train()
            for _ in range(20):
                if res["counters"].get("num_steps_trained", 0):
                    break
                res = algo.train()
        assert res["counters"]["num_steps_trained"] > 0
        assert learner.learner_group.num_steps > 0 and not learner.is_alive()
        assert learner.learner_group._ranks is None  # the thread closed its ranks
    finally:
        ws.stop()
