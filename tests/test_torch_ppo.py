"""Parity of the PyTorch port's PPO slice with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, so its kernels' plain versions serve the
path.  Tolerances: 1e-5 for deterministic numerics (env step, network,
optimizer step), 1e-4 for the learner half of the slice after 16 SGD steps
(the reference's learner-parity gate).  Sampling is held on behaviour, not
bits: JAX's threefry and torch's generators draw different numbers.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import StandardizeFields as JaxStandardizeFields
from repro.core.operators import TrainOneStep as JaxTrainOneStep
from repro.optim import adam as jax_adam
from repro.optim import sgd as jax_sgd
from repro.rl.env import CartPole as JaxCartPole
from repro.rl.env import CartPoleState as JaxCartPoleState
from repro.rl.policy import ActorCriticPolicy as JaxPolicy
from repro.rl.rollout_worker import RolloutWorker as JaxWorker
from repro_torch import prng
from repro_torch.core.operators import StandardizeFields, TrainOneStep
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.optim import adam, sgd
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    DQNPolicy,
    Pendulum,
    RolloutWorker,
    SACPolicy,
    SampleBatch,
)
from repro_torch.rl.env import CartPoleState
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LEARNER_TOL = 1e-4


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _tree_close(got, want, tol=TOL):
    got_l, want_l = tree_leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close(g, w, tol)


def _ppo_policies(hidden=(64, 64), ent_coef=0.0, loss_kind="ppo", rollout_len=0):
    kw = dict(hidden=hidden, loss_kind=loss_kind, ent_coef=ent_coef, rollout_len=rollout_len)
    return JaxPolicy(4, 2, **kw), ActorCriticPolicy(4, 2, **kw)


def _jax_params(policy, seed=0):
    return jax.tree_util.tree_map(np.asarray, policy.init_params(jax.random.PRNGKey(seed)))


# ------------------------------------------------------------------- env
def _cartpole_states():
    """Fixed states: near rest, near each termination bound, at the step
    horizon (truncation), and beyond a bound (termination)."""
    x = np.array([0.01, 2.395, -2.395, 0.0, 0.0, 0.3, 2.5], np.float32)
    x_dot = np.array([0.02, 1.0, -1.0, 0.0, 0.1, -1.0, 0.0], np.float32)
    theta = np.array([-0.03, 0.0, 0.0, 0.15, -0.15, 0.05, 0.0], np.float32)
    theta_dot = np.array([0.04, 0.0, 0.0, 0.5, -0.5, 0.3, 0.0], np.float32)
    t = np.array([0, 10, 10, 50, 50, 199, 3], np.int32)
    actions = np.array([0, 1, 0, 1, 0, 1, 1], np.int32)
    return (x, x_dot, theta, theta_dot, t), actions


def test_cartpole_step_raw_matches_reference():
    fields, actions = _cartpole_states()
    env_j = JaxCartPole()
    st_j = JaxCartPoleState(*map(jnp.asarray, fields))
    keys = jax.random.split(jax.random.PRNGKey(0), 7)
    out_j = jax.vmap(env_j.step_raw)(st_j, jnp.asarray(actions), keys)
    st_t = CartPoleState(*map(torch.from_numpy, fields))
    out_t = CartPole().step_raw(st_t, torch.from_numpy(actions).long(),
                                torch.from_numpy(np.asarray(keys).astype(np.int64)))
    new_j, obs_j, rew_j, term_j, trunc_j = out_j
    new_t, obs_t, rew_t, term_t, trunc_t = out_t
    _close(obs_t, obs_j, name="obs")
    _close(rew_t, rew_j, name="reward")
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    np.testing.assert_array_equal(new_t.t.numpy(), np.asarray(new_j.t))
    assert term_t.numpy().tolist() == [False, True, True, False, False, False, True]
    assert trunc_t.numpy().tolist() == [False] * 5 + [True, False]


def test_cartpole_reset_and_auto_reset():
    env = CartPole()
    st, obs = env.reset(prng.split(prng.key(0), 64))
    assert tuple(obs.shape) == (64, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05 and int(st.t.abs().max()) == 0
    fields, actions = _cartpole_states()
    st = CartPoleState(*map(torch.from_numpy, fields))
    keys = prng.split(prng.key(1), 7)
    new, obs, reward, done = env.step(st, torch.from_numpy(actions).long(), keys)
    done_np = done.numpy()
    assert done_np.tolist() == [False, True, True, False, False, True, True]
    # Lanes that ended restart from a fresh reset state; the others step on.
    assert float(obs[done].abs().max()) <= 0.05 and (new.t[done] == 0).all()
    raw = env.step_raw(st, torch.from_numpy(actions).long(), keys)
    torch.testing.assert_close(obs[~done], raw[1][~done], rtol=0, atol=0)
    assert (reward == 1.0).all()


# ---------------------------------------------------------------- policy
def test_logits_value_matches_reference_on_carried_weights():
    pol_j, pol_t = _ppo_policies(hidden=(32, 16))
    params = _jax_params(pol_j, seed=3)
    obs = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    logits_j, value_j = pol_j.logits_value(params_j, jnp.asarray(obs))
    logits_t, value_t = pol_t.logits_value(params_from_numpy(params), torch.from_numpy(obs))
    _close(logits_t, logits_j, name="logits")
    _close(value_t, value_j, name="value")
    back = params_to_numpy(params_from_numpy(params))
    for a, b in zip(jax.tree_util.tree_leaves(params), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def _ppo_batch(n, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return SampleBatch(
        obs=f32(n, 4), actions=rng.integers(0, 2, n).astype(np.int32), rewards=f32(n),
        dones=(rng.random(n) < 0.05).astype(np.float32), logp=-np.abs(f32(n)) - 0.2,
        values=f32(n), next_obs=f32(n, 4), advantages=f32(n), returns=f32(n),
    )


def _vtrace_batch(rollout_len):
    """64 rows of length-``rollout_len`` traces concatenated from two
    workers' samples, batch-major as ``ConcatBatches`` hands them over."""
    def worker(i):
        pol = ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="vtrace", rollout_len=rollout_len)
        return RolloutWorker(CartPole(), pol, algo="vtrace", num_envs=2, rollout_len=rollout_len,
                             seed=7, worker_index=i, device="cpu")

    return SampleBatch.concat_samples([worker(i).sample() for i in range(2)])


@pytest.mark.parametrize(
    "loss_kind,ent_coef", [("ppo", 0.0), ("ppo", 0.01), ("pg", 0.01), ("vtrace", 0.01)]
)
def test_policy_loss_and_grads_match_reference(loss_kind, ent_coef):
    T = 16 if loss_kind == "vtrace" else 0
    pol_j, pol_t = _ppo_policies(
        hidden=(16, 16), ent_coef=ent_coef, loss_kind=loss_kind, rollout_len=T
    )
    params = _jax_params(pol_j, seed=1)
    batch = _vtrace_batch(T) if loss_kind == "vtrace" else _ppo_batch(64, seed=2)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), grads_j = jax.value_and_grad(pol_j.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), batch_j
    )
    p_t = params_from_numpy(params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(p_t)]
    loss_t, aux_t = pol_t.loss(p_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, leaves)
    _close(loss_t.detach(), loss_j, name="loss")
    for k in aux_j:
        _close(aux_t[k].detach(), aux_j[k], name=k)
    for g, w in zip(grads_t, jax.tree_util.tree_leaves(grads_j)):
        _close(g, w, name="grad")


def test_adam_steps_match_reference():
    rng = np.random.default_rng(5)
    normal = lambda shape: rng.standard_normal(shape).astype(np.float32)
    params = {"a": [normal((3, 4))], "b": normal(4)}
    grads = [jax.tree_util.tree_map(lambda p: normal(p.shape), params) for _ in range(3)]
    opt_j, opt_t = jax_adam(1e-2), adam(1e-2)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    s_j = opt_j.init(p_j)
    p_t = params_from_numpy(params)
    s_t = opt_t.init(p_t)
    for g in grads:
        p_j, s_j = opt_j.apply(p_j, jax.tree_util.tree_map(jnp.asarray, g), s_j)
        p_t, s_t = opt_t.apply(p_t, params_from_numpy(g), s_t)
        _tree_close(p_t, p_j)
    assert s_t.step == int(s_j.step) == 3
    _tree_close(s_t.mu, s_j.mu)
    _tree_close(s_t.nu, s_j.nu)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_match_reference(momentum):
    rng = np.random.default_rng(6)
    normal = lambda shape: rng.standard_normal(shape).astype(np.float32)
    params = {"a": [normal((3, 4))], "b": normal(4)}
    grads = [jax.tree_util.tree_map(lambda p: normal(p.shape), params) for _ in range(3)]
    opt_j, opt_t = jax_sgd(0.1, momentum=momentum), sgd(0.1, momentum=momentum)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    s_j = opt_j.init(p_j)
    p_t = params_from_numpy(params)
    s_t = opt_t.init(p_t)
    for g in grads:
        p_j, s_j = opt_j.apply(p_j, jax.tree_util.tree_map(jnp.asarray, g), s_j)
        p_t, s_t = opt_t.apply(p_t, params_from_numpy(g), s_t)
        _tree_close(p_t, p_j)
    assert s_t.step == int(s_j.step) == 3


# --------------------------------------------------------- learner half
class _LocalOnly:
    """The part of a WorkerSet that TrainOneStep touches."""

    def __init__(self, worker):
        self._w = worker

    def local_worker(self):
        return self._w

    def sync_weights(self):
        pass


def test_standardize_and_train_one_step_match_reference():
    """The learner half of the slice: one 1024-row batch through
    StandardizeFields + TrainOneStep(num_sgd_iter=4, sgd_minibatch_size=256)
    in both packages, each shuffling with its own numpy default_rng(0)."""
    pol_j, pol_t = _ppo_policies()
    w_j = JaxWorker(JaxCartPole(), pol_j, algo="ppo", num_envs=2, rollout_len=4, seed=0)
    w_t = RolloutWorker(CartPole(), pol_t, algo="ppo", num_envs=2, rollout_len=4, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, w_j.get_weights())
    w_t.set_weights(params)
    batch = _ppo_batch(1024, seed=9)
    out_j, info_j = JaxTrainOneStep(_LocalOnly(w_j), num_sgd_iter=4, sgd_minibatch_size=256)(
        JaxStandardizeFields(["advantages"])(batch.copy())
    )
    out_t, info_t = TrainOneStep(_LocalOnly(w_t), num_sgd_iter=4, sgd_minibatch_size=256)(
        StandardizeFields(["advantages"])(batch.copy())
    )
    _close(out_t["advantages"], out_j["advantages"], name="standardized advantages")
    assert set(info_t) == set(info_j)
    for k in info_j:
        _close(info_t[k], info_j[k], LEARNER_TOL, name=k)
    _tree_close(w_t.get_weights(), w_j.get_weights(), LEARNER_TOL)
    assert w_t.opt_state.step == int(w_j.opt_state.step) == 16


# ---------------------------------------------------------------- worker
def _cpu_worker(i=0, **kw):
    return RolloutWorker(
        CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="ppo"),
        algo="ppo", num_envs=3, rollout_len=10, seed=1, worker_index=i, device="cpu", **kw,
    )


def test_rollout_worker_sample_columns_and_state_round_trip():
    w = _cpu_worker()
    batch = w.sample()
    cols = {"obs", "actions", "rewards", "dones", "logp", "values", "next_obs", "advantages",
            "returns"}
    assert set(batch.keys()) == cols and batch.count == 30
    assert batch["obs"].shape == (30, 4) and batch["obs"].dtype == np.float32
    assert np.isfinite(batch["advantages"]).all()
    np.testing.assert_allclose(batch["returns"], batch["advantages"] + batch["values"], atol=1e-6)
    state = w.get_state()
    nxt = w.sample()
    w.set_state(state)
    again = w.sample()
    for k in cols:
        np.testing.assert_array_equal(nxt[k], again[k], err_msg=k)


def test_weights_cross_workers_by_value():
    """get_weights hands out clones and set_weights copies in: a learner
    update never reaches a worker's tensors behind its back."""
    a, b = _cpu_worker(0), _cpu_worker(1)
    w = a.get_weights()
    b.set_weights(w)
    before = [t.clone() for t in tree_leaves(b.params)]
    a.learn_on_batch(a.sample())
    for t in tree_leaves(w):
        t.add_(1.0)
    for t, ref in zip(tree_leaves(b.params), before):
        assert torch.equal(t, ref)
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


def test_compute_then_apply_gradients_equals_learn_on_batch():
    a, b = _cpu_worker(0), _cpu_worker(0)
    batch = a.sample()
    info = a.learn_on_batch(batch)
    grads, ginfo = b.compute_gradients(batch)
    b.apply_gradients(grads)
    assert ginfo == {"loss": pytest.approx(info["loss"]), "batch_count": batch.count}
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_worker_defaults_to_cuda_and_refuses_to_run_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutWorker(CartPole(), ActorCriticPolicy(4, 2), algo="ppo")


# ------------------------------------------------------------ end to end
SMALL_PPO = dict(train_batch_size=96, num_sgd_iter=2, sgd_minibatch_size=48)


def _result_shape(result):
    return {
        "keys": set(result),
        "info": set(result["info"]),
        "episodes": set(result["episodes"]),
        "counters": {k: v for k, v in result["counters"].items() if "bytes" not in k},
    }


def test_algorithm_ppo_end_to_end_matches_reference_result_dict():
    from repro.core.workers import WorkerSet as JaxWorkerSet
    from repro.flow import Algorithm as JaxAlgorithm
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    def port_factory(i):
        return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="ppo"),
                             algo="ppo", num_envs=4, rollout_len=12, worker_index=i, device="cpu")

    def jax_factory(i):
        return JaxWorker(JaxCartPole(), JaxPolicy(4, 2, hidden=(16, 16), loss_kind="ppo"),
                         algo="ppo", num_envs=4, rollout_len=12, worker_index=i)

    shapes = []
    for make_set, algo_cls, factory in (
        (WorkerSet.create, Algorithm, port_factory),
        (JaxWorkerSet.create, JaxAlgorithm, jax_factory),
    ):
        with algo_cls.from_plan("ppo", make_set(factory, 2), **SMALL_PPO) as algo:
            results = [algo.train() for _ in range(2)]
        shapes.append([_result_shape(r) for r in results])
        assert all(np.isfinite(r["info"]["loss"]) for r in results)
    assert shapes[0] == shapes[1]
    assert shapes[0][1]["counters"]["num_steps_trained"] == 2 * 96


def _sharded_learner_trains_ppo():
    """The sharded learner is ported: PPO's TrainOneStep runs on 2 gloo
    ranks (the CPU worker gets the learners it asks for), trains, and
    ``Algorithm.stop()`` stops the child rank."""
    import multiprocessing

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    workers = WorkerSet.create(lambda i: _cpu_worker(i), 1)
    try:
        with Algorithm.from_plan("ppo", workers, num_learners=2, **SMALL_PPO) as algo:
            result = algo.train()
            assert [p.name for p in multiprocessing.active_children()
                    if p.name.startswith("learner-rank")] == ["learner-rank-1"]
        assert result["info"]["num_learners"] == 2
        assert np.isfinite(result["info"]["loss"])
        assert result["counters"]["num_steps_trained"] >= 96
        assert not [p for p in multiprocessing.active_children()
                    if p.name.startswith("learner-rank")]
    finally:
        workers.stop()


def _process_backend_trains_ppo(**create):
    """The process backend is ported: PPO trains with its rollout worker in
    a child process started from the fork server, and the broadcast weights
    (torch tensors, crossing as host bytes) arrive equal to the learner's.
    ``torch_chaos.make_ppo_worker`` is the picklable factory: a child imports
    the factory's module, and this one imports JAX."""
    import torch_chaos

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    workers = WorkerSet.create(torch_chaos.make_ppo_worker, 1, **create)
    try:
        (remote,) = workers.remote_workers()
        assert remote.backend_name == "process"
        with Algorithm.from_plan("ppo", workers, own_workers=False, **SMALL_PPO) as algo:
            assert algo.train()["counters"]["num_steps_trained"] > 0
        for got, want in zip(tree_leaves(remote.sync("get_weights")),
                             tree_leaves(workers.local_worker().get_weights())):
            assert got.device == want.device and torch.equal(got, want)
    finally:
        workers.stop()


def _transport_selects_the_data_plane():
    """``transport=`` is ported: it picks the process backend's data plane
    by name; a thread backend takes and ignores it, and a transport with no
    backend name is refused, as in the reference."""
    import torch_chaos

    from repro_torch.core.executor import ThreadBackend
    from repro_torch.core.transport import PickleTransport
    from repro_torch.core.workers import WorkerSet

    _process_backend_trains_ppo(backend="process", transport="pickle")
    workers = WorkerSet.create(torch_chaos.make_ppo_worker, 1, backend="process", transport="pickle")
    try:
        assert isinstance(workers.remote_workers()[0]._cell._transport, PickleTransport)
    finally:
        workers.stop()
    workers = WorkerSet.create(lambda i: _cpu_worker(i), 1, backend="thread", transport="shm")
    try:
        assert isinstance(workers.remote_workers()[0]._backend, ThreadBackend)
    finally:
        workers.stop()
    with pytest.raises(ValueError, match="requires a backend name"):
        WorkerSet.create(lambda i: _cpu_worker(i), 1, transport="shm")


def _strict_compiles_ppo_and_refuses_errors():
    """The flowcheck analyzer is ported: ``strict=True`` compiles PPO
    cleanly and refuses a spec that carries an error diagnostic."""
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm, FlowAnalysisError, FlowSpec

    workers = WorkerSet.create(lambda i: _cpu_worker(i), 1)
    try:
        with Algorithm.from_plan(
            "ppo", workers, strict=True, own_workers=False, **SMALL_PPO
        ) as algo:
            assert algo.check() == []
            assert algo.train()["counters"]["num_steps_trained"] > 0
        spec = FlowSpec("strict-error")
        spec.set_output(spec.rollouts(workers).for_each(lambda b: b).annotate(credits=3))
        with pytest.raises(FlowAnalysisError):
            Algorithm.from_plan(spec, workers, strict=True, own_workers=False)
    finally:
        workers.stop()


def _server_inference_trains_ppo():
    """The serving tier is ported: ``inference="server"`` lowers onto the
    vectorized workers, and the router's replicas serve every acting step."""
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.rl import VectorizedRolloutWorker

    def vec_worker(i):
        return VectorizedRolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, hidden=(16, 16), loss_kind="ppo"),
            algo="ppo", num_envs=3, rollout_len=16, seed=1, worker_index=i, device="cpu",
        )

    workers = WorkerSet.create(vec_worker, 1)
    with Algorithm.from_plan("ppo", workers, inference="server", **SMALL_PPO) as algo:
        result = algo.train()
        ((nid, meta),) = algo.compiled._inference_meta.items()
        assert result["counters"]["num_steps_trained"] > 0
        assert result["counters"][f"inference/{nid}/num_requests"] == 2 * 16
        (actor,) = algo.compiled._inference_actors
        assert actor.sync("stats")["num_lane_steps"] == 2 * 16 * 3


@pytest.mark.parametrize(
    "what", ["strict", "inference_server", "sharded_learner", "process_backend", "transport"]
)
def test_unported_paths_raise_instead_of_falling_back(what):
    # Ported since: these cases hold what strict=True, inference="server",
    # the sharded learner, the process backend and transport= do now.
    if what == "strict":
        _strict_compiles_ppo_and_refuses_errors()
        return
    if what == "inference_server":
        _server_inference_trains_ppo()
        return
    if what == "process_backend":
        _process_backend_trains_ppo(backend="process")
        return
    if what == "transport":
        _transport_selects_the_data_plane()
        return
    _sharded_learner_trains_ppo()


def test_unported_losses_and_algos_raise():
    """The DQN and SAC workers are ported and construct; the actor-critic
    policy still has no DQN loss (DQNPolicy has)."""
    with pytest.raises(NotImplementedError):
        ActorCriticPolicy(4, 2, loss_kind="dqn")
    sac = RolloutWorker(Pendulum(), SACPolicy(3, 1), algo="sac", device="cpu")
    dqn = RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", device="cpu")
    assert (sac.algo, dqn.algo) == ("sac", "dqn")
    with pytest.raises(ValueError):
        RolloutWorker(CartPole(), ActorCriticPolicy(4, 2), algo="maml", device="cpu")


# --------------------------------------------------------------- imports
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
