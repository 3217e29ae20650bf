"""The serving slice of the PyTorch port against the JAX package, on the CPU.

* ``repro_torch.prng``: threefry lane keys, bits and ``randint`` equal
  ``jax.random``'s bit for bit; ``uniform`` too; the categorical actions too;
* ``AdmissionQueue`` and ``CreditGate`` driven with the same op sequences in
  both packages keep equal stats;
* Mamba (``mamba_apply``, ``mamba_decode``), ``SSMStatePolicy`` and
  ``TransformerPolicy`` against the reference from converted weights and the
  same keys: actions equal, log-probs and values within 1e-5;
* the whole slice: the same obs batches through a 3-replica router in each
  package;
* the port-side counterparts of ``tests/test_serving.py``, of the serving
  cases of ``tests/test_vector_rollout.py`` and of the server-inference
  chaos cases of ``tests/test_chaos.py``, on the thread backend;
* the entry points default to the card and raise without one, and a
  replica never shares the caller's weight tensors.
"""

import random
import threading
import time

import chaos
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import ssm as jax_ssm
from repro.rl.inference import AdmissionQueue as JaxAdmissionQueue
from repro.rl.inference import CreditGate as JaxCreditGate
from repro.rl.inference import InferenceActor as JaxInferenceActor
from repro.rl.inference import InferenceRouter as JaxInferenceRouter
from repro.rl.policy import ActorCriticPolicy as JaxACPolicy
from repro.rl.policy import DQNPolicy as JaxDQNPolicy
from repro.rl.policy import DummyPolicy as JaxDummyPolicy
from repro.rl.policy import SACPolicy as JaxSACPolicy
from repro.rl.stateful_policy import SSMStatePolicy as JaxSSMStatePolicy
from repro.rl.transformer_policy import TransformerPolicy as JaxTransformerPolicy
from repro_torch import prng
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
from repro_torch.core.actor import VirtualActor
from repro_torch.core.operators import ParallelRollouts
from repro_torch.core.workers import WorkerSet
from repro_torch.flow import Algorithm, FlowSpec
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.rl import (
    ActorCriticPolicy,
    AdmissionQueue,
    CartPole,
    CreditGate,
    DQNPolicy,
    DummyPolicy,
    InferenceActor,
    InferenceClient,
    InferenceRouter,
    InferenceUnavailable,
    SACPolicy,
    SSMStatePolicy,
    StubEnv,
    TransformerPolicy,
    VectorizedRolloutWorker,
)
from repro_torch.tree import tree_leaves

TOL = 1e-5


def _keys(seed: int, n: int) -> np.ndarray:
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def _close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=name)


# ------------------------------------------------------------------ prng
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_prng_integer_outputs_equal_jax_bit_for_bit(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(prng.key(seed).numpy(), np.asarray(k))
    lanes = jax.random.split(k, 6)
    lanes_t = _t(lanes)
    for num in (2, 3):
        want = jax.vmap(lambda kk: jax.random.split(kk, num))(lanes)
        assert np.array_equal(prng.split(lanes_t, num).numpy(), np.asarray(want)), num
    data = np.array([0, 1, 5, 4095, 2**31 - 1], np.uint32)
    want = jax.vmap(lambda d: jax.random.fold_in(k, d))(jnp.asarray(data))
    assert np.array_equal(prng.fold_in(prng.key(seed), torch.from_numpy(data.astype(np.int64))).numpy(),
                          np.asarray(want))
    for shape in [(), (5,), (3, 4)]:
        want = jax.vmap(lambda kk: jax.random.bits(kk, shape))(lanes)
        assert np.array_equal(prng.random_bits(lanes_t, shape).numpy(), np.asarray(want)), shape
    want = jax.vmap(lambda kk: jax.random.uniform(kk, (7,)))(lanes)
    assert np.array_equal(prng.uniform(lanes_t, (7,)).numpy(), np.asarray(want))
    for lo, hi in [(0, 2), (0, 5), (-3, 1000), (0, 151936), (5, 5), (-(2**31), 2**31 - 1)]:
        want = jax.vmap(lambda kk: jax.random.randint(kk, (4,), lo, hi))(lanes)
        assert np.array_equal(prng.randint(lanes_t, (4,), lo, hi).numpy(), np.asarray(want)), (lo, hi)


@pytest.mark.parametrize("width", [2, 11, 1000])
def test_prng_categorical_actions_equal_jax(width):
    keys = _keys(3, 64)
    logits = np.random.default_rng(width).standard_normal((64, width)).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(jnp.asarray(keys), jnp.asarray(logits))
    got = prng.categorical(_t(keys), torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # The float draws follow JAX's constructions; log and erfinv differ in ulps.
    _close(prng.gumbel(_t(keys), (width,)),
           jax.vmap(lambda kk: jax.random.gumbel(kk, (width,)))(jnp.asarray(keys)), 1e-5)
    _close(prng.normal(_t(keys), (width,)),
           jax.vmap(lambda kk: jax.random.normal(kk, (width,)))(jnp.asarray(keys)), 1e-5)


def test_keyed_acting_of_every_policy_matches_reference():
    obs = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    keys = _keys(5, 16)
    cases = [
        (JaxACPolicy(4, 2), ActorCriticPolicy(4, 2), ()),
        (JaxDQNPolicy(4, 3), DQNPolicy(4, 3), (0.5,)),
        (JaxSACPolicy(4, 2), SACPolicy(4, 2), ()),
        (JaxDummyPolicy(4, 3), DummyPolicy(4, 3), ()),
    ]
    for pol_j, pol_t, extra in cases:
        params = pol_j.init_params(jax.random.PRNGKey(1))
        want = pol_j.compute_actions(params, jnp.asarray(obs), jnp.asarray(keys), *extra)
        got = pol_t.compute_actions(params_from_numpy(params), torch.from_numpy(obs), _t(keys),
                                    *extra)
        name = type(pol_t).__name__
        if isinstance(pol_t, SACPolicy):
            _close(got[0], want[0], name=name)
        else:
            assert np.array_equal(got[0].numpy(), np.asarray(want[0])), name
        _close(got[1], want[1], name=name)
        _close(got[2], want[2], name=name)


# ---------------------------------------------------- AdmissionQueue (port)
def _check_op_sequence(rnd, max_occ, num_ops=60):
    """Model-based check (the reference's): conservation, FIFO fairness and
    bounded occupancy after every op."""
    q = AdmissionQueue(max_occ)
    pending, active = [], set()
    completed, evicted = set(), set()
    next_id = 0
    for _ in range(num_ops):
        op = rnd.choice(("submit", "submit", "admit", "complete", "evict"))
        if op == "submit":
            q.submit(next_id)
            pending.append(next_id)
            next_id += 1
        elif op == "admit":
            got = q.admit()
            free = len(pending) if max_occ is None else max_occ - len(active)
            want = pending[: max(0, free)]
            assert got == want, "admission is not FIFO up to free capacity"
            active |= set(want)
            del pending[: len(want)]
        elif op == "complete" and active:
            ids = rnd.sample(sorted(active), rnd.randint(1, len(active)))
            q.complete(ids)
            active -= set(ids)
            completed |= set(ids)
        elif op == "evict" and (pending or active):
            universe = pending + sorted(active)
            ids = rnd.sample(universe, rnd.randint(1, len(universe)))
            assert q.evict(ids) == len(ids)
            pending = [r for r in pending if r not in set(ids)]
            active -= set(ids)
            evicted |= set(ids)
        assert q.occupancy == len(active)
        if max_occ is not None:
            assert q.occupancy <= max_occ
        s = q.stats()
        assert s["num_submitted"] == next_id
        assert s["num_completed"] == len(completed)
        assert s["num_evicted"] == len(evicted)
    assert next_id == len(pending) + len(active) + len(completed) + len(evicted)
    assert not (set(pending) | active) & (completed | evicted)
    assert not completed & evicted


@pytest.mark.parametrize("max_occ", [None, 1, 3])
@pytest.mark.parametrize("seed", range(25))
def test_admission_queue_fuzz(seed, max_occ):
    _check_op_sequence(random.Random(f"{seed}-{max_occ}"), max_occ)


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), max_occ=st.one_of(st.none(), st.integers(1, 6)))
def test_admission_queue_properties_hypothesis(seed, max_occ):
    _check_op_sequence(random.Random(seed), max_occ)


_TIMED_STATS = {"admission_wait_mean_s", "admission_wait_p50_s", "admission_wait_p99_s"}


@settings(max_examples=60, deadline=None)
@given(
    ops=st.lists(st.tuples(st.sampled_from(["submit", "admit", "complete", "evict"]),
                           st.integers(0, 10**6)), max_size=60),
    max_occ=st.one_of(st.none(), st.integers(1, 6)),
)
def test_admission_queue_ops_match_reference(ops, max_occ):
    """The same op sequence through both packages' queues: the same ids
    admitted at every step, the same counts and occupancy stats."""
    qs = (AdmissionQueue(max_occ), JaxAdmissionQueue(max_occ))
    next_id = 0
    for op, pick in ops:
        if op == "submit":
            for q in qs:
                q.submit(next_id)
            next_id += 1
        elif op == "admit":
            got = [q.admit() for q in qs]
            assert got[0] == got[1]
        else:
            ids = sorted(qs[1]._active) if op == "complete" else list(range(next_id))
            if not ids:
                continue
            chosen = [ids[pick % len(ids)]]
            if op == "complete":
                for q in qs:
                    q.complete(chosen)
            else:
                assert qs[0].evict(chosen) == qs[1].evict(chosen)
        s_t, s_j = ({k: v for k, v in q.stats().items() if k not in _TIMED_STATS} for q in qs)
        assert s_t == s_j


def _drive_gate(gate, ops):
    """Run an op sequence on a gate: 'take' acquires a free credit, 'give'
    releases a held one, 'contend' (all credits held) blocks one acquire on a
    thread until a release lets it through; returns the stall count."""
    held = 0
    for op in ops:
        if op == "take" and held < gate.credits:
            gate.acquire()
            held += 1
        elif op == "give" and held:
            gate.release()
            held -= 1
        elif op == "contend" and held == gate.credits:
            t = threading.Thread(target=gate.acquire)
            t.start()
            time.sleep(0.002)
            gate.release()
            t.join(timeout=10)
            assert not t.is_alive()
    return gate.stalls


@settings(max_examples=25, deadline=None)
@given(credits=st.integers(1, 3),
       ops=st.lists(st.sampled_from(["take", "give", "contend"]), max_size=25))
def test_credit_gate_ops_match_reference(credits, ops):
    assert _drive_gate(CreditGate(credits), ops) == _drive_gate(JaxCreditGate(credits), ops)


def test_admission_queue_rejects_bad_inputs():
    with pytest.raises(ValueError, match="max_occupancy"):
        AdmissionQueue(0)
    q = AdmissionQueue(2)
    q.submit(1)
    with pytest.raises(ValueError, match="already queued"):
        q.submit(1)
    with pytest.raises(ValueError, match="not active"):
        q.complete([1])
    assert q.evict([1]) == 1
    assert q.evict([1]) == 0


def test_credit_gate_bounds_and_counts_stalls():
    gate = CreditGate(1)
    gate.acquire()
    acquired = threading.Event()

    def second():
        gate.acquire()
        acquired.set()
        gate.release()

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.05)
    assert not acquired.is_set()  # blocked: only 1 credit
    gate.release()
    t.join(timeout=5)
    assert acquired.is_set() and gate.stalls == 1 and gate.stall_time_s > 0
    with pytest.raises(ValueError):
        CreditGate(0)


# ------------------------------------------------------------------ Mamba
def _mamba_cfgs(d_model=16, d_state=4, d_conv=3, expand=2):
    kw = dict(name="m", arch_type="ssm", num_layers=1, d_model=d_model, num_heads=1,
              num_kv_heads=1, d_ff=d_model, vocab_size=1, dtype="float32")
    cfg_j = JaxModelConfig(block_pattern=(JaxLayerSpec(kind="mamba", mlp="none"),),
                           ssm=JaxSSMConfig(kind="mamba", d_state=d_state, d_conv=d_conv,
                                            expand=expand), **kw)
    cfg_t = ModelConfig(block_pattern=(LayerSpec(kind="mamba", mlp="none"),),
                        ssm=SSMConfig(kind="mamba", d_state=d_state, d_conv=d_conv,
                                      expand=expand), **kw)
    return cfg_j, cfg_t


@pytest.mark.parametrize("T", [1, 5, 33])
def test_mamba_apply_matches_reference(T):
    cfg_j, cfg_t = _mamba_cfgs()
    params = jax_ssm.mamba_init(jax.random.PRNGKey(T), cfg_j)
    x = np.random.default_rng(T).standard_normal((3, T, 16)).astype(np.float32)
    want = jax_ssm.mamba_apply(params, jnp.asarray(x), cfg_j)
    got = ssm.mamba_apply(params_from_numpy(params), torch.from_numpy(x), cfg_t)
    _close(got, want)


def test_mamba_decode_matches_reference_over_carried_steps():
    """Eight decode steps with the state carried: outputs and both state
    leaves within 1e-5 each step; the port's param tree keeps the
    reference's keys and shapes."""
    cfg_j, cfg_t = _mamba_cfgs()
    params = jax_ssm.mamba_init(jax.random.PRNGKey(3), cfg_j)
    p_t = params_from_numpy(params)
    ref_tree = ssm.mamba_init(torch.Generator().manual_seed(0), cfg_t)
    assert {k: tuple(v.shape) for k, v in ref_tree.items()} == {
        k: tuple(np.shape(v)) for k, v in params.items()}
    s_j, s_t = jax_ssm.init_mamba_state(cfg_j, 4), ssm.init_mamba_state(cfg_t, 4)
    rng = np.random.default_rng(4)
    for step in range(8):
        x = rng.standard_normal((4, 1, 16)).astype(np.float32)
        o_j, s_j = jax_ssm.mamba_decode(params, jnp.asarray(x), s_j, cfg_j)
        o_t, s_t = ssm.mamba_decode(p_t, torch.from_numpy(x), s_t, cfg_t)
        _close(o_t, o_j, name=f"out {step}")
        _close(s_t["h"], s_j["h"], name=f"h {step}")
        _close(s_t["conv"], s_j["conv"], name=f"conv {step}")


# ------------------------------------------------------------- policies
def test_ssm_state_policy_matches_reference():
    pol_j, pol_t = JaxSSMStatePolicy(4, 2), SSMStatePolicy(4, 2)
    params = pol_j.init_params(jax.random.PRNGKey(11))
    p_t = params_from_numpy(params)
    s_j, s_t = pol_j.init_lane_state(8), pol_t.init_lane_state(8)
    step_j = jax.jit(pol_j.compute_actions_stateful)
    rng = np.random.default_rng(1)
    for step in range(6):
        obs = rng.standard_normal((8, 4)).astype(np.float32)
        keys = _keys(100 + step, 8)
        a_j, lp_j, v_j, s_j = step_j(params, jnp.asarray(obs), jnp.asarray(keys), s_j)
        a_t, lp_t, v_t, s_t = pol_t.compute_actions_stateful(p_t, torch.from_numpy(obs),
                                                             _t(keys), s_t)
        assert np.array_equal(a_t.numpy(), np.asarray(a_j)), step
        _close(lp_t, lp_j, name=f"logp {step}")
        _close(v_t, v_j, name=f"value {step}")
        for leaf in ("h", "conv"):
            _close(s_t[leaf], s_j[leaf], name=f"{leaf} {step}")
    _close(pol_t.value(p_t, torch.from_numpy(obs)), pol_j.value(params, jnp.asarray(obs)))


def test_transformer_policy_matches_reference():
    pol_j, pol_t = JaxTransformerPolicy(4, 2), TransformerPolicy(4, 2)
    params = pol_j.init_params(jax.random.PRNGKey(16))
    p_t = params_from_numpy(params)
    own = pol_t.init_params(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(own)] == [
        tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(params)]
    rng = np.random.default_rng(17)
    obs = rng.standard_normal((5, 4)).astype(np.float32)
    keys = _keys(18, 5)
    a_j, lp_j, v_j, lg_j = pol_j.compute_actions(params, jnp.asarray(obs), jnp.asarray(keys))
    a_t, lp_t, v_t, lg_t = pol_t.compute_actions(p_t, torch.from_numpy(obs), _t(keys))
    assert np.array_equal(a_t.numpy(), np.asarray(a_j))
    _close(lp_t, lp_j)
    _close(v_t, v_j)
    _close(lg_t, lg_j)
    st_t = pol_t.init_lane_state(5)
    a2, lp2, v2, st2 = pol_t.compute_actions_stateful(p_t, torch.from_numpy(obs), _t(keys), st_t)
    assert torch.equal(a2, a_t) and torch.equal(lp2, lp_t) and torch.equal(v2, v_t)
    assert st2["steps"].tolist() == [1] * 5
    # The GAE bootstrap's [T, N, D] obs: row by row the [N, D] values.
    obs3 = rng.standard_normal((3, 5, 4)).astype(np.float32)
    v3 = pol_t.value(p_t, torch.from_numpy(obs3))
    _close(v3, np.stack([np.asarray(pol_j.value(params, jnp.asarray(o))) for o in obs3]))
    # The PPO loss through the composed ActorCriticPolicy math.
    batch = {
        "obs": obs, "actions": np.asarray(a_j).astype(np.int32),
        "logp": np.asarray(lp_j) - 0.1, "advantages": rng.standard_normal(5).astype(np.float32),
        "returns": rng.standard_normal(5).astype(np.float32),
    }
    loss_j, aux_j = pol_j.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, aux_t = pol_t.loss(p_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss_t, loss_j)
    for k in aux_j:
        _close(aux_t[k], aux_j[k], name=k)


# ------------------------------------------------------- the whole slice
_FACTORIES = {
    "stateless": (lambda: JaxDummyPolicy(4, 2), lambda: DummyPolicy(4, 2)),
    "ac": (lambda: JaxACPolicy(4, 2), lambda: ActorCriticPolicy(4, 2)),
    "ssm": (lambda: JaxSSMStatePolicy(4, 2), lambda: SSMStatePolicy(4, 2)),
}


@pytest.mark.parametrize("policy", sorted(_FACTORIES))
def test_three_replica_router_matches_reference(policy):
    """The same obs batches, keys and lanes through a 3-replica router in
    each package, the reference's weights converted into the port's
    replicas: actions equal, log-probs and values within 1e-5."""
    fac_j, fac_t = _FACTORIES[policy]
    reps_j = [JaxInferenceActor(fac_j, seed=7) for _ in range(3)]
    reps_t = [InferenceActor(fac_t, seed=7, device="cpu") for _ in range(3)]
    router_j = JaxInferenceRouter(reps_j, credits=JaxCreditGate(2), name="ref")
    router_t = InferenceRouter(reps_t, credits=CreditGate(2), name="port")
    weights = reps_j[0].get_weights()
    router_j.sync_weights(weights)
    router_t.sync_weights(params_from_numpy(jax.tree_util.tree_map(np.asarray, weights)))
    assert router_t.sticky == router_j.sticky == (policy == "ssm")
    rng = np.random.default_rng(2)
    for step in range(3):
        for lanes in (np.arange(8), np.arange(100, 105)):
            obs = rng.standard_normal((len(lanes), 4)).astype(np.float32)
            keys = _keys(10 * step + len(lanes), len(lanes))
            a_j, lp_j, v_j = router_j.compute_actions(obs, keys, lanes)
            a_t, lp_t, v_t = router_t.compute_actions(obs, keys, lanes)
            assert np.array_equal(a_t, np.asarray(a_j)), (policy, step)
            _close(lp_t, lp_j, name=f"logp {step}")
            _close(v_t, v_j, name=f"value {step}")
    assert router_t.stats()["num_pinned_lanes"] == router_j.stats()["num_pinned_lanes"]


# ------------------------------------- tests/test_serving.py counterparts
def dummy_factory():
    return DummyPolicy(4, 2)


def ssm_factory():
    return SSMStatePolicy(4, 2)


def ac_factory():
    return ActorCriticPolicy(4, 2, loss_kind="ppo")


def make_vec_worker(i, policy=None, **kw):
    kw.setdefault("num_envs", 4)
    kw.setdefault("rollout_len", 8)
    kw.setdefault("seed", 21)
    kw.setdefault("algo", "pg")
    return VectorizedRolloutWorker(StubEnv(max_steps=6), policy or DummyPolicy(4, 2),
                                   worker_index=i, device="cpu", **kw)


def _rows(n, seed=0, obs_dim=4):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, obs_dim).astype(np.float32)
    keys = rng.randint(0, 2**31, size=(n, 2)).astype(np.uint32)
    return obs, keys


def _target(factory, **kw):
    return InferenceActor(factory, device="cpu", **kw)


def _virtual_replicas(factory, n, prefix):
    return [
        VirtualActor(factory=lambda: _target(factory, seed=7), name=f"{prefix}-{i}",
                     max_restarts=1, backoff_base=0.0)
        for i in range(n)
    ]


def _assert_batches_equal(b_srv, b_loc):
    assert set(b_srv.keys()) == set(b_loc.keys())
    for k in b_srv:
        np.testing.assert_array_equal(b_srv[k], b_loc[k], err_msg=k)


def test_three_replica_server_bit_matches_local_mode():
    """N-replica serving is the same computation as local inference:
    identical weights and key chains give identical streams through the
    rollout worker's ``sample()``."""
    actors = _virtual_replicas(dummy_factory, 3, "parity")
    router = InferenceRouter(actors, credits=CreditGate(2), name="parity")
    w_srv = make_vec_worker(1, inference="server", inference_client=router)
    router.sync_weights(w_srv.get_weights())
    w_loc = make_vec_worker(1)
    w_loc.set_weights(w_srv.get_weights())
    try:
        for _ in range(2):
            _assert_batches_equal(w_srv.sample(), w_loc.sample())
        assert router.stats()["num_requests"] >= 16  # 2 samples x 8 steps
    finally:
        router.stop()


def test_sticky_pins_request_lanes_together_and_stays_pinned():
    reps = [_target(ssm_factory, seed=7) for _ in range(3)]
    router = InferenceRouter(reps, name="sticky")
    assert router.sticky is True
    obs, keys = _rows(8, seed=1)
    for _ in range(3):
        router.compute_actions(obs, keys, np.arange(8))
        router.compute_actions(obs, keys, np.arange(100, 108))
    stats = router.stats()
    assert stats["num_pinned_lanes"] == 16 and stats["num_lane_repins"] == 0
    per_rep = [r.stats()["num_lane_states"] for r in reps]
    assert sum(per_rep) == 16 and all(n in (0, 8, 16) for n in per_rep)
    assert all(r.stats()["num_lane_steps"] % 8 == 0 for r in reps)


def test_sticky_repins_with_state_reset_after_replica_loss():
    actors = _virtual_replicas(ssm_factory, 3, "repin")
    router = InferenceRouter(actors, credits=CreditGate(2), failure_policy="drop_shard",
                             name="repin")
    obs, keys = _rows(8, seed=2)
    lanes = np.arange(8)
    try:
        router.compute_actions(obs, keys, lanes)
        victim_name = next(r["name"] for r in router.stats()["replicas"]
                           if r.get("stats", {}).get("num_lane_states") == 8)
        next(a for a in actors if a.name == victim_name).kill()
        with pytest.raises(InferenceUnavailable):
            router.compute_actions(obs, keys, lanes)
        router.recover()
        stats = router.stats()
        assert stats["num_replicas_dropped"] == 1 and len(stats["replicas"]) == 2
        assert stats["num_lane_repins"] == 8 and stats["num_lane_state_resets"] == 8
        router.compute_actions(obs, keys, lanes)
        stats = router.stats()
        assert stats["num_pinned_lanes"] == 8
        assert sorted(r.get("stats", {}).get("num_lane_states", 0)
                      for r in stats["replicas"]) == [0, 8]
    finally:
        router.stop()


def test_stale_replica_refused_until_recover_resyncs():
    actors = _virtual_replicas(dummy_factory, 2, "stale")
    canonical = actors[0].sync("get_weights")
    router = InferenceRouter(actors, credits=CreditGate(2), weights_provider=lambda: canonical,
                             name="stale")
    obs, keys = _rows(4, seed=3)
    try:
        router.sync_weights()
        assert router.stats()["num_eligible"] == 2
        actors[1].kill()
        router.sync_weights()  # the dead replica misses v2
        assert router.weight_version == 2
        actors[1].restart()  # alive but stale
        stats = router.stats()
        assert stats["num_eligible"] == 1
        by_name = {r["name"]: r for r in stats["replicas"]}
        assert by_name["stale-0"]["weight_version"] == 2
        assert by_name["stale-1"]["weight_version"] < 2
        router.compute_actions(obs, keys)
        by_name = {r["name"]: r for r in router.stats()["replicas"]}
        assert by_name["stale-0"]["stats"]["num_requests"] == 1
        assert by_name["stale-1"]["stats"]["num_requests"] == 0
        router.recover()
        stats = router.stats()
        assert stats["num_eligible"] == 2
        assert all(r["weight_version"] == 2 for r in stats["replicas"])
    finally:
        router.stop()


@pytest.mark.parametrize("factory", [dummy_factory, ac_factory, ssm_factory],
                         ids=["stateless", "ac", "ssm"])
def test_chunked_continuous_batching_matches_unbounded(factory):
    """max_batch bounds occupancy per dispatch step without changing any
    action: chunked (and power-of-two padded) serving samples what
    whole-batch serving samples, bit for bit where no matmul is involved.
    With one (ac, ssm), torch's float32 GEMM may round a row differently at
    another batch size (one ulp at M = 4 against M = 8 on the CPU), so
    log-probs and values are held to 1e-5 there."""
    obs, keys = _rows(8, seed=4)
    lanes = np.arange(8) if factory is ssm_factory else None
    whole = _target(factory, seed=3)
    chunked = _target(factory, seed=3, max_batch=3)
    ref = whole.compute_actions(obs, keys, lanes)
    got = chunked.compute_actions(obs, keys, lanes)
    np.testing.assert_array_equal(ref[0], got[0])
    for a, b in zip(ref[1:], got[1:]):
        if factory is dummy_factory:
            np.testing.assert_array_equal(a, b)
        else:
            _close(b, a)
    assert whole.stats()["num_dispatches"] == 1
    cs = chunked.stats()
    assert cs["num_dispatches"] == 3  # 3 + 3 + 2
    assert cs["queue"]["occupancy_peak"] == 3.0 and cs["queue"]["num_completed"] == 8.0


def test_interleaved_clients_cobatch_into_one_dispatch():
    actor = _target(dummy_factory, seed=5)
    obs_a, keys_a = _rows(4, seed=5)
    obs_b, keys_b = _rows(4, seed=6)
    ids_a = actor.submit(obs_a, keys_a)
    ids_b = actor.submit(obs_b, keys_b)
    assert actor.poll(ids_b) is not None
    res_a = actor.poll(ids_a)
    assert res_a is not None
    assert actor.stats()["num_dispatches"] == 1
    assert actor.stats()["queue"]["occupancy_peak"] == 8.0
    ref = _target(dummy_factory, seed=5).compute_actions(obs_a, keys_a)
    for a, b in zip(ref, res_a):
        np.testing.assert_array_equal(a, b)


def test_stateful_submit_requires_lanes():
    actor = _target(ssm_factory, seed=7)
    obs, keys = _rows(2, seed=7)
    with pytest.raises(ValueError, match="lanes"):
        actor.submit(obs, keys)


def test_open_loop_load_measures_from_scheduled_arrival():
    router, actors = serve.build_serving_tier(policy="stateless", replicas=2, supervised=False,
                                              seed=1, device="cpu")
    try:
        assert len(actors) == 2 and not hasattr(actors[0], "call")
        serve.warm_replicas(router, lanes_n=8)
        res = serve.open_loop_load(router, rate_hz=500.0, num_requests=20, lanes_per_request=4,
                                   num_clients=2, seed=1)
        assert res["requests_ok"] == 20 and res["requests_dropped"] == 0
        assert res["rps"] > 0 and res["lane_steps_per_s"] == 4 * res["rps"]
        assert 0 < res["latency_p50_s"] <= res["latency_p99_s"]
        assert res["offered_rate_hz"] == 500.0
        assert router.stats()["num_pinned_lanes"] == 0
        assert all(a.stats()["num_lane_states"] == 0 for a in actors)
    finally:
        router.stop()


@pytest.mark.parametrize("policy", ["stateless", "ac", "ssm"])
def test_serve_cli_runs_on_the_cpu(policy, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", "--policy", policy,
                                     "--replicas", "3", "--requests", "20", "--rate", "500"])
    serve.main()
    out = capsys.readouterr().out
    assert "20 ok / 0 dropped" in out and "p99" in out


# -------------------------- tests/test_vector_rollout.py counterparts
def test_inference_actor_serves_and_counts():
    target = _target(ac_factory, algo="ppo", seed=3)
    obs = np.zeros((4, 4), np.float32)
    keys = _keys(0, 4)
    a, logp, v = target.compute_actions(obs, keys)
    assert a.shape == (4,) and logp.shape == (4,) and v.shape == (4,)
    stats = target.stats()
    assert stats["num_requests"] == 1 and stats["num_lane_steps"] == 4
    assert stats["num_dispatches"] == 1 and stats["stateful"] is False
    assert stats["queue"]["num_completed"] == 4.0 and stats["queue"]["occupancy_peak"] == 4.0
    np.testing.assert_allclose(target.compute_values(obs), v, atol=1e-5)


def test_server_mode_bit_matches_local_mode():
    actor = VirtualActor(factory=lambda: _target(ac_factory, algo="ppo", seed=3), name="inf",
                         max_restarts=1, backoff_base=0.0)
    client = InferenceClient(actor, credits=CreditGate(2))
    w_srv = make_vec_worker(1, policy=ac_factory(), algo="ppo", inference="server",
                            inference_client=client)
    client.sync_weights(w_srv.get_weights())
    w_loc = make_vec_worker(1, policy=ac_factory(), algo="ppo")
    w_loc.set_weights(w_srv.get_weights())
    try:
        for _ in range(2):
            _assert_batches_equal(w_srv.sample(), w_loc.sample())
    finally:
        actor.stop()


def test_inference_failure_drops_fragment_and_recovers():
    actor = VirtualActor(factory=lambda: _target(ac_factory, algo="ppo", seed=3), name="inf2",
                         max_restarts=1, backoff_base=0.0)
    client = InferenceClient(actor, credits=CreditGate(2), weights_provider=lambda: canonical[0])
    w = make_vec_worker(1, policy=ac_factory(), algo="ppo", inference="server",
                        inference_client=client)
    canonical = [w.get_weights()]
    client.sync_weights()
    try:
        w.sample()
        actor.kill()
        b = w.sample()  # drops the in-flight fragment, recovers, resamples
        assert b.count == w.num_envs * w.rollout_len
        assert w.num_fragments_dropped == 1 and client.num_recoveries == 1
        assert w.episode_stats()["fragments_dropped"] == 1.0
        for a, b_ in zip(tree_leaves(actor.sync("get_weights")), tree_leaves(canonical[0])):
            assert torch.equal(a, b_)
    finally:
        actor.stop()


def test_inference_unavailable_after_retry_budget():
    class DeadTarget:
        def compute_actions(self, obs, keys):
            raise RuntimeError("down")

        def set_weights(self, w):
            pass

    w = make_vec_worker(1, policy=ac_factory(), algo="ppo", inference="server",
                        inference_client=InferenceClient(DeadTarget()), max_inference_retries=1)
    with pytest.raises(InferenceUnavailable):
        w.sample()
    assert w.num_fragments_dropped == 2  # initial attempt + one retry


def test_parallel_rollouts_configures_vector():
    ws = WorkerSet.create(make_vec_worker, 2)
    try:
        b = next(iter(ParallelRollouts(ws, mode="bulk_sync", vector=6)))
        assert b.count == 2 * 6 * 8
        acks = [a.sync("configure_vectorization") for a in ws.remote_workers()]
        assert all(a["vector"] == 6 for a in acks)
    finally:
        ws.stop()


def test_ppo_builder_vector_annotation_renders_and_lowers():
    ws = WorkerSet.create(make_vec_worker, 2)
    try:
        algo = Algorithm.from_plan("ppo", ws, train_batch_size=64, num_sgd_iter=1, vector=2,
                                   inference="server")
        dot = algo.to_dot()
        assert "vector=2" in dot and "inference=server" in dot
        res = algo.train()
        assert res["counters"]["num_steps_trained"] > 0
        (actor,) = algo.compiled._inference_actors
        assert actor.sync("stats")["num_requests"] > 0
        algo.stop()
        assert not actor.alive  # flow teardown owns the server
    finally:
        ws.stop()


def test_set_state_adopts_checkpoint_lane_count():
    """A state saved at vector=8 restores into a vector=4 worker: the lane
    plumbing and the lane keys follow the checkpoint, bit for bit."""
    w8 = make_vec_worker(1, num_envs=8)
    w8.sample()
    state = w8.get_state()
    assert state["act_rng"].shape == (8, 2) and state["act_rng"].dtype == np.uint32
    ref = w8.sample()
    w4 = make_vec_worker(1, num_envs=4)
    w4.set_state(state)
    assert w4.num_envs == 8
    _assert_batches_equal(ref, w4.sample())


def test_flow_stop_unregisters_weight_sink():
    ws = WorkerSet.create(make_vec_worker, 2)
    try:
        algo = Algorithm.from_plan("ppo", ws, train_batch_size=64, num_sgd_iter=1,
                                   inference="server", own_workers=False)
        algo.train()
        assert len(ws._weight_sinks) == 1
        algo.stop()
        assert ws._weight_sinks == []
        ws.sync_weights()
    finally:
        ws.stop()


def test_lane_keys_follow_the_reference_chain():
    """The worker's lane keys are ``fold_in(k_act, i)`` split every step,
    as the reference's: the chain from the same ``k_act`` is bitwise the
    reference's, and DummyPolicy's actions along it are too."""
    w = make_vec_worker(0, num_envs=3, rollout_len=5)
    k_act = np.array([11, 12], np.uint32)
    w.act_rng = prng.fold_in(torch.from_numpy(k_act.astype(np.int64)), torch.arange(3))
    chain = jax.vmap(lambda i: jax.random.fold_in(jnp.asarray(k_act), i))(jnp.arange(3))
    pol_j = JaxDummyPolicy(4, 2)
    acts = []
    for _ in range(5):
        both = jax.vmap(lambda k: jax.random.split(k, 2))(chain)
        chain, sub = both[:, 0], both[:, 1]
        acts.append(np.asarray(pol_j.compute_actions({}, jnp.zeros((3, 4)), sub)[0]))
    batch = w.sample()
    assert np.array_equal(w.act_rng.numpy(), np.asarray(chain))
    assert np.array_equal(batch["actions"].reshape(3, 5), np.stack(acts).T)


# --------------------------------- tests/test_chaos.py counterparts
def make_vec_inference_worker(i):
    return VectorizedRolloutWorker(StubEnv(max_steps=6), ActorCriticPolicy(4, 2, loss_kind="ppo"),
                                   algo="ppo", num_envs=2, rollout_len=8, seed=13, worker_index=i,
                                   device="cpu")


@pytest.mark.timeout(180)
def test_chaos_kill_inference_actor_recovers_and_drops_only_inflight():
    ws = WorkerSet.create(make_vec_inference_worker, 2)
    algo = Algorithm.from_plan("ppo", ws, train_batch_size=32, num_sgd_iter=1, inference="server")
    try:
        r1 = algo.train()
        sampled_before = r1["counters"]["num_steps_sampled"]
        (actor,) = algo.compiled._inference_actors
        assert actor.sync("stats")["num_requests"] > 0
        actor.kill()
        r2 = algo.train()
        assert r2["counters"]["num_steps_sampled"] > sampled_before
        drops = sum(a.sync("episode_stats")["fragments_dropped"] for a in ws.remote_workers())
        assert 1 <= drops <= 2
        assert r2["counters"]["num_steps_sampled"] % (2 * 8) == 0
        assert actor.alive and actor.num_restarts == 1
        for a, b in zip(tree_leaves(actor.sync("get_weights")),
                        tree_leaves(ws.local_worker().get_weights())):
            assert torch.equal(a, b)
        r3 = algo.train()
        assert r3["counters"]["num_steps_trained"] > r2["counters"]["num_steps_trained"]
    finally:
        algo.stop()


@pytest.mark.timeout(180)
def test_chaos_kill_one_of_three_replicas_drop_shard_heals_router():
    ws = WorkerSet.create(make_vec_inference_worker, 2)
    algo = Algorithm.from_plan(
        "ppo", ws, train_batch_size=32, num_sgd_iter=1, inference="server",
        inference_replicas=3, inference_routing="sticky", failure_policy="drop_shard",
    )
    try:
        r1 = algo.train()
        actors = algo.compiled._inference_actors
        assert len(actors) == 3
        ((nid, meta),) = algo.compiled._inference_meta.items()
        router = meta["router"]
        stats = router.stats()
        assert len(stats["replicas"]) == 3 and stats["num_pinned_lanes"] == 4
        actors[0].kill()
        r2 = algo.train()
        assert r2["counters"]["num_steps_sampled"] > r1["counters"]["num_steps_sampled"]
        drops = sum(a.sync("episode_stats")["fragments_dropped"] for a in ws.remote_workers())
        assert 1 <= drops <= 2
        assert r2["counters"]["num_steps_sampled"] % (2 * 8) == 0
        stats = router.stats()
        assert stats["num_replicas_dropped"] == 1 and len(stats["replicas"]) == 2
        assert stats["num_replica_failures"] >= 1 and stats["num_lane_repins"] >= 2
        assert stats["num_pinned_lanes"] == 4
        r3 = algo.train()
        assert r3["counters"]["num_steps_trained"] > r2["counters"]["num_steps_trained"]
        assert r3["counters"][f"inference/{nid}/num_replicas_dropped"] == 1
        assert r3["gauges"][f"inference/{nid}/replicas"] == 2.0
    finally:
        algo.stop()


def test_inference_fault_injection_is_deterministic():
    def run():
        def target():
            return chaos.FaultInjector(
                _target(dummy_factory, algo="pg", seed=2),
                [chaos.RaiseOnNth("compute_actions", n=20, message="inference-loss")],
                seed=5,
            )

        actor = VirtualActor(factory=target, name="chaos-inference", max_restarts=1,
                             backoff_base=0.0)
        w = VectorizedRolloutWorker(StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
                                    num_envs=2, rollout_len=8, seed=13, worker_index=1,
                                    device="cpu")
        client = InferenceClient(actor, credits=CreditGate(2), weights_provider=w.get_weights)
        w.configure_vectorization(inference="server", client=client)
        client.sync_weights()
        try:
            batches = [w.sample() for _ in range(3)]
            assert all(b.count == 2 * 8 for b in batches)
            return w.num_fragments_dropped, [int(b["eps_id"][0]) for b in batches]
        finally:
            actor.stop()

    first, second = run(), run()
    assert first == second and first[0] == 1


# --------------------------------------------- devices and weights
def test_serving_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceActor(dummy_factory)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_serving_tier(policy="ac", replicas=1, supervised=False)
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()
    # The lowered replicas take the local worker's device, the card by default.
    spec = FlowSpec("served")
    ws = WorkerSet.create(make_vec_worker, 1)
    try:
        spec.set_output(spec.rollouts(ws, inference="server").for_each(lambda b: b))
        monkeypatch.setattr(ws.local_worker(), "device", torch.device("cuda"))
        with pytest.raises(RuntimeError, match="CUDA"):
            Algorithm.from_plan(spec, ws, own_workers=False).train()
    finally:
        ws.stop()


def test_set_weights_copies_and_never_aliases_the_callers_tensors():
    actor = _target(ac_factory, seed=1)
    weights = ActorCriticPolicy(4, 2).init_params(torch.Generator().manual_seed(9))
    actor.set_weights(weights)
    before = [p.clone() for p in tree_leaves(actor.get_weights())]
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(weights)))
    for p in tree_leaves(weights):
        p.add_(1.0)  # the learner updating its tensors in place
    got = actor.get_weights()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(got)))
    for p in tree_leaves(got):
        p.mul_(0.0)  # a caller changing what get_weights returned
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(actor.get_weights())))
    actor.set_weights(params_to_numpy(weights))  # numpy trees, as interop gives them
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(actor.get_weights()),
                                                 tree_leaves(weights)))
