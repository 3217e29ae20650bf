"""The Flow IR's compile and fusion tests (``tests/test_flow.py``) on the
port: every plan builds and lowers without running, with the same graph as
the reference's plan; fused and unfused compiles agree item for item; the
Algorithm defers its side effects to the first pull and ends them at
``stop()``; the builder's stream typing refuses misuse.
"""

import re
import threading

import numpy as np
import pytest

import repro.flow as jax_flow
import repro_torch.flow as flow
from repro.core.actor import ActorPool as JaxActorPool
from repro.core.workers import WorkerSet as JaxWorkerSet
from repro.rl import ActorCriticPolicy as JaxPolicy
from repro.rl import CartPole as JaxCartPole
from repro.rl import DQNPolicy as JaxDQNPolicy
from repro.rl import ReplayBuffer as JaxReplayBuffer
from repro.rl import RolloutWorker as JaxWorker
from repro_torch.core.actor import ActorPool
from repro_torch.core.iterators import NextValueNotReady
from repro_torch.core.workers import WorkerSet
from repro_torch.rl import ActorCriticPolicy, CartPole, DQNPolicy, ReplayBuffer, RolloutWorker


def pg_ws(algo="pg", n=2, rollout_len=8):
    def mk(i):
        return RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind=algo, rollout_len=rollout_len),
            algo=algo, num_envs=2, rollout_len=rollout_len, seed=3, worker_index=i, device="cpu",
        )

    return WorkerSet.create(mk, n)


def dqn_ws(n=2):
    def mk(i):
        return RolloutWorker(
            CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=2, rollout_len=8,
            seed=4, worker_index=i, epsilon=0.3, device="cpu",
        )

    return WorkerSet.create(mk, n)


def replay(n=1, batch=32, starts=64):
    return ActorPool.from_targets(
        [ReplayBuffer(capacity=4096, sample_batch_size=batch, learning_starts=starts)
         for _ in range(n)]
    )


def spec_for(name):
    """(spec, workers, replay_pool-or-None) for every registered plan."""
    if name in flow.REPLAY_PLANS:
        ws, rp = dqn_ws(n=1), replay()
        return flow.PLAN_BUILDERS[name](ws, rp), ws, rp
    ws = pg_ws(n=1)
    return flow.PLAN_BUILDERS[name](ws), ws, None


def jax_spec_for(name):
    """The reference's spec for the same plan, from the same settings."""
    if name in jax_flow.REPLAY_PLANS:
        ws = JaxWorkerSet.create(lambda i: JaxWorker(
            JaxCartPole(), JaxDQNPolicy(4, 2), algo="dqn", num_envs=2, rollout_len=8,
            seed=4, worker_index=i, epsilon=0.3), 1)
        rp = JaxActorPool.from_targets(
            [JaxReplayBuffer(capacity=4096, sample_batch_size=32, learning_starts=64)])
        return jax_flow.PLAN_BUILDERS[name](ws, rp), ws, rp
    ws = JaxWorkerSet.create(lambda i: JaxWorker(
        JaxCartPole(), JaxPolicy(4, 2, loss_kind="pg", rollout_len=8), algo="pg",
        num_envs=2, rollout_len=8, seed=3, worker_index=i), 1)
    return jax_flow.PLAN_BUILDERS[name](ws), ws, None


def _graph(spec):
    return [(n.kind, [i for i in n.inputs]) for n in spec.nodes.values()]


# --------------------------------------------------------------- round-trip
@pytest.mark.parametrize("name", sorted(flow.PLAN_BUILDERS))
def test_build_compile_roundtrip(name):
    """Every plan builds a valid graph and lowers without running, and the
    graph (node kinds and edges) is the reference plan's."""
    assert sorted(flow.PLAN_BUILDERS) == sorted(jax_flow.PLAN_BUILDERS)
    spec, ws, rp = spec_for(name)
    spec.validate()
    assert spec.output is not None and spec.nodes

    compiled = spec.compile()
    # Compilation is side-effect free: resources exist but are not started.
    for res in compiled.runtime.resources.values():
        assert not res.is_alive()
    dot = compiled.to_dot()
    assert dot.startswith("digraph") and dot.rstrip().endswith("}")

    jspec, jws, jrp = jax_spec_for(name)
    try:
        assert _graph(spec) == _graph(jspec)
        assert _graph(flow.fuse_for_each(spec)) == _graph(jax_flow.fuse_for_each(jspec))
    finally:
        jws.stop()
        if jrp is not None:
            jrp.stop()
    compiled.stop()
    ws.stop()
    if rp is not None:
        rp.stop()


def _assert_valid_dot(dot):
    assert dot.startswith('digraph "')
    assert dot.count("{") == dot.count("}") == 1
    declared = set(re.findall(r'^\s*"([^"]+)"\s*\[', dot, re.M))
    for src, dst in re.findall(r'^\s*"([^"]+)"\s*->\s*"([^"]+)"', dot, re.M):
        assert src in declared, f"edge source {src} undeclared"
        assert dst in declared, f"edge target {dst} undeclared"


@pytest.mark.parametrize("name", ["apex", "multi_agent_ppo_dqn"])
def test_to_dot_is_valid(name):
    """Valid DOT for the paper's Fig 9-12 style graphs, fused or not."""
    spec, ws, rp = spec_for(name)
    _assert_valid_dot(spec.to_dot())
    _assert_valid_dot(flow.fuse_for_each(spec).to_dot())
    ws.stop()
    if rp is not None:
        rp.stop()


# ---------------------------------------------------------------- Algorithm
def test_algorithm_ppo_trains_and_reports():
    ws = pg_ws(algo="ppo")
    with flow.Algorithm.from_plan(
        "ppo", ws, train_batch_size=64, num_sgd_iter=2, sgd_minibatch_size=32
    ) as algo:
        res = algo.iterate(2)
        assert res[-1]["counters"]["num_steps_trained"] > 0


def test_algorithm_deferred_learner_lifecycle():
    """No side effects at build/compile time, and no live learner threads
    after Algorithm.stop()."""
    ws = dqn_ws()
    rp = replay(n=2)
    threads_before = set(threading.enumerate())
    algo = flow.Algorithm.from_plan("apex", ws, rp, target_update_freq=256)
    learner = algo.resources["learner"]
    assert not learner.is_alive(), "learner must not start at compile time"

    res = algo.iterate(3)
    assert learner.is_alive(), "first pull starts the learner"
    assert res[-1]["counters"]["num_steps_trained"] > 0

    algo.stop()
    assert not learner.is_alive()
    assert not [t for t in threading.enumerate() if t.name == "learner" and t not in threads_before]


def test_algorithm_rejects_missing_replay():
    ws = pg_ws(n=1)
    with pytest.raises(ValueError, match="replay_actors"):
        flow.Algorithm.from_plan("apex", ws)
    with pytest.raises(ValueError, match="unknown plan"):
        flow.Algorithm.from_plan("nope", ws)
    with pytest.raises(ValueError, match="no effect"):
        flow.Algorithm.from_plan(flow.build_a3c(ws), ws, num_async=2)
    ws.stop()


# ------------------------------------------------------------ stage fusion
def _chain_spec():
    """Mixed pure/impure chain: fusion must preserve sentinel semantics."""
    spec = flow.FlowSpec("chain")
    s = spec.from_items(list(range(20)))

    def batcher():
        buf = []

        def _batch(x):  # impure: emits NextValueNotReady until 2 buffered
            buf.append(x)
            if len(buf) < 2:
                return NextValueNotReady()
            out, buf[:] = list(buf), []
            return out

        return _batch

    s = s.for_each(flow.pure(lambda x: x + 1), label="inc")
    s = s.for_each(batcher(), label="pair")
    s = s.for_each(flow.pure(lambda p: p[0] * 100 + p[1]), label="encode")
    spec.set_output(s)
    return spec


def test_fusion_equivalence():
    """Fused and unfused compiles produce identical outputs."""
    fused = list(_chain_spec().compile(fuse=True))
    unfused = list(_chain_spec().compile(fuse=False))
    expected = [(2 * i + 1) * 100 + (2 * i + 2) for i in range(10)]
    assert fused == unfused == expected


def test_fusion_merges_adjacent_local_stages():
    spec = _chain_spec()
    assert sum(n.kind == "for_each" for n in spec.nodes.values()) == 3
    opt = flow.fuse_for_each(spec)
    fe = [n for n in opt.nodes.values() if n.kind == "for_each"]
    assert len(fe) == 1
    assert len(fe[0].params["stages"]) == 3


def test_fusion_respects_stream_splits():
    """A duplicated (multi-consumer) stage chain must not fuse across the
    split point."""
    spec = flow.FlowSpec("split")
    s = spec.from_items([1, 2, 3]).for_each(flow.pure(lambda x: x + 1))
    a, b = s.duplicate(2)
    a = a.for_each(flow.pure(lambda x: x * 2))
    b = b.for_each(flow.pure(lambda x: x * 3))
    spec.set_output(spec.concurrently([a, b], mode="round_robin"))
    opt = flow.fuse_for_each(spec)
    assert sum(n.kind == "for_each" for n in opt.nodes.values()) == 3


def test_compose_stages_skips_checks_after_pure():
    inc = flow.pure(lambda x: x + 1)
    fused = flow.compose_stages([inc, inc, inc])
    assert fused(0) == 3
    assert getattr(fused, "flow_pure", False)


# ------------------------------------------------------------- builder API
def test_stream_typing_errors():
    ws = pg_ws(n=1)
    spec = flow.FlowSpec("t")
    par = spec.par_gradients(ws)
    with pytest.raises(TypeError):
        par.zip_with_source_actor()  # parallel stream: must sequence first
    local = par.gather_async()
    with pytest.raises(TypeError):
        local.gather_async()  # already local
    ws.stop()


def test_fused_chain_matches_the_reference_item_for_item():
    """The same chain through the reference's compiler gives the same items."""
    spec = jax_flow.FlowSpec("chain")
    s = spec.from_items(list(range(20)))
    buf = []

    def _batch(x):
        buf.append(x)
        if len(buf) < 2:
            from repro.core.iterators import NextValueNotReady as JaxNotReady

            return JaxNotReady()
        out, buf[:] = list(buf), []
        return out

    s = s.for_each(jax_flow.pure(lambda x: x + 1), label="inc")
    s = s.for_each(_batch, label="pair")
    s = s.for_each(jax_flow.pure(lambda p: p[0] * 100 + p[1]), label="encode")
    spec.set_output(s)
    assert list(_chain_spec().compile(fuse=True)) == list(spec.compile(fuse=True))
    assert np.array_equal(list(_chain_spec().compile(fuse=False)), list(spec.compile(fuse=True)))
