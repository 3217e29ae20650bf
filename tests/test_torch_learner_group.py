"""The port's sharded learner group against the JAX package on the CPU.

``tests/test_learner_group.py``'s tests held on ``repro_torch``: microbatch
accumulation, the row layout at the transport boundary, the FlowSpec
annotations' lowering, and the N-way gate.  The reference's gate runs a
4-device simulated mesh; the port's runs 4 gloo ranks (rank 0 in this
process, ranks 1-3 in child processes from the fork server, in a process
group of their own that is not torch's default group) and holds loss and
every parameter within 1e-4 of the reference's single-device
``learn_on_batch`` from the same weights and batch, with and without
``microbatch=2``.  Port-internal comparisons (group vs the worker's own
step) hold 1e-4 as well.
"""

import logging
import multiprocessing
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

import repro_torch.core as c
from repro.rl.env import CartPole as JaxCartPole
from repro.rl.policy import ActorCriticPolicy as JaxPolicy
from repro.rl.rollout_worker import RolloutWorker as JaxWorker
from repro_torch.core.learner_thread import LearnerThread
from repro_torch.core.operators import TrainOneStep
from repro_torch.flow import Algorithm, FlowSpec, build_ppo
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.rl import (
    ActorCriticPolicy,
    CartPole,
    DQNPolicy,
    Pendulum,
    RolloutWorker,
    SACPolicy,
    SampleBatch,
    ShardedLearnerGroup,
)
from repro_torch.rl import learner_group as lg
from repro_torch.tree import tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
import torch_chaos  # noqa: E402  (child ranks import it by name)

TOL = 1e-4  # loss and parameters, group vs single-device step


def make_worker(algo="ppo", seed=7, **kw):
    policy = DQNPolicy(4, 2) if algo == "dqn" else ActorCriticPolicy(4, 2, loss_kind=algo)
    return RolloutWorker(
        CartPole(), policy, algo=algo, num_envs=4, rollout_len=32, seed=seed, worker_index=0,
        device="cpu", **kw,
    )


def max_param_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _learner_ranks():
    return [p for p in multiprocessing.active_children() if p.name.startswith("learner-rank")]


# ---------------------------------------------------------- microbatch parity
def test_microbatch_accumulation_matches_full_batch():
    """Mean-gradient accumulation over k slices == one full-batch update."""
    batch = make_worker().sample()
    w_plain = make_worker()
    info_plain = w_plain.learn_on_batch(batch)

    w_micro = make_worker()
    group = ShardedLearnerGroup(w_micro, num_learners=1, microbatch=4)
    info_micro = group.learn_on_batch(batch)

    assert abs(info_plain["loss"] - info_micro["loss"]) < TOL
    assert max_param_diff(w_plain.params, w_micro.params) < TOL
    assert info_micro["microbatch"] == 4
    assert group.num_steps == 1


def test_dqn_td_error_survives_microbatching():
    """Per-row aux columns must flatten back out, not average away."""
    w = make_worker("dqn")
    batch = w.sample()
    group = ShardedLearnerGroup(make_worker("dqn"), num_learners=1, microbatch=2)
    info = group.learn_on_batch(batch)
    assert info["td_error"].shape == (batch.count,)


def test_group_keeps_worker_canonical():
    """After a sharded step the worker's own weights are the fresh ones."""
    w = make_worker()
    group = ShardedLearnerGroup(w, num_learners=1, microbatch=2)
    before = w.get_weights()
    group.learn_on_batch(w.sample())
    assert max_param_diff(before, w.params) > 0
    # set_weights copies into the worker's tensors and the next step runs.
    group.set_weights(before)
    assert max_param_diff(before, w.params) == 0
    group.learn_on_batch(w.sample())


def test_shard_batch_trims_ragged_rows():
    w = make_worker()
    group = ShardedLearnerGroup(w, num_learners=1, microbatch=4)
    ragged = SampleBatch({"obs": np.zeros((130, 4), np.float32)})
    cols, usable = group.shard_batch(ragged)
    assert usable == 128
    assert group.num_rows_trimmed == 2
    assert cols["obs"].shape == (4, 32, 4)  # [k, rows/k, ...]
    with pytest.raises(ValueError):
        group.shard_batch(SampleBatch({"obs": np.zeros((3, 4), np.float32)}))


def test_sample_batch_shard_views():
    b = SampleBatch({"obs": np.arange(12).reshape(6, 2)})
    shards = b.shard(3)
    assert [s.count for s in shards] == [2, 2, 2]
    np.testing.assert_array_equal(shards[1]["obs"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError):
        b.shard(5)
    with pytest.raises(ValueError):
        b.shard(0)


def _vtrace_worker(seed=9):
    return RolloutWorker(
        CartPole(), ActorCriticPolicy(4, 2, loss_kind="vtrace", rollout_len=16),
        algo="vtrace", num_envs=4, rollout_len=16, seed=seed, worker_index=0, device="cpu",
    )


def test_vtrace_trace_aligned_tiling():
    """Trace-structured losses: microbatch slices must hold whole length-T
    traces, and tail-trimming must not cut mid-trace."""
    w = _vtrace_worker()
    group = ShardedLearnerGroup(w, num_learners=1, microbatch=2)
    assert group.trace_len == 16
    batch = w.sample()  # 64 rows = 4 contiguous traces of 16
    info = group.learn_on_batch(batch)  # 32-row microbatches: 2 whole traces
    assert np.isfinite(info["loss"])
    # Ragged rows trim in whole-trace units: tile = k * lcm(n, T) = 32.
    ragged = SampleBatch({"obs": np.zeros((70, 4), np.float32)})
    _, usable = group.shard_batch(ragged)
    assert usable == 64


def test_sac_polyak_target_tracks_in_sharded_path():
    def mk_sac():
        return RolloutWorker(
            Pendulum(), SACPolicy(3, 1), algo="sac", num_envs=2, rollout_len=8,
            seed=5, worker_index=0, target_polyak=0.05, device="cpu",
        )

    w = mk_sac()
    group = ShardedLearnerGroup(w, num_learners=1, microbatch=2)
    target_before = [t.clone() for t in tree_leaves(w.target_params)]
    group.learn_on_batch(w.sample())
    assert max_param_diff(target_before, w.target_params) > 0


def test_td_error_padded_to_full_batch_after_trim():
    """Consumers zip td_error with the full batch (UpdateReplayPriorities
    against batch_indices): trimmed rows must be padded back, neutrally."""
    w = make_worker("dqn")
    group = ShardedLearnerGroup(make_worker("dqn"), num_learners=1, microbatch=4)
    full = w.sample()
    ragged = full.slice(0, 126)  # tile=4 -> 124 usable, 2 trimmed
    info = group.learn_on_batch(ragged)
    assert info["td_error"].shape == (126,)
    trained = np.abs(info["td_error"][:124])
    np.testing.assert_allclose(info["td_error"][124:], np.mean(trained))


# ------------------------------------------------------- annotation lowering
class FakeTrain:
    """Stand-in train operator exposing the learner-group knobs."""

    flow_pure = True
    share_across_shards = True

    def __init__(self):
        self.num_learners = 0
        self.microbatch = 0

    def __call__(self, item):
        return (self.num_learners, self.microbatch)


def test_learners_annotation_lowered_onto_train_stage():
    spec = FlowSpec("t")
    out = spec.from_items([1, 2]).for_each(FakeTrain()).learners(3).microbatch(2)
    spec.set_output(out)
    compiled = spec.compile()
    assert compiled.take(1) == [(3, 2)]
    # The builder-side operator instance is untouched (compile deep-copies).
    assert spec.nodes[out.node_id].annotations == {"num_learners": 3, "microbatch": 2}


def test_learners_annotation_survives_fusion():
    spec = FlowSpec("t")
    out = (
        spec.from_items([1, 2])
        .for_each(lambda x: x, label="id")
        .for_each(FakeTrain())
        .learners(2)
    )
    spec.set_output(out)
    assert spec.compile(fuse=True).take(1) == [(2, 0)]


def test_learners_annotation_warns_without_capable_stage(caplog):
    spec = FlowSpec("t")
    out = spec.from_items([1]).for_each(lambda x: x, label="id").learners(2)
    spec.set_output(out)
    with caplog.at_level("WARNING"):
        spec.compile(fuse=False).take(1)
    assert any("learners/microbatch" in r.message for r in caplog.records)


def test_learners_annotation_on_parallel_node_warns(caplog):
    """learners()/microbatch() only lower onto *local* train stages; a
    parallel for_each carrying them must say so instead of silently
    training single-device."""
    ws = c.WorkerSet.create(lambda i: make_worker(seed=13), 1)
    try:
        spec = FlowSpec("t")
        out = (
            spec.rollouts(ws, mode="raw")
            .for_each(FakeTrain())
            .learners(4)
            .gather_sync()
        )
        spec.set_output(out)
        with caplog.at_level("WARNING"):
            spec.compile(fuse=False)
        assert any("parallel" in r.message for r in caplog.records)
    finally:
        ws.stop()


def test_learners_annotation_validates():
    spec = FlowSpec("t")
    s = spec.from_items([1]).for_each(lambda x: x)
    with pytest.raises(ValueError):
        s.learners(0)
    with pytest.raises(ValueError):
        s.microbatch(0)


def test_train_one_step_direct_kwargs():
    ws = c.WorkerSet.create(lambda i: make_worker(seed=11), 1)
    try:
        step = TrainOneStep(ws, microbatch=2)
        batch, info = step(ws.local_worker().sample())
        assert info["microbatch"] == 2
        assert info["num_learners"] == 1
    finally:
        ws.stop()


def test_learner_thread_builds_group():
    lt = LearnerThread(make_worker(), num_learners=1, microbatch=2)
    assert lt.learner_group is not None
    assert lt.learner_group.microbatch == 2
    lt_plain = LearnerThread(make_worker())
    assert lt_plain.learner_group is None


def test_cuda_learners_clamp_to_the_visible_cards(monkeypatch, caplog):
    """A CUDA worker's learners clamp to ``torch.cuda.device_count()`` with
    the reference's warning; a CPU worker's are gloo ranks, as many as it
    asks for.  (The group starts no rank before its first step.)"""

    class CudaWorker:
        device = torch.device("cuda")
        policy = ActorCriticPolicy(4, 2, loss_kind="ppo")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.rl.learner_group"):
        group = ShardedLearnerGroup(CudaWorker(), num_learners=2, microbatch=2)
    assert group.num_learners == 1 and group.microbatch == 2
    assert any("clamping" in r.getMessage() for r in caplog.records)
    assert ShardedLearnerGroup(make_worker(), num_learners=3).num_learners == 3


def test_cuda_groups_of_several_cards_raise(monkeypatch, caplog):
    """A CUDA group of several ranks (NCCL, one card a rank) starts as the
    reference's group spans its mesh: 2 learners on 4 visible cards are 2,
    with no warning; 8 clamp to the 4 cards with the reference's warning.
    (It raised before the group passed its check across four H100s; the
    name is kept.)"""

    class CudaWorker:
        device = torch.device("cuda")
        policy = ActorCriticPolicy(4, 2, loss_kind="ppo")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with caplog.at_level(logging.WARNING, logger="repro_torch.rl.learner_group"):
        two = ShardedLearnerGroup(CudaWorker(), num_learners=2)
    assert two.num_learners == 2 and not caplog.records
    with caplog.at_level(logging.WARNING, logger="repro_torch.rl.learner_group"):
        eight = ShardedLearnerGroup(CudaWorker(), num_learners=8, microbatch=2)
    assert eight.num_learners == 4 and eight.microbatch == 2
    assert any("clamping" in r.getMessage() for r in caplog.records)
    assert ShardedLearnerGroup(CudaWorker(), num_learners=1, microbatch=2).num_learners == 1


# ------------------------------------------------------------ end-to-end flow
@pytest.mark.timeout(120)
def test_ppo_plan_with_sharded_learner_end_to_end():
    def mk(i):
        return RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo",
            num_envs=2, rollout_len=16, seed=3, worker_index=i, device="cpu",
        )

    ws = c.WorkerSet.create(mk, 2)
    with Algorithm.from_plan(
        build_ppo(
            ws, train_batch_size=64, num_sgd_iter=1, sgd_minibatch_size=0,
            microbatch=2,
        ),
        ws,
    ) as algo:
        # Several iterations: iteration N+1 samples on remote workers holding
        # the weights broadcast after iteration N.
        for _ in range(3):
            result = algo.train()
    info = result["info"]
    assert info["microbatch"] == 2
    assert np.isfinite(info["loss"])


# --------------------------------------------- the N-way gate, 4 gloo ranks
def _reference_worker():
    return JaxWorker(
        JaxCartPole(), JaxPolicy(4, 2, loss_kind="ppo"), algo="ppo",
        num_envs=4, rollout_len=32, seed=7, worker_index=0,
    )


@pytest.mark.timeout(300)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_four_rank_group_matches_reference_single_device(microbatch):
    """4 gloo ranks (with and without microbatch accumulation) reach loss and
    parameter parity (1e-4) with the reference's single-device learn step
    from the same weights and the same batch."""
    ref = _reference_worker()
    batch_np = ref.sample()
    assert batch_np.count % 8 == 0
    start = jax.tree_util.tree_map(np.asarray, ref.params)
    info_ref = ref.learn_on_batch(batch_np)

    w = make_worker()
    w.set_weights(params_from_numpy(start))
    group = ShardedLearnerGroup(w, num_learners=4, microbatch=microbatch)
    try:
        info = group.learn_on_batch(SampleBatch({k: np.asarray(v) for k, v in batch_np.items()}))
        assert len(_learner_ranks()) == 3
    finally:
        group.close()
    assert not _learner_ranks()
    assert info["num_learners"] == 4 and info["microbatch"] == microbatch
    assert abs(info["loss"] - info_ref["loss"]) < TOL
    for name in ("pg_loss", "vf_loss", "entropy", "kl"):
        assert abs(info[name] - info_ref[name]) < TOL, name
    got = tree_leaves(params_to_numpy(w.params))
    want = jax.tree_util.tree_leaves(ref.params)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL, rtol=TOL)


@pytest.mark.timeout(300)
def test_two_rank_vtrace_and_dqn_match_one_rank():
    """Trace-aligned rank splits (V-trace, 2 traces a rank) and per-row
    td_error gathered in row order (DQN) give the one-rank step's loss,
    weights and priorities within 1e-4, over two steps."""
    for make in (_vtrace_worker, lambda: make_worker("dqn")):
        batch = make().sample()
        one, two = make(), make()
        g1 = ShardedLearnerGroup(one, num_learners=1)
        g2 = ShardedLearnerGroup(two, num_learners=2)
        try:
            for _ in range(2):
                i1, i2 = g1.learn_on_batch(batch), g2.learn_on_batch(batch)
                assert abs(i1["loss"] - i2["loss"]) < TOL
                if "td_error" in i1:
                    np.testing.assert_allclose(i2["td_error"], i1["td_error"], atol=TOL)
            assert max_param_diff(one.params, two.params) < TOL
        finally:
            g2.close()


# ------------------------------------------- a rank that stops or fails
def _alive_after(procs, seconds=30.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        time.sleep(0.1)
    return [p for p in procs if p.is_alive()]


@pytest.mark.timeout(240)
def test_a_child_rank_that_dies_makes_the_step_raise():
    """A child rank killed between steps (so before its next broadcast)
    makes the next ``learn_on_batch`` raise within the bounded wait, with
    every other rank stopped; the step after starts new ranks and trains."""
    w = make_worker()
    batch = w.sample()
    group = ShardedLearnerGroup(w, num_learners=4)
    try:
        group.learn_on_batch(batch)
        ranks = _learner_ranks()
        assert len(ranks) == 3
        ranks[1].kill()
        ranks[1].join(10)
        t0 = time.monotonic()
        with pytest.raises(Exception):
            group.learn_on_batch(batch)
        assert time.monotonic() - t0 < lg._TIMEOUT.total_seconds()
        assert not _alive_after(ranks)
        info = group.learn_on_batch(batch)
        assert np.isfinite(info["loss"]) and len(_learner_ranks()) == 3
    finally:
        group.close()
    assert not _alive_after(_learner_ranks())


class _RankLossFails(RolloutWorker):
    _loss_for = torch_chaos.rank_loss_fails


@pytest.mark.timeout(240)
def test_a_child_rank_whose_loss_fails_makes_the_step_raise():
    """A child rank whose loss raises still joins the reduce; the driver's
    step raises that error and stops every rank."""
    w = _RankLossFails(CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo",
                       num_envs=4, rollout_len=32, seed=7, worker_index=0, device="cpu")
    group = ShardedLearnerGroup(w, num_learners=3)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="on purpose"):
            group.learn_on_batch(w.sample())
        assert time.monotonic() - t0 < lg._TIMEOUT.total_seconds()
        assert not _alive_after(_learner_ranks())
    finally:
        group.close()


def test_nccl_group_is_built_with_the_bounded_wait(monkeypatch, tmp_path):
    """A CUDA worker's group is NCCL, built with ``_TIMEOUT`` on its options
    and the watchdog told to abort the communicator, not the process; the
    variable is restored after.  (A fake ``ProcessGroupNCCL``: no card.)"""
    import torch.distributed as dist

    built = {}

    class FakeNCCL:
        class Options:
            _timeout = None

        def __init__(self, store, rank, world, opts):
            built.update(rank=rank, world=world, timeout=opts._timeout,
                         handling=os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"))

    monkeypatch.setattr(dist, "ProcessGroupNCCL", FakeNCCL, raising=False)
    monkeypatch.delenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", raising=False)
    pg = lg._process_group(torch.device("cuda"), str(tmp_path / "store"), 0, 1)
    assert isinstance(pg, FakeNCCL)
    assert built == {"rank": 0, "world": 1, "timeout": lg._TIMEOUT, "handling": "2"}
    assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in os.environ


def test_nccl_wait_polls_to_the_deadline(monkeypatch):
    """An NCCL collective that never completes raises ``TimeoutError`` at
    the deadline instead of blocking the driver."""

    class Stuck:
        def is_completed(self):
            return False

        def wait(self):  # pragma: no cover - never reached
            raise AssertionError("waited on a collective that never completed")

    monkeypatch.setattr(lg, "_TIMEOUT", lg.datetime.timedelta(seconds=0.2))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        lg._wait(Stuck(), cuda=True)
    assert time.monotonic() - t0 < 5
