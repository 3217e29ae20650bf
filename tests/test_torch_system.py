"""End-to-end behaviour of the port (``tests/test_system.py``).

The headline check mirrors the paper's own evaluation setting: PPO on
CartPole, expressed as a plan, must actually LEARN — mean reward above 60
after 26 iterations from an untrained ~20 — on the port's CPU path, with
the reference's settings.  The counters of a synchronous PPO run must
agree: every sampled step is trained on exactly once.
"""

import numpy as np
import pytest

import repro_torch.core as c
from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker


@pytest.mark.timeout(600)
def test_ppo_cartpole_learns():
    def mk(i):
        return RolloutWorker(
            CartPole(),
            ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind="ppo", ent_coef=0.0),
            algo="ppo",
            num_envs=8,
            rollout_len=64,
            seed=0,
            worker_index=i,
            device="cpu",
        )

    ws = c.WorkerSet.create(mk, num_workers=2)
    try:
        plan = c.ppo_plan(ws, train_batch_size=1024, num_sgd_iter=4, sgd_minibatch_size=256)
        it = iter(plan)
        first = next(it)
        early = first["episodes"]["episode_reward_mean"]
        last = first
        for _ in range(25):
            last = next(it)
        final = last["episodes"]["episode_reward_mean"]
        plan.flow.stop()
    finally:
        ws.stop()
    # Untrained CartPole ~ 20; a learning run exceeds 60 well within budget.
    assert np.isfinite(final)
    assert final > 60.0, f"reward did not improve: {early} -> {final}"
    assert final > early


def test_end_to_end_counters_consistent():
    def mk(i):
        return RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo",
            num_envs=2, rollout_len=16, seed=1, worker_index=i, device="cpu",
        )

    ws = c.WorkerSet.create(mk, 2)
    try:
        plan = c.ppo_plan(ws, train_batch_size=64, num_sgd_iter=1, sgd_minibatch_size=64)
        res = plan.take(3)
        plan.flow.stop()
    finally:
        ws.stop()
    counters = res[-1]["counters"]
    # Every sampled step was trained on exactly once (synchronous PPO).
    assert counters["num_steps_trained"] == counters["num_steps_sampled"]
