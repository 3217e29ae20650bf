"""The PyTorch port's low-level baselines (``repro_torch.rl.lowlevel``): the
hand-written loops of the paper's Listings A2 and A4 that Table 2 counts the
plans against and Fig 13 times them against.

Each loop makes progress on CPU workers as the reference's does
(``tests/test_plans.py``), and the module keeps the reference's functions,
names and line counts, so a Table 2 count over the port reads the same
numbers as over the reference.
"""

import ast
import inspect
import threading
import time

import numpy as np
import pytest

import repro.rl.lowlevel as ref_lowlevel
import repro_torch.rl.lowlevel as port_lowlevel
from repro_torch.core.actor import ActorPool
from repro_torch.core.workers import WorkerSet
from repro_torch.rl import ActorCriticPolicy, CartPole, DQNPolicy, ReplayBuffer, RolloutWorker
from repro_torch.rl.lowlevel import a3c_lowlevel, apex_lowlevel, sync_sample_lowlevel


def _pg_ws(n=2):
    return WorkerSet.create(
        lambda i: RolloutWorker(CartPole(), ActorCriticPolicy(4, 2), algo="pg", num_envs=2,
                                rollout_len=16, seed=3, worker_index=i, device="cpu"), n)


def _dqn_ws(n=2):
    return WorkerSet.create(
        lambda i: RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=2,
                                rollout_len=8, seed=4, worker_index=i, epsilon=0.3, device="cpu"), n)


def test_a3c_lowlevel_makes_progress():
    ws = _pg_ws()
    try:
        it = a3c_lowlevel(ws)
        res = None
        for _ in range(4):
            res = next(it)
    finally:
        ws.stop()
    ctr = res["counters"]
    assert ctr["num_steps_trained"] > 0
    assert ctr["num_steps_trained"] == ctr["num_steps_sampled"] == 4 * 32
    assert set(res["timers"]) == {"wait", "apply", "dispatch"}
    assert all(np.isfinite(v) and v >= 0 for v in res["timers"].values())


@pytest.mark.timeout(120)
def test_apex_lowlevel_trains_through_its_learner_thread():
    ws = _dqn_ws()
    rp = ActorPool.from_targets([
        ReplayBuffer(capacity=4096, sample_batch_size=16, learning_starts=32, seed=i)
        for i in range(2)
    ])
    learner = None
    try:
        it = apex_lowlevel(ws, rp, target_update_freq=64, max_weight_sync_delay=32)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            res = next(it)
            learner = res["learner"]
            if res["counters"]["num_steps_trained"] >= 64:
                break
            time.sleep(0.01)
        sampled = sum(r.sync("stats")["sampled"] for r in rp)
    finally:
        if learner is not None:
            learner.stop()
            learner.join(timeout=30)
        ws.stop()
        rp.stop()
    ctr = res["counters"]
    assert ctr["num_steps_sampled"] > 0 and ctr["num_steps_trained"] >= 64
    assert ctr["num_samples_dropped"] >= 0
    assert sampled >= ctr["num_steps_trained"]
    assert not learner.is_alive()


def test_sync_sample_lowlevel_concatenates_one_round():
    ws = _pg_ws(n=3)
    try:
        batch = next(sync_sample_lowlevel(ws))
    finally:
        ws.stop()
    assert batch.count == 3 * 2 * 16
    assert {"obs", "actions", "advantages", "returns"} <= set(batch)


def _code_lines(fn):
    """Non-blank lines of ``fn`` that are not comments or its docstring."""
    src = inspect.getsource(fn)
    tree = ast.parse(src)
    body = tree.body[0].body
    doc = body[0] if isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) else None
    skip = set(range(doc.lineno, doc.end_lineno + 1)) if doc else set()
    return [ln.strip() for i, ln in enumerate(src.splitlines(), 1)
            if i not in skip and ln.strip() and not ln.strip().startswith("#")]


@pytest.mark.parametrize("name", ref_lowlevel.__all__)
def test_lowlevel_keeps_the_references_code_line_for_line(name):
    """Table 2's baseline: the same function, line for line, but the
    imports of the port's runtime in place of the reference's."""
    assert port_lowlevel.__all__ == ref_lowlevel.__all__
    port = _code_lines(getattr(port_lowlevel, name))
    ref = _code_lines(getattr(ref_lowlevel, name))
    assert len(port) == len(ref)
    assert [ln.replace("repro_torch.", "repro.") for ln in port] == ref
    assert not [t for t in threading.enumerate() if t.name == "learner" and t.is_alive()]
