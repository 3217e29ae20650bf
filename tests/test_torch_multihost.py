"""Multi-host fragments and the process rows of the determinism matrix, on
the PyTorch port.

The port's copy of ``tests/test_multihost.py``: each test crosses a real OS
process boundary.  ``spec.declare_host`` plus a ``host=`` placement make
``compile()`` launch a host process (``start_local_host``, spawn-started),
rehome the annotated source pool onto its ``RemoteBackend``, and route every
sample through the length-prefixed ``SocketTransport``:

* the two-fragment PPO plan equals the same plan run single-host;
* a machine loss (the host process killed) shrinks the shard set under
  ``drop_shard`` and training goes on;
* the remote round trip serves the worker protocol, and host death is
  noticed by the heartbeat alone;
* ``rehome`` moves a live actor across backends.

Then the process rows (``process-pickle``, ``process-shm``) of
``tests/test_rollout_determinism.py``'s backend matrix, which
``tests/test_torch_determinism.py`` leaves out: on StubEnv + DummyPolicy
(seed 21, 2 workers, 4 lanes, 8 steps, 2 rounds) the vectorized and per-env
engines give the reference's thread stream through the process backends.
Keys, actions, dones, ``eps_id`` and obs are equal in value (the port's
actions are int64 where the reference's are int32, as
``tests/test_torch_determinism.py`` compares them); rewards and the
advantages and returns made from them are within 1e-6 (torch's ``tanh``,
one ulp from XLA's; ``ROADMAP.md``'s deliberate differences), and bitwise
equal to the port's own thread stream.
"""

import functools
import os

import numpy as np
import pytest

import repro_torch.flow as flow
import torch_chaos as chaos
from conftest import DeterministicClock
from repro_torch.core import ParallelRollouts, ProcessBackend, WorkerSet
from repro_torch.core.actor import VirtualActor
from repro_torch.core.executor import ActorDiedError
from repro_torch.core.metrics import NUM_SHARDS_DROPPED
from repro_torch.core.operators import TrainOneStep
from repro_torch.core.remote import RemoteBackend, start_local_host
from repro_torch.flow.plans import build_ppo
from repro_torch.flow.spec import FlowSpec

pytestmark = [pytest.mark.multihost, pytest.mark.timeout(300)]

wait_until = DeterministicClock.wait_until

HOST = "rollout-box"
# StubEnv's reward is torch's tanh, one ulp from XLA's on some inputs: these
# columns are held to the reference at REWARD_TOL, every other one bitwise.
REWARD_TOL = 1e-6
FLOAT_COLUMNS = {"rewards", "advantages", "returns"}


def run_ppo(host=None, iters=3):
    """Train the PPO plan for ``iters`` rounds; return per-round counters
    and the learner's final weights.  With ``host`` set, the rollout
    fragment runs on a driver-managed host process, checked to have crossed
    the boundary (remote backend, distinct PID) first."""
    ws = WorkerSet.create(chaos.make_ppo_worker, 2)
    spec = build_ppo(ws, train_batch_size=64, num_sgd_iter=2, sgd_minibatch_size=32, host=host)
    if host is not None:
        spec.declare_host(host)
    algo = flow.Algorithm.from_plan(spec, ws, own_workers=True)
    try:
        c = algo.compiled
        errors = [d.format() for d in c.diagnostics if d.is_error]
        assert not errors, errors
        if host is not None:
            assert set(c.fragments) == {None, host}
            handle = c.host_handles[host]
            assert handle.alive and handle.pid != os.getpid()
            for a in ws.remote_workers():
                assert a.backend_name == "remote"
        rounds = []
        for _ in range(iters):
            counters = algo.train()["counters"]
            rounds.append({k: counters[k] for k in ("num_steps_sampled", "num_steps_trained")})
        weights = ws.local_worker().get_weights()
        return rounds, weights
    finally:
        algo.stop()


def test_two_fragment_ppo_trains_with_single_host_parity():
    """The rollout fragment in its own OS process, the learner on the
    driver, joined only by the localhost socket: the same counters as the
    single-host run, and the same learner weights bit for bit (seeded
    bulk-sync rollouts are deterministic)."""
    import torch

    from repro_torch.tree import tree_leaves

    single, w_single = run_ppo(host=None)
    multi, w_multi = run_ppo(host=HOST)
    assert multi == single
    assert multi[-1]["num_steps_sampled"] == 3 * 64
    for a, b in zip(tree_leaves(w_multi), tree_leaves(w_single)):
        assert torch.equal(a, b)


def test_machine_loss_of_rollout_fragment_shrinks_shard_set():
    """Kill the rollout fragment's host mid-training: under drop_shard the
    gather loop drops its shards and training continues on the driver-side
    survivors -- a machine loss, not a worker loss."""
    ws_remote = WorkerSet.create(chaos.make_stub_worker, 2, failure_policy="drop_shard")
    ws_local = WorkerSet.create(chaos.make_stub_worker, 2, failure_policy="drop_shard")
    spec = FlowSpec("machine_loss")
    spec.declare_host(HOST)
    remote = spec.rollouts(ws_remote, mode="async", num_async=1, failure_policy="drop_shard", host=HOST)
    local = spec.rollouts(ws_local, mode="async", num_async=1, failure_policy="drop_shard")
    out = spec.concurrently([remote, local], mode="async").for_each(TrainOneStep(ws_local))
    spec.set_output(out.report(ws_local))
    algo = flow.Algorithm.from_plan(spec, ws_local, own_workers=False)
    try:
        state = {"r": algo.train()}  # both fragments feeding
        for a in ws_remote.remote_workers():
            assert a.backend_name == "remote"

        chaos.kill_fragment(algo.compiled, HOST)

        def dropped_both():
            if state["r"]["counters"].get(NUM_SHARDS_DROPPED, 0) >= 2:
                return True
            state["r"] = algo.train()
            return state["r"]["counters"].get(NUM_SHARDS_DROPPED, 0) >= 2

        assert wait_until(dropped_both, timeout=60.0, interval=0.0)
        result = state["r"]
        assert result["counters"][NUM_SHARDS_DROPPED] == 2
        assert ws_remote.num_healthy_workers() == 0  # the whole machine died
        assert ws_local.num_healthy_workers() == 2
        before = result["counters"]["num_steps_trained"]
        for _ in range(4):
            result = algo.train()
        assert result["counters"]["num_steps_trained"] > before
    finally:
        algo.stop()
        ws_remote.stop()
        ws_local.stop()


def test_remote_backend_actor_roundtrip_and_stub_stream():
    """A VirtualActor on RemoteBackend serves the full worker protocol from
    another process, with the StubWorker stream intact across the wire."""
    handle = start_local_host()
    try:
        a = VirtualActor(
            factory=functools.partial(chaos.make_stub_worker, 3),
            name="remote-stub", backend=RemoteBackend(address=handle.address),
        )
        try:
            b = a.sync("sample")
            assert b.count == 8
            np.testing.assert_array_equal(
                np.asarray(b["obs"]), np.arange(8, dtype=np.float64) + chaos.expected_obs_base(3, 1)
            )
            a.sync("set_weights", np.array([5.0, 6.0], np.float32))
            np.testing.assert_array_equal(np.asarray(a.sync("get_weights")), [5.0, 6.0])
            assert a.apply(lambda w: w.sample().count).result() == 8
        finally:
            a.stop()
    finally:
        handle.stop()


def test_remote_backend_detects_host_death():
    """Killing the host: the heartbeat marks the cell dead with no traffic,
    and the next dispatch raises through supervision."""
    handle = start_local_host()
    backend = RemoteBackend(address=handle.address, heartbeat_interval=0.2)
    a = VirtualActor(
        factory=functools.partial(chaos.make_stub_worker, 1), name="doomed", backend=backend,
    )
    try:
        assert a.sync("sample").count == 8
        handle.kill()
        assert wait_until(lambda: not a._cell.alive, timeout=15.0, interval=0.05)
        with pytest.raises((ActorDiedError, RuntimeError)):
            a.sync("sample")
        assert not a.alive
    finally:
        a.stop()


def test_rehome_moves_live_actor_across_backends():
    """rehome() swaps a live actor's cell onto another backend: the target
    is rebuilt from the factory on the new host and serves at once; a
    second rehome brings it to a process cell."""
    handle = start_local_host()
    try:
        a = VirtualActor(factory=functools.partial(chaos.make_stub_worker, 2), name="mover")
        try:
            assert a.backend_name == "thread"
            assert a.sync("sample").count == 8
            a.rehome(RemoteBackend(address=handle.address))
            assert a.backend_name == "remote"
            b = a.sync("sample")  # fresh target: call counters restart at 1
            np.testing.assert_array_equal(
                np.asarray(b["obs"]), np.arange(8, dtype=np.float64) + chaos.expected_obs_base(2, 1)
            )
            a.rehome(ProcessBackend(transport="shm"))
            assert a.backend_name == "process"
            np.testing.assert_array_equal(
                np.asarray(a.sync("sample")["obs"]),
                np.arange(8, dtype=np.float64) + chaos.expected_obs_base(2, 1),
            )
        finally:
            a.stop()
    finally:
        handle.stop()


def _live_children(pid: int) -> list:
    """Pids of the live (not zombie) processes whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = open(f"/proc/{entry}/stat").read()
            except OSError:
                continue
            state, ppid = stat.rsplit(")", 1)[1].split()[:2]
            if int(ppid) == pid and state != "Z":
                out.append(int(entry))
    return out


def test_stop_helper_processes_leaves_no_process():
    """stop_helper_processes() ends a host, a spawned child left running and
    the fork server with its child and the resource tracker, and waits for
    each: nothing under the driver is left.  A later cell starts a fresh
    fork server."""
    from multiprocessing import forkserver, resource_tracker

    from repro_torch.core import stop_helper_processes

    handle = start_local_host()
    served = VirtualActor(factory=functools.partial(chaos.make_stub_worker, 1),
                          backend=ProcessBackend(transport="shm"))
    spawned = VirtualActor(factory=functools.partial(chaos.make_stub_worker, 2),
                           backend=ProcessBackend(start_method="spawn"))
    try:
        assert served.sync("sample").count == spawned.sync("sample").count == 8
        server = forkserver._forkserver._forkserver_pid
        tracker = resource_tracker._resource_tracker._pid
        assert server in _live_children(os.getpid()) and tracker in _live_children(os.getpid())
        assert _live_children(server)  # the served cell's child
        stop_helper_processes(timeout=10.0)
        assert _live_children(os.getpid()) == []
        assert not handle.alive and not served._cell.alive and not spawned._cell.alive
        assert forkserver._forkserver._forkserver_pid is None
        assert resource_tracker._resource_tracker._pid is None
    finally:
        served.stop()
        spawned.stop()
        handle.stop()
    again = VirtualActor(factory=functools.partial(chaos.make_stub_worker, 3),
                         backend=ProcessBackend(transport="pickle"))
    try:
        assert again.sync("sample").count == 8
    finally:
        again.stop()


def test_host_launch_failure_degrades_to_the_driver():
    """An unreachable external host: the rehome fails with one error
    diagnostic, and the fragment stays on the driver's backend and still
    trains."""
    ws = WorkerSet.create(chaos.make_stub_worker, 1)
    spec = FlowSpec("unreachable")
    spec.declare_host("gone", address="127.0.0.1:1")
    out = spec.rollouts(ws, mode="async", num_async=1, host="gone").for_each(TrainOneStep(ws))
    spec.set_output(out.report(ws))
    algo = flow.Algorithm.from_plan(spec, ws, own_workers=True)
    try:
        errors = [d for d in algo.compiled.diagnostics if d.is_error]
        assert len(errors) == 1
        assert "could not rehome onto host 'gone'" in errors[0].message
        assert "unreachable" in errors[0].message
        assert ws.remote_workers()[0].backend_name == "thread"
        assert algo.train()["counters"]["num_steps_trained"] > 0
    finally:
        algo.stop()


# ============================ process rows of tests/test_rollout_determinism.py
PROCESS_ROWS = chaos.BACKEND_MATRIX[1:]
_backend = chaos.make_backend


def _stream(factory, backend, rounds=2):
    ws = WorkerSet.create(factory, 2, backend=backend)
    try:
        it = iter(ParallelRollouts(ws, mode="bulk_sync"))
        return [next(it) for _ in range(rounds)]
    finally:
        ws.stop()


def _reference_thread_stream(engine, rounds=2):
    import repro.core as rc
    import repro.rl as rrl

    cls = {"vectorized": rrl.VectorizedRolloutWorker, "per_env": rrl.PerEnvRolloutWorker}[engine]

    def factory(i):
        return cls(rrl.StubEnv(max_steps=6), rrl.DummyPolicy(4, 2), algo="pg",
                   num_envs=4, rollout_len=8, seed=21, worker_index=i)

    ws = rc.WorkerSet.create(factory, 2, backend="thread")
    try:
        it = iter(rc.ParallelRollouts(ws, mode="bulk_sync"))
        return [next(it) for _ in range(rounds)]
    finally:
        ws.stop()


def assert_batches_identical(a, b, ctx=""):
    assert set(a.keys()) == set(b.keys()), ctx
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{ctx}:{k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx}:{k}")


def assert_matches_reference(got, want, ctx=""):
    assert set(got.keys()) == set(want.keys()), ctx
    for k in want:
        w = np.asarray(want[k])
        if k in FLOAT_COLUMNS:
            np.testing.assert_allclose(got[k], w, atol=REWARD_TOL, rtol=0, err_msg=f"{ctx}:{k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{ctx}:{k}")


@pytest.mark.parametrize("backend_param", PROCESS_ROWS)
def test_vectorized_bit_reproduces_per_env_stream(backend_param):
    """Same seed => bit-identical streams from both engines through a
    process backend, equal to the reference's thread stream
    (``FLOAT_COLUMNS`` to ``REWARD_TOL``)."""
    vec = _stream(chaos.make_stub_dummy_vectorized, _backend(backend_param))
    per = _stream(chaos.make_stub_dummy_per_env, _backend(backend_param))
    assert len(vec) == len(per) == 2
    for i, (bv, bp) in enumerate(zip(vec, per)):
        assert_batches_identical(bv, bp, f"{backend_param} round {i}")
    total = float(np.sum([np.sum(b["rewards"]) for b in vec]))
    assert total == float(np.sum([np.sum(b["rewards"]) for b in per]))
    for engine, got in (("vectorized", vec), ("per_env", per)):
        want = _reference_thread_stream(engine)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_matches_reference(g, w, f"{engine} {backend_param} round {i}")


def _train_metrics(factory, backend, iters=2):
    ws = WorkerSet.create(factory, 2, backend=backend)
    algo = flow.Algorithm.from_plan("ppo", ws, train_batch_size=64, num_sgd_iter=1, own_workers=True)
    try:
        out = []
        for _ in range(iters):
            r = algo.train()
            out.append({"counters": dict(r["counters"]), "loss": r["info"].get("loss"),
                        "episodes": r["episodes"]})
        return out
    finally:
        algo.stop()


@pytest.mark.parametrize("backend_param", PROCESS_ROWS)
def test_train_metrics_identical_vectorized_vs_per_env(backend_param):
    """Full Algorithm runs on a process backend: per-iteration counters,
    learner loss and episode stats are identical for the two engines."""
    mv = _train_metrics(chaos.make_stub_dummy_vectorized, _backend(backend_param))
    mp = _train_metrics(chaos.make_stub_dummy_per_env, _backend(backend_param))
    for i, (a, b) in enumerate(zip(mv, mp)):
        assert a["counters"] == b["counters"], f"round {i}"
        assert a["loss"] == b["loss"], f"round {i}"
        assert a["episodes"] == b["episodes"], f"round {i}"


def test_streams_identical_across_backends():
    """The transport matrix moves identical bytes: the vectorized stream
    through each process row equals the thread row bit for bit, and the
    reference's thread stream (``FLOAT_COLUMNS`` to ``REWARD_TOL``)."""
    ref = _stream(chaos.make_stub_dummy_vectorized, "thread")
    want = _reference_thread_stream("vectorized")
    for param in PROCESS_ROWS:
        got = _stream(chaos.make_stub_dummy_vectorized, _backend(param))
        for i, (a, b, w) in enumerate(zip(ref, got, want)):
            assert_batches_identical(a, b, f"thread-vs-{param} round {i}")
            assert_matches_reference(b, w, f"reference-vs-{param} round {i}")
