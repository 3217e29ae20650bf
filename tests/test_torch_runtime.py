"""The runtime's own suites on the PyTorch port, held against the reference.

The port's copies of the reference's runtime suites, over ``repro_torch``:

* ``tests/test_actors.py``, ``test_iterators.py``,
  ``test_iterator_properties.py`` and ``test_union_stress.py``: virtual
  actors, the dataflow iterators and their properties, unions and
  ``Concurrently`` under contention;
* ``tests/test_backpressure.py``: credit pools, overflow policies, the
  enqueue telemetry and the flow-level credit and overflow lowering;
* ``tests/test_executor.py`` and ``test_chaos.py`` over the reference's
  backend matrix (thread, process-pickle, process-shm; defined here), with
  the chaos harness from ``torch_chaos.py``, the port-side copy of
  ``tests/chaos.py`` (its three inference chaos cases are ported in
  ``tests/test_torch_serving.py``).

Where a reference suite's result is deterministic, the port's result is
held equal to the reference's from the same seed: the StubWorker streams,
``obs_bases``, and the drop and restart counters.  Process children start
from the fork server (the port's default); one case starts a child by
``spawn``, and ``fork`` is refused.  Every wait on a stream or a child is a
``wait_until`` with a timeout, and every test that waits on a child carries
a ``timeout`` marker.
"""

import functools
import logging
import queue
import threading
import time

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property-based tests need hypothesis")
from hypothesis import given, settings, strategies as st

import repro_torch.core as c
import repro_torch.flow as flow
import torch_chaos as chaos
from conftest import DeterministicClock
from repro_torch.core import (
    ActorDiedError,
    CreditPool,
    Enqueue,
    FailurePolicy,
    ProcessBackend,
    ThreadBackend,
    VirtualActor,
    WorkerSet,
    resolve_backend,
)
from repro_torch.core.actor import ActorPool, create_colocated, get, wait
from repro_torch.core.concurrency import OverflowPolicy
from repro_torch.core.iterators import (
    LocalIterator,
    NextValueNotReady,
    ParallelIterator,
    from_iterators,
)
from repro_torch.core.metrics import (
    CREDIT_STALL_TIME,
    NUM_BYTES_MOVED,
    NUM_CREDIT_STALLS,
    NUM_SAMPLES_DROPPED,
    NUM_SHARDS_DROPPED,
    NUM_WORKER_FAILURES,
    MetricsContext,
    set_metrics_for_thread,
)
from repro_torch.core.operators import ParallelRollouts, TrainOneStep, par_compute_gradients
from repro_torch.flow.spec import FlowSpec
from repro_torch.rl.replay import ReplayBuffer
from repro_torch.rl.sample_batch import SampleBatch

wait_until = DeterministicClock.wait_until

# thread / process+pickle / process+shm: the protocol suites must be
# transport-independent.
BACKEND_MATRIX = chaos.BACKEND_MATRIX
make_backend = chaos.make_backend


@pytest.fixture(params=BACKEND_MATRIX)
def backend(request):
    return make_backend(request.param)


def make_ws(backend, n=2, **supervision):
    return WorkerSet.create(chaos.make_stub_worker, n, backend=backend, **supervision)


def obs_bases(batches):
    """Map each StubWorker batch back to (worker_index, nth_sample)."""
    out = []
    for b in batches:
        first = int(np.asarray(b["obs"])[0])
        out.append((first // 10_000_000, (first % 10_000_000) // 100))
    return out


def pull_until(it, got, done, timeout=20.0):
    """Pull one StubWorker batch at a time into ``got`` until ``done(got)``,
    for at most ``timeout`` seconds; returns whether ``done`` held."""
    return wait_until(
        lambda: done(got) or got.extend(obs_bases(it.take(1))) or done(got),
        timeout=timeout,
        interval=0.0,
    )


# ======================================================================
# Virtual actors (tests/test_actors.py)
# ======================================================================
class Counter:
    def __init__(self):
        self.n = 0
        self.thread_ids = set()

    def incr(self, k=1):
        self.thread_ids.add(threading.get_ident())
        self.n += k
        return self.n

    def slow(self):
        time.sleep(0.05)
        return "slow"

    def fast(self):
        return "fast"

    def boom(self):
        raise ValueError("boom")


def test_serialized_execution_single_thread():
    a = VirtualActor(Counter())
    futs = [a.call("incr") for _ in range(50)]
    assert [f.result() for f in futs] == list(range(1, 51))
    assert len(a.target.thread_ids) == 1  # mailbox thread only
    a.stop()


def test_fifo_ordering_per_actor():
    a = VirtualActor(Counter())
    f1 = a.call("slow")
    f2 = a.call("fast")
    assert f1.result() == "slow"
    assert f2.done()
    a.stop()


def test_exceptions_propagate():
    a = VirtualActor(Counter())
    with pytest.raises(ValueError):
        a.call("boom").result()
    a.stop()


def test_wait_num_returns():
    a = VirtualActor(Counter())
    b = VirtualActor(Counter())
    futs = [a.call("slow"), b.call("fast")]
    ready, pending = wait(futs, num_returns=1)
    assert len(ready) >= 1
    a.stop()
    b.stop()


def test_apply_sees_target():
    a = VirtualActor(Counter())
    assert a.apply(lambda t: t.incr(5)).result() == 5
    a.stop()


def test_pool_broadcast():
    pool = ActorPool.from_targets([Counter(), Counter()])
    assert pool.broadcast_sync("incr") == [1, 1]
    pool.stop()


def test_create_colocated():
    pool = create_colocated(Counter, 3)
    assert len(pool) == 3
    pool.stop()


def test_get_helper():
    a = VirtualActor(Counter())
    assert get([a.call("incr"), a.call("incr")]) == [1, 2]
    assert get(42) == 42
    a.stop()


# ======================================================================
# Dataflow iterators (tests/test_iterators.py)
# ======================================================================
def test_gather_sync_barrier_order():
    it = c.from_iterators([[1, 2, 3], [10, 20, 30]])
    out = it.for_each(lambda x: x * 2).gather_sync().take(6)
    assert out == [2, 20, 4, 40, 6, 60]


def test_gather_async_completion_order():
    it = c.from_iterators([[1, 2, 3], [10, 20, 30]])
    out = it.gather_async(num_async=1).take(6)
    assert sorted(out) == [1, 2, 3, 10, 20, 30]


def test_gather_async_pipelining_depth():
    class Slow:
        def __init__(self, vals):
            self.vals = list(vals)
            self.calls = 0

        def pull(self):
            self.calls += 1
            time.sleep(0.01)
            return self.vals.pop(0)

    pool = ActorPool.from_targets([Slow(range(100))])
    par = ParallelIterator.from_actors(pool, lambda t: t.pull())
    out = par.gather_async(num_async=4).take(4)
    assert out == [0, 1, 2, 3]
    pool.stop()


def test_for_each_runs_on_source_actor():
    class Holder:
        def __init__(self, name):
            self.name = name

        def pull(self):
            return 1

    pool = ActorPool.from_targets([Holder("a"), Holder("b")])
    par = ParallelIterator.from_actors(pool, lambda t: (t.name, t.pull()))
    out = par.gather_sync().take(2)
    assert sorted(out) == [("a", 1), ("b", 1)]
    pool.stop()


def test_stateful_fn_cloned_per_shard():
    class Count:
        def __init__(self):
            self.n = 0

        def __call__(self, x):
            self.n += 1
            return self.n

    it = c.from_iterators([[0] * 3, [0] * 3])
    out = it.for_each(Count()).gather_sync().take(6)
    assert out == [1, 1, 2, 2, 3, 3]


def test_zip_with_source_actor():
    it = c.from_iterators([[1], [2]])
    out = it.gather_async().zip_with_source_actor().take(2)
    assert sorted(v for v, _ in out) == [1, 2]
    assert all(a is not None for _, a in out)


def test_union_round_robin_weights():
    a = c.from_items([1] * 6)
    b = c.from_items([2] * 3)
    out = a.union(b, deterministic=True, round_robin_weights=[2, 1]).take(9)
    assert out[:3] == [1, 1, 2]


def test_union_async_merges_all():
    out = c.from_items([1, 2, 3]).union(c.from_items([10, 20])).take(5)
    assert sorted(out) == [1, 2, 3, 10, 20]


def test_union_rr_sentinel_starvation():
    """A not-ready branch must not block the union (cold replay case)."""
    state = {"n": 0}

    def gen():
        while True:
            state["n"] += 1
            yield NextValueNotReady() if state["n"] < 10 else 99

    starved = LocalIterator(gen)
    fast = c.from_items(list(range(100)))
    out = fast.union(starved, deterministic=True).take(12)
    assert 99 in out or all(isinstance(x, int) for x in out)
    assert 0 in out and 1 in out


def test_duplicate_both_consumers_see_all():
    d1, d2 = c.from_items([1, 2, 3]).duplicate(2)
    assert d1.take(3) == [1, 2, 3]
    assert d2.take(3) == [1, 2, 3]


def test_batch_and_flatten():
    assert c.from_items(list(range(6))).batch(2).take(3) == [[0, 1], [2, 3], [4, 5]]
    assert c.from_items([[1, 2], [3]]).flatten().take(3) == [1, 2, 3]


def test_filter():
    out = c.from_items(list(range(10))).filter(lambda x: x % 2 == 0).take(5)
    assert out == [0, 2, 4, 6, 8]


def test_concurrently_output_indexes():
    out = c.Concurrently(
        [c.from_items([1, 2]), c.from_items([9, 8])],
        mode="round_robin",
        output_indexes=[1],
    ).take(2)
    assert out == [9, 8]


def test_union_parallel_iterators():
    p1 = c.from_iterators([[1, 2]])
    p2 = c.from_iterators([[10, 20]])
    assert sorted(p1.union(p2).gather_sync().take(4)) == [1, 2, 10, 20]


# ======================================================================
# Iterator properties (tests/test_iterator_properties.py)
# ======================================================================
shard_lists = st.lists(
    st.lists(st.integers(min_value=0, max_value=1000), min_size=1, max_size=8),
    min_size=1,
    max_size=4,
)


@given(shard_lists)
@settings(max_examples=25, deadline=None)
def test_gather_sync_is_round_interleaved(shards):
    n_rounds = min(len(s) for s in shards)
    expected = [s[r] for r in range(n_rounds) for s in shards]
    assert c.from_iterators(shards).gather_sync().take(len(expected)) == expected


@given(shard_lists, st.integers(min_value=1, max_value=4))
@settings(max_examples=25, deadline=None)
def test_gather_async_yields_exact_multiset(shards, num_async):
    total = sum(len(s) for s in shards)
    out = c.from_iterators(shards).gather_async(num_async=num_async).take(total)
    assert sorted(out) == sorted(x for s in shards for x in s)


@given(shard_lists)
@settings(max_examples=25, deadline=None)
def test_gather_async_preserves_per_shard_order(shards):
    tagged = [[(i, x) for x in s] for i, s in enumerate(shards)]
    total = sum(len(s) for s in shards)
    out = c.from_iterators(tagged).gather_async().take(total)
    for i, s in enumerate(tagged):
        assert [item for item in out if item[0] == i] == s


@given(
    st.lists(st.integers(min_value=0, max_value=9), min_size=2, max_size=30),
    st.integers(min_value=1, max_value=3),
    st.integers(min_value=1, max_value=3),
)
@settings(max_examples=25, deadline=None)
def test_round_robin_weight_ratio(items, w1, w2):
    a = c.from_items([("a", x) for x in items])
    b = c.from_items([("b", x) for x in items])
    u = a.union(b, deterministic=True, round_robin_weights=[w1, w2])
    take_n = min(len(items) // max(w1, w2), 2) * (w1 + w2)
    if take_n == 0:
        return
    out = u.take(take_n)
    assert [t for t, _ in out[: w1 + w2]] == ["a"] * w1 + ["b"] * w2


@given(shard_lists)
@settings(max_examples=15, deadline=None)
def test_union_async_exact_multiset(shards):
    locals_ = [c.from_items(s) for s in shards]
    total = sum(len(s) for s in shards)
    out = locals_[0].union(*locals_[1:]).take(total)
    assert sorted(out) == sorted(x for s in shards for x in s)


@given(st.lists(st.integers(), min_size=1, max_size=20), st.integers(min_value=2, max_value=4))
@settings(max_examples=25, deadline=None)
def test_duplicate_fanout_identical(items, n):
    for d in c.from_items(items).duplicate(n):
        assert d.take(len(items)) == items


@given(st.lists(st.integers(), min_size=0, max_size=30), st.integers(min_value=1, max_value=7))
@settings(max_examples=25, deadline=None)
def test_batch_partitions_stream(items, n):
    batches = c.from_items(items).batch(n).take(len(items))
    assert [x for b in batches for x in b] == items[: (len(items) // n) * n]
    assert all(len(b) == n for b in batches)


# ======================================================================
# Union stress (tests/test_union_stress.py)
# ======================================================================
def union_driver_threads():
    return [t for t in threading.enumerate() if t.name.startswith("union-drive")]


def delayed_branch(clock, branch_id, n_items, max_delay=0.002):
    """A branch emitting (branch_id, seq) with seeded per-item delays."""
    rng = clock.rng.__class__(clock.seed * 7919 + branch_id)

    def _delay(item):
        time.sleep(rng.random() * max_delay)
        return item

    return c.from_items([(branch_id, i) for i in range(n_items)]).for_each(_delay)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_branches,n_items", [(8, 40), (12, 25)])
def test_union_async_no_lost_or_duplicated_items(deterministic_clock, n_branches, n_items):
    branches = [delayed_branch(deterministic_clock, b, n_items) for b in range(n_branches)]
    merged = branches[0].union(*branches[1:], deterministic=False)
    out = merged.take(n_branches * n_items)
    expected = {(b, i) for b in range(n_branches) for i in range(n_items)}
    assert len(out) == len(expected) and set(out) == expected
    assert len(set(out)) == len(out)
    for b in range(n_branches):
        assert [i for bb, i in out if bb == b] == list(range(n_items))
    merged.close()


@pytest.mark.timeout(120)
def test_concurrently_async_under_contention(deterministic_clock):
    n_branches, n_items = 9, 30
    ops = [delayed_branch(deterministic_clock, b, n_items) for b in range(n_branches)]
    merged = c.Concurrently(ops, mode="async")
    out = merged.take(n_branches * n_items)
    assert set(out) == {(b, i) for b in range(n_branches) for i in range(n_items)}
    assert len(out) == n_branches * n_items
    merged.close()


@pytest.mark.timeout(120)
def test_concurrently_round_robin_under_contention(deterministic_clock):
    n_branches, n_items = 8, 20
    ops = [
        delayed_branch(deterministic_clock, b, n_items, max_delay=0.001)
        for b in range(n_branches)
    ]
    merged = c.Concurrently(ops, mode="round_robin")
    out = merged.take(n_branches * n_items)
    assert set(out) == {(b, i) for b in range(n_branches) for i in range(n_items)}
    assert out[:n_branches] == [(b, 0) for b in range(n_branches)]
    merged.close()


@pytest.mark.timeout(60)
def test_union_async_driver_threads_joined_on_close(deterministic_clock):
    baseline = len(union_driver_threads())
    merged = c.Concurrently(
        [c.from_items([(b, i) for i in range(1000)]) for b in range(6)],
        mode="async",
    )
    merged.take(30)
    assert len(union_driver_threads()) > baseline
    merged.close()
    assert wait_until(lambda: len(union_driver_threads()) <= baseline, timeout=5.0)


@pytest.mark.timeout(60)
def test_union_async_driver_threads_joined_on_exhaustion(deterministic_clock):
    baseline = len(union_driver_threads())
    merged = c.from_items([1, 2]).union(c.from_items([3, 4]), deterministic=False)
    assert sorted(merged.take(10)) == [1, 2, 3, 4]
    assert wait_until(lambda: len(union_driver_threads()) <= baseline, timeout=5.0)
    merged.close()


@pytest.mark.timeout(60)
def test_nested_union_close_propagates(deterministic_clock):
    baseline = len(union_driver_threads())
    inner = c.from_items(range(1000)).union(c.from_items(range(1000)))
    outer = inner.union(c.from_items(range(1000)))
    outer.take(10)
    outer.close()
    assert wait_until(lambda: len(union_driver_threads()) <= baseline, timeout=5.0)


@pytest.mark.timeout(120)
def test_algorithm_stop_joins_flow_threads(deterministic_clock):
    baseline = len(union_driver_threads())
    ws = WorkerSet.create(chaos.make_stub_worker, 2)
    spec = FlowSpec("teardown")
    a = spec.rollouts(ws, mode="async").for_each(flow.pure(lambda b: b.count), label="count")
    bq = spec.rollouts(ws, mode="bulk_sync").for_each(flow.pure(lambda b: b.count), label="count2")
    spec.set_output(spec.concurrently([a, bq], mode="async"))
    algo = flow.Algorithm.from_plan(spec, ws)
    algo.iterate(5)
    assert len(union_driver_threads()) > baseline
    algo.stop()
    assert wait_until(lambda: len(union_driver_threads()) <= baseline, timeout=5.0)


# ======================================================================
# Credit-based backpressure (tests/test_backpressure.py)
# ======================================================================
def test_credit_pool_bounds_and_resizes():
    pool = CreditPool(2)
    assert pool.try_acquire() and pool.try_acquire()
    assert not pool.try_acquire()
    pool.release()
    assert pool.try_acquire()
    pool.resize(None)
    assert all(pool.try_acquire() for _ in range(64))
    with pytest.raises(ValueError):
        CreditPool(0)


def test_overflow_policy_validation():
    for p in ("block", "drop_newest", "drop_oldest"):
        assert OverflowPolicy.validate(p) == p
    with pytest.raises(ValueError, match="unknown overflow policy"):
        OverflowPolicy.validate("explode")


@pytest.mark.timeout(60)
def test_gather_async_credits_cap_inflight():
    par = from_iterators([iter(range(0, 100)), iter(range(100, 200))])
    it = par.gather_async(num_async=2, credits=1, metrics_key="g")
    got = it.take(40)
    assert len(got) == 40
    assert {x // 100 for x in got} == {0, 1}, "a starved shard never ran"
    assert it.metrics.counters[NUM_CREDIT_STALLS] > 0
    for branch in (0, 1):
        seq = [x for x in got if x // 100 == branch]
        assert seq == sorted(seq)


@pytest.mark.timeout(60)
def test_gather_async_default_credits_match_legacy_window():
    par = from_iterators([iter(range(10)), iter(range(10, 20))])
    assert sorted(par.gather_async(num_async=2).take(20)) == list(range(20))


@pytest.mark.timeout(60)
def test_gather_async_credit_stall_time_accrues():
    par = from_iterators([iter(range(50)), iter(range(100, 150))])
    it = par.gather_async(num_async=1, credits=1)
    out = []
    for x in iter(it):
        time.sleep(0.002)  # slow consumer
        out.append(x)
        if len(out) >= 20:
            break
    assert it.metrics.counters.get(CREDIT_STALL_TIME, 0) > 0


def _ctx():
    m = MetricsContext()
    set_metrics_for_thread(m)
    return m


def test_enqueue_drop_newest_counts_drops():
    m = _ctx()
    q = queue.Queue(maxsize=2)
    enq = Enqueue(q, policy="drop_newest", metrics_key="k")
    for i in range(5):
        assert enq(i) == i
    assert q.qsize() == 2
    assert enq.num_dropped == 3
    assert m.counters[NUM_SAMPLES_DROPPED] == 3
    assert [q.get(), q.get()] == [0, 1]


def test_enqueue_drop_oldest_keeps_freshest():
    m = _ctx()
    q = queue.Queue(maxsize=2)
    enq = Enqueue(q, policy="drop_oldest")
    for i in range(5):
        enq(i)
    assert [q.get(), q.get()] == [3, 4]
    assert enq.num_dropped == 3
    assert m.counters[NUM_SAMPLES_DROPPED] == 3


@pytest.mark.timeout(60)
def test_enqueue_block_stalls_and_records():
    m = _ctx()
    q = queue.Queue(maxsize=1)
    enq = Enqueue(q, policy="block", check=lambda: True)
    enq(0)
    drained = []

    def _drain():
        time.sleep(0.05)
        drained.append(q.get())
        drained.append(q.get())

    t = threading.Thread(target=_drain)
    t.start()
    enq(1)  # must block until the consumer frees a slot
    t.join()
    assert drained == [0, 1]
    assert m.counters[NUM_CREDIT_STALLS] >= 1
    assert m.counters.get(CREDIT_STALL_TIME, 0) > 0
    assert enq.num_dropped == 0


def test_enqueue_legacy_block_flag_still_works():
    q = queue.Queue(maxsize=4)
    assert Enqueue(q, block=False).policy == "drop_newest"
    assert Enqueue(q, block=True).policy == "block"
    with pytest.raises(ValueError, match="not both"):
        Enqueue(q, block=True, policy="drop_oldest")


def test_enqueue_records_bytes_and_occupancy():
    m = _ctx()
    q = queue.Queue(maxsize=8)
    enq = Enqueue(q, policy="drop_newest", metrics_key="feed")
    batch = SampleBatch({"obs": np.zeros(1024, np.float64)})
    enq(batch)
    assert m.counters["bytes_moved/feed"] == batch.size_bytes()
    assert m.gauges["queue_occupancy/feed"] == 1


def test_enqueue_stamps_queue_wait():
    _ctx()
    q = queue.Queue(maxsize=8)
    batch = SampleBatch({"obs": np.zeros(8, np.float64)})
    Enqueue(q, policy="drop_newest")((batch, None))
    assert isinstance(batch._enqueued_at, float)


def stub_ws(n=2):
    return WorkerSet.create(chaos.make_stub_worker, n)


def replay_pool(n=1):
    return ActorPool.from_targets(
        [ReplayBuffer(capacity=4096, sample_batch_size=16, learning_starts=16, seed=i)
         for i in range(n)],
        name="replay",
    )


@pytest.mark.timeout(120)
def test_apex_drop_counts_reach_train_results():
    """The lossy Ape-X feed surfaces ``num_samples_dropped`` in train()
    results, with the sample->learn latency stream populated."""
    ws = stub_ws(2)
    algo = flow.Algorithm.from_plan(
        "apex", ws, replay_pool(1), target_update_freq=10_000, block_on_enqueue=False,
    )
    algo.resources["learner"].inqueue.maxsize = 1  # so that drops happen
    result = {"r": algo.train()}

    def _dropped_and_timed():
        result["r"] = r = algo.train()
        return (
            r["counters"].get(NUM_SAMPLES_DROPPED, 0) > 0
            and r["latencies"].get("sample_to_learn_s", {}).get("count", 0) > 0
        )

    try:
        assert wait_until(_dropped_and_timed, timeout=60.0, interval=0.0)
        r = result["r"]
        lat = r["latencies"]["sample_to_learn_s"]
        assert lat["count"] > 0 and 0 <= lat["p50"] <= lat["p99"]
        assert r["counters"][NUM_BYTES_MOVED] > 0
    finally:
        algo.stop()


@pytest.mark.timeout(120)
def test_enqueue_policy_annotation_lowered():
    ws = stub_ws(1)
    spec = FlowSpec("annotated")
    learner = spec.learner_thread(ws)
    feed = (
        spec.rollouts(ws, mode="async", num_async=1)
        .enqueue(learner, block=True)
        .annotate(overflow_policy="drop_oldest")
    )
    out = spec.dequeue(learner).for_each(flow.pure(lambda item: item[1].count), label="count")
    spec.set_output(spec.concurrently([feed, out], mode="async", output_indexes=[1]))
    compiled = spec.compile()
    enq_nodes = [n for n in compiled.spec.nodes.values() if n.kind == "enqueue"]
    assert enq_nodes and enq_nodes[0].annotations["overflow_policy"] == "drop_oldest"
    algo = flow.Algorithm(compiled, ws)
    assert algo.train() == 8  # StubWorker batch size
    algo.stop()


@pytest.mark.timeout(120)
def test_credits_annotation_lowered_and_visible():
    ws = stub_ws(2)
    spec = FlowSpec("credited")
    out = spec.rollouts(ws, mode="async", num_async=2, credits=1).for_each(
        flow.pure(lambda b: b.count), label="count"
    )
    spec.set_output(out)
    algo = flow.Algorithm.from_plan(spec, ws)
    assert all(r == 8 for r in algo.iterate(12))
    assert algo.compiled.iterator().metrics.counters[NUM_CREDIT_STALLS] > 0
    algo.stop()


@pytest.mark.timeout(120)
def test_to_dot_edge_labels_carry_bytes():
    ws = stub_ws(2)
    spec = FlowSpec("dotted")
    out = spec.rollouts(ws, mode="async", num_async=1).for_each(
        flow.pure(lambda b: b.count), label="count"
    )
    spec.set_output(out.report(ws))
    algo = flow.Algorithm.from_plan(spec, ws)
    bare = algo.to_dot()
    assert "KB" not in bare and "MB" not in bare
    algo.iterate(6)
    dot = algo.to_dot(with_metrics=True)
    assert any(unit in dot for unit in ("KB", "MB", 'B"')), dot
    algo.stop()


@pytest.mark.timeout(120)
def test_train_results_include_gauges_and_latencies_sections():
    ws = stub_ws(2)
    algo = flow.Algorithm.from_plan("a3c", ws)
    result = algo.train()
    assert "gauges" in result and "latencies" in result
    algo.stop()


@pytest.mark.timeout(120)
def test_learner_out_queue_drop_oldest_policy():
    from repro_torch.core.learner_thread import LearnerThread

    lt = LearnerThread(chaos.StubWorker(0), out_queue_size=2, out_policy="drop_oldest")
    for i in range(5):
        lt._put_out((None, None, i))
    assert lt.outqueue.qsize() == 2
    assert lt.outqueue.get()[2] == 3
    assert lt.outqueue.get()[2] == 4
    assert lt.num_out_dropped == 3


# ======================================================================
# Executor runtime over the backend matrix (tests/test_executor.py)
# ======================================================================
def test_backend_resolution():
    assert isinstance(resolve_backend(None), ThreadBackend)
    assert isinstance(resolve_backend("process"), ProcessBackend)
    b = ProcessBackend()
    assert resolve_backend(b) is b
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("gpu")


def test_process_backend_refuses_fork_and_unknown_start_methods():
    """The port never forks the driver: a child forked after CUDA is
    initialised cannot use the card."""
    with pytest.raises(ValueError, match="cannot use the card"):
        ProcessBackend(start_method="fork")
    with pytest.raises(ValueError, match="unknown start method"):
        ProcessBackend(start_method="threads")
    assert ProcessBackend().start_method is None  # forkserver
    assert ProcessBackend(start_method="spawn").start_method == "spawn"


def _run_mode(ws, mode):
    if mode == "raw_sync":
        it = ParallelRollouts(ws, mode="raw").gather_sync()
        return [obs_bases([b])[0] for b in it.take(6)]
    if mode == "raw_batch":
        it = ParallelRollouts(ws, mode="raw").batch_across_shards()
        return [obs_bases(bs) for bs in it.take(3)]
    if mode == "bulk_sync":
        it = ParallelRollouts(ws, mode="bulk_sync")
        return [int(np.asarray(b["obs"]).sum()) for b in it.take(3)]
    it = ParallelRollouts(ws, mode="async", num_async=1)
    return obs_bases(it.take(6))


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["bulk_sync", "async", "raw_sync", "raw_batch"])
def test_rollout_matrix_identical_across_backends(mode):
    """Every rollout mode yields the same stream under every backend (async
    modulo completion order), and the same stream as the reference's."""
    import chaos as ref_chaos
    import repro.core as rc

    def run(ws):
        try:
            return _run_mode(ws, mode)
        finally:
            ws.stop()

    outs = [run(make_ws(make_backend(p), n=2)) for p in BACKEND_MATRIX]
    ref = run(rc.WorkerSet.create(ref_chaos.make_stub_worker, 2, backend="thread"))
    if mode != "async":
        for got in outs:
            assert got == ref
    else:
        for got in outs:
            assert len(got) == 6 and {w for w, _ in got} <= {1, 2}
            for w in (1, 2):
                seq = [k for wi, k in got if wi == w]
                assert seq == list(range(1, len(seq) + 1))


@pytest.mark.timeout(120)
def test_rollout_matrix_expected_values(backend):
    ws = make_ws(backend, n=2)
    it = ParallelRollouts(ws, mode="raw").gather_sync()
    assert obs_bases(it.take(6)) == [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (2, 3)]
    ws.stop()


@pytest.mark.timeout(120)
def test_stub_streams_equal_the_reference_bit_for_bit(backend):
    """Every column of the port's StubWorker stream, through each backend,
    equals the reference's thread stream from the same indices."""
    import chaos as ref_chaos
    import repro.core as rc

    def take(ws, n=6):
        try:
            return ParallelRollouts(ws, mode="raw").gather_sync().take(n)
        finally:
            ws.stop()

    got = take(make_ws(backend, n=2))
    want = take(rc.WorkerSet.create(ref_chaos.make_stub_worker, 2, backend="thread"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g.keys()) == set(w.keys())
        for k in w.keys():
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.timeout(120)
def test_weight_sync_roundtrip(backend):
    ws = make_ws(backend, n=2)
    ws.local_worker().set_weights(np.array([3.0, 4.0], np.float32))
    ws.sync_weights()
    for a in ws.remote_workers():
        np.testing.assert_array_equal(a.sync("get_weights"), np.array([3.0, 4.0], np.float32))
    ws.stop()


@pytest.mark.timeout(120)
def test_gradient_path(backend):
    ws = make_ws(backend, n=2)
    for grads_infos in par_compute_gradients(ws).batch_across_shards().take(2):
        assert len(grads_infos) == 2
        for grads, info in grads_infos:
            ws.local_worker().apply_gradients(grads)
            assert info["batch_count"] == 8
    assert not np.array_equal(ws.local_worker().get_weights(), np.zeros(2))
    ws.stop()


@pytest.mark.timeout(120)
def test_learn_on_batch_path(backend):
    ws = make_ws(backend, n=1)
    batch = ws.remote_workers()[0].sync("sample")
    assert ws.local_worker().learn_on_batch(batch)["trained"] == 8
    ws.stop()


def _metrics_for(it, metrics_module=None):
    """A fresh metrics context bound to this thread and to ``it`` (from
    ``metrics_module``: the port's by default, the reference's for its
    iterators)."""
    ctx = MetricsContext() if metrics_module is None else metrics_module.MetricsContext()
    (set_metrics_for_thread if metrics_module is None else metrics_module.set_metrics_for_thread)(ctx)
    it.metrics = ctx
    return ctx


def step_until(it, done, timeout=20.0):
    """Pull one item at a time from ``it`` until ``done()``, for at most
    ``timeout`` seconds; returns whether ``done`` held."""
    return wait_until(lambda: done() or (bool(it.take(1)) and done()), timeout=timeout, interval=0.0)


@pytest.mark.timeout(120)
def test_restart_policy_keeps_shard(backend):
    """A worker failing once under max_restarts keeps its shard: the item is
    lost, the stream continues, and the failure is counted."""
    factory = chaos.ChaosFactory(chaos.make_stub_worker, {1: [chaos.RaiseOnNth("sample", n=2)]})
    ws = WorkerSet.create(
        factory, 2, backend=backend, max_restarts=100, backoff_base=0.0, failure_policy="restart",
    )
    it = ParallelRollouts(ws, mode="async", num_async=1)
    metrics = _metrics_for(it)
    got = obs_bases(it.take(8))
    assert pull_until(
        it, got, lambda g: {w for w, _ in g} == {1, 2} and metrics.counters[NUM_WORKER_FAILURES] > 0
    )
    assert metrics.counters[NUM_WORKER_FAILURES] >= 1
    assert metrics.counters[NUM_SHARDS_DROPPED] == 0
    [a1] = [a for a in ws.remote_workers() if a.name == "rollout-1"]
    assert a1.num_restarts >= 1 and a1.alive
    ws.stop()


@pytest.mark.timeout(120)
def test_drop_shard_policy_shrinks_stream(backend):
    factory = chaos.ChaosFactory(
        chaos.make_stub_worker, {1: [chaos.RaiseOnNth("sample", n=3, sticky=True)]}
    )
    ws = WorkerSet.create(factory, 2, backend=backend, failure_policy="drop_shard")
    it = ParallelRollouts(ws, mode="async", num_async=1)
    metrics = _metrics_for(it)
    got = obs_bases(it.take(12))
    assert pull_until(it, got, lambda g: metrics.counters[NUM_SHARDS_DROPPED] > 0)
    assert metrics.counters[NUM_SHARDS_DROPPED] == 1
    assert metrics.counters[NUM_WORKER_FAILURES] >= 1
    got += obs_bases(it.take(4))
    assert [w for w, _ in got].count(1) <= 2
    assert [w for w, _ in got][-4:] == [2, 2, 2, 2]
    ws.stop()


@pytest.mark.timeout(120)
def test_raise_policy_propagates(backend):
    factory = chaos.ChaosFactory(
        chaos.make_stub_worker, {1: [chaos.RaiseOnNth("sample", n=1, exc=ValueError)]}
    )
    ws = WorkerSet.create(factory, 1, backend=backend)
    it = ParallelRollouts(ws, mode="async")
    with pytest.raises(ValueError, match="chaos"):
        it.take(2)
    ws.stop()


def _budget_exhaustion(core, metrics_module, harness, backend):
    """The sticky-fault restart scenario, in either package: (shards
    dropped, restarts of worker 1, healthy workers, worker 1 alive)."""
    factory = harness.ChaosFactory(
        harness.make_stub_worker, {1: [harness.RaiseOnNth("sample", n=1, sticky=True)]}
    )
    ws = core.WorkerSet.create(
        factory, 2, backend=backend, max_restarts=2, backoff_base=0.0, failure_policy="restart",
    )
    try:
        it = core.ParallelRollouts(ws, mode="async", num_async=1)
        metrics = _metrics_for(it, metrics_module)
        got = obs_bases(it.take(8))
        assert {w for w, _ in got} == {2}
        assert pull_until(it, got, lambda g: metrics.counters[NUM_SHARDS_DROPPED] > 0)
        [a1] = [a for a in ws.remote_workers() if a.name == "rollout-1"]
        return (
            metrics.counters[NUM_SHARDS_DROPPED], a1.num_restarts, ws.num_healthy_workers(),
            a1.alive,
        )
    finally:
        ws.stop()


@pytest.mark.timeout(120)
def test_restart_budget_exhaustion_drops_shard(backend):
    """Sticky fault + restart policy: the supervisor burns its budget, the
    actor dies, and the gather loop drops the shard."""
    import repro_torch.core.metrics as metrics_module

    assert _budget_exhaustion(c, metrics_module, chaos, backend) == (1, 2, 1, False)


@pytest.mark.timeout(120)
def test_drop_and_restart_counters_equal_the_reference(backend):
    """The drop and restart counters of the budget-exhaustion scenario equal
    the reference's, from the same fault plan."""
    import chaos as ref_chaos
    import repro.core as rc
    import repro.core.metrics as ref_metrics
    import repro_torch.core.metrics as metrics_module

    want = _budget_exhaustion(rc, ref_metrics, ref_chaos, "thread")
    assert _budget_exhaustion(c, metrics_module, chaos, backend) == want


@pytest.mark.timeout(120)
def test_recover_heals_dead_worker(backend):
    factory = chaos.ChaosFactory(
        chaos.make_stub_worker, {1: [chaos.RaiseOnNth("sample", n=1, sticky=True)]}
    )
    ws = WorkerSet.create(
        factory, 2, backend=backend, max_restarts=1, backoff_base=0.0, failure_policy="restart",
    )
    it = ParallelRollouts(ws, mode="async", num_async=1)
    it.take(6)
    assert step_until(it, lambda: ws.num_healthy_workers() < 2)
    assert ws.num_healthy_workers() == 1
    report = ws.recover()
    assert report["restarted"] or report["replaced"]
    assert ws.num_healthy_workers() == 2
    # The healed worker rejoins the running stream, fails again on its fresh
    # injector's 1st call, burns the budget again and dies again.
    [a1] = [a for a in ws.remote_workers() if a.name == "rollout-1"]
    assert step_until(it, lambda: not a1.alive), "recovered worker never rejoined the live stream"
    ws.stop()


@pytest.mark.timeout(120)
def test_kill_and_dead_futures(backend):
    ws = make_ws(backend, n=2)
    victim = ws.remote_workers()[0]
    victim.kill()
    assert not victim.alive
    with pytest.raises(ActorDiedError):
        victim.call("sample").result(timeout=5)
    assert ws.num_healthy_workers() == 1
    ws.sync_weights()  # skips the corpse instead of raising
    ws.stop()


@pytest.mark.timeout(120)
def test_elastic_add_workers_mid_stream(backend):
    ws = make_ws(backend, n=2)
    it = ParallelRollouts(ws, mode="async", num_async=1)
    assert {w for w, _ in obs_bases(it.take(4))} <= {1, 2}
    ws.add_workers(1)
    later = []
    assert pull_until(it, later, lambda g: 3 in {w for w, _ in g}), (
        "new worker never joined the stream"
    )
    ws.stop()


@pytest.mark.timeout(120)
def test_elastic_remove_workers_mid_stream(backend):
    """The removed worker contributes at most its in-flight item; both
    survivors show up in the tail (pulled until they do, not a fixed 10
    items: the reference's fixed count is its flaky thread case)."""
    ws = make_ws(backend, n=3)
    it = ParallelRollouts(ws, mode="async", num_async=1)
    it.take(6)
    assert ws.remove_workers(1) == ["rollout-3"]
    tail = obs_bases(it.take(10))
    assert pull_until(it, tail, lambda g: {1, 2} <= {w for w, _ in g})
    assert [w for w, _ in tail].count(3) <= 1
    ws.stop()


def test_remove_workers_keeps_at_least_one(backend):
    ws = make_ws(backend, n=1)
    with pytest.raises(ValueError, match="at least one"):
        ws.remove_workers(1)
    ws.stop()


def test_enqueue_drop_counts_surface_in_metrics():
    metrics = MetricsContext()
    set_metrics_for_thread(metrics)
    q = queue.Queue(maxsize=1)
    enq = Enqueue(q, block=False)
    for i in range(3):
        assert enq(i) == i
    assert enq.num_dropped == 2
    assert metrics.counters[NUM_SAMPLES_DROPPED] == 2
    set_metrics_for_thread(None)


def test_virtual_actor_argument_validation():
    with pytest.raises(ValueError, match="exactly one"):
        VirtualActor()
    with pytest.raises(ValueError, match="exactly one"):
        VirtualActor(object(), factory=object)
    with pytest.raises(ValueError, match="factory"):
        VirtualActor(object(), max_restarts=1)
    with pytest.raises(ValueError, match="unknown failure policy"):
        VirtualActor(object(), failure_policy="retry")


def test_process_backend_requires_picklable_factory():
    with pytest.raises(Exception):
        VirtualActor(factory=lambda: object(), backend="process")


def test_failure_policy_validation():
    assert FailurePolicy.validate("drop_shard") == "drop_shard"
    with pytest.raises(ValueError):
        FailurePolicy.validate("explode")


@pytest.mark.timeout(120)
def test_spawn_started_child_serves_the_stub_stream():
    """``start_method="spawn"`` is accepted: a fresh interpreter per child
    serves the same stream as the fork server's children."""
    ws = WorkerSet.create(
        chaos.make_stub_worker, 1, backend=ProcessBackend(transport="shm", start_method="spawn")
    )
    try:
        (a,) = ws.remote_workers()
        b = a.sync("sample")
        np.testing.assert_array_equal(
            b["obs"], np.arange(8, dtype=np.float64) + chaos.expected_obs_base(1, 1)
        )
    finally:
        ws.stop()


@pytest.mark.timeout(180)
def test_server_inference_falls_back_on_process_workers(caplog):
    """Actor handles don't pickle across the RPC boundary: process-backed
    workers keep vectorization but fall back to local inference, loudly
    (``tests/test_vector_rollout.py``'s case on the port)."""
    from repro_torch.core.operators import configure_vectorized_rollouts
    from repro_torch.rl import DummyPolicy, InferenceActor, InferenceClient

    ws = WorkerSet.create(
        chaos.make_vec_dummy_worker, 1, backend=ProcessBackend(transport="pickle")
    )
    try:
        client = InferenceClient(InferenceActor(lambda: DummyPolicy(4, 2), device="cpu"))
        with caplog.at_level(logging.WARNING):
            acks = configure_vectorized_rollouts(
                ws, vector=2, inference="server", inference_clients=[client]
            )
        assert acks == [{"vector": 2, "inference": "local", "decode": "forward"}]
        assert "fall back to local inference" in caplog.text
        b = next(iter(ParallelRollouts(ws, mode="bulk_sync")))
        assert b.count == 2 * 8  # vectorization still applied
    finally:
        ws.stop()


# ======================================================================
# Chaos over the backend matrix (tests/test_chaos.py)
# ======================================================================
def build_stub_plan(ws, failure_policy="drop_shard"):
    """Async rollouts -> TrainOneStep (local learn + weight broadcast) ->
    metrics report, over StubWorkers."""
    spec = FlowSpec("chaos_plan")
    out = (
        spec.rollouts(ws, mode="async", num_async=1, failure_policy=failure_policy)
        .for_each(TrainOneStep(ws))
    )
    spec.set_output(out.report(ws))
    return spec


def _train_until(algo, done, timeout=30.0):
    state = {"r": algo.train()}

    def step():
        if done(state["r"]):
            return True
        state["r"] = algo.train()
        return done(state["r"])

    assert wait_until(step, timeout=timeout, interval=0.0)
    return state["r"]


def _kill_2_of_4(core, fl, harness, backend):
    """Kill 2 of 4 workers mid-plan in either package; returns the drop
    counters and whether training went on."""
    factory = harness.ChaosFactory(
        harness.make_stub_worker,
        {
            2: [harness.RaiseOnNth("sample", n=3, sticky=True, message="node-loss")],
            4: [harness.RaiseOnNth("sample", n=4, sticky=True, message="node-loss")],
        },
        seed=7,
    )
    ws = core.WorkerSet.create(factory, 4, backend=backend, failure_policy="drop_shard")
    spec = fl.FlowSpec("chaos_plan")
    out = spec.rollouts(ws, mode="async", num_async=1, failure_policy="drop_shard").for_each(
        core.TrainOneStep(ws)
    )
    spec.set_output(out.report(ws))
    algo = fl.Algorithm.from_plan(spec, ws, own_workers=True)
    try:
        result = _train_until(algo, lambda r: r["counters"].get(NUM_SHARDS_DROPPED, 0) >= 2)
        dropped = result["counters"][NUM_SHARDS_DROPPED]
        failures = result["counters"][NUM_WORKER_FAILURES]
        before = result["counters"]["num_steps_trained"]
        for _ in range(6):
            result = algo.train()
        return {
            "dropped": dropped,
            "failures_at_least_2": failures >= 2,
            "trained_on": result["counters"]["num_steps_trained"] > before,
            "dropped_after": result["counters"][NUM_SHARDS_DROPPED],
            "weights_moved": float(np.asarray(ws.local_worker().get_weights())[0]) > 0,
            "healthy": ws.num_healthy_workers(),  # a raising target stays alive
        }
    finally:
        algo.stop()


@pytest.mark.chaos
@pytest.mark.timeout(180)
def test_kill_2_of_4_workers_mid_plan_completes_training(backend):
    """Killing 2 of 4 workers mid-plan completes training with the shrunken
    shard set and records the failures, as the reference's run does."""
    import chaos as ref_chaos
    import repro.core as rc
    import repro.flow as rflow

    got = _kill_2_of_4(c, flow, chaos, backend)
    assert got == {
        "dropped": 2, "failures_at_least_2": True, "trained_on": True,
        "dropped_after": 2, "weights_moved": True, "healthy": 4,
    }
    assert got == _kill_2_of_4(rc, rflow, ref_chaos, "thread")


@pytest.mark.chaos
@pytest.mark.timeout(180)
def test_algorithm_recover_after_worker_death(backend):
    factory = chaos.ChaosFactory(
        chaos.make_stub_worker, {1: [chaos.RaiseOnNth("sample", n=2, sticky=True)]},
    )
    ws = WorkerSet.create(
        factory, 2, backend=backend, max_restarts=1, backoff_base=0.0, failure_policy="restart",
    )
    algo = flow.Algorithm.from_plan(build_stub_plan(ws, "restart"), ws)
    try:
        _train_until(algo, lambda r: ws.num_healthy_workers() < 2)
        assert ws.num_healthy_workers() == 1
        report = algo.recover()
        assert report["restarted"] or report["replaced"]
        assert ws.num_healthy_workers() == 2
        algo.train()  # still trains after recovery
    finally:
        algo.stop()


@pytest.mark.chaos
@pytest.mark.timeout(180)
def test_elastic_resize_through_algorithm(backend):
    ws = WorkerSet.create(chaos.make_stub_worker, 2, backend=backend)
    algo = flow.Algorithm.from_plan(build_stub_plan(ws, "raise"), ws)
    try:
        algo.train()
        assert algo.add_workers(2) == ["rollout-3", "rollout-4"]
        assert len(ws.remote_workers()) == 4

        def admitted():  # new workers received the canonical weights
            algo.train()
            w3 = [a for a in ws.remote_workers() if a.name == "rollout-3"]
            return bool(w3) and float(np.asarray(w3[0].sync("get_weights"))[0]) > 0

        assert wait_until(admitted, timeout=20.0, interval=0.0)
        assert algo.remove_workers(2) == ["rollout-4", "rollout-3"]
        assert len(ws.remote_workers()) == 2
        algo.train()
    finally:
        algo.stop()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_hang_does_not_block_async_gather():
    release = threading.Event()
    factory = chaos.ChaosFactory(
        chaos.make_stub_worker, {1: [chaos.Hang("sample", n=2, duration=60.0, release=release)]},
    )
    ws = WorkerSet.create(factory, 2, failure_policy="drop_shard")
    try:
        it = ParallelRollouts(ws, mode="async", num_async=1)
        t0 = time.time()
        got = it.take(10)
        assert time.time() - t0 < 10.0, "hung worker stalled the stream"
        assert {int(np.asarray(b["obs"])[0]) // 10_000_000 for b in got[-6:]} == {2}
    finally:
        release.set()
        ws.stop()


@pytest.mark.chaos
def test_slow_worker_is_deterministic_and_stream_completes():
    def run():
        factory = chaos.ChaosFactory(
            chaos.make_stub_worker, {1: [chaos.SlowWorker("sample", mean_delay=0.002)]}, seed=123,
        )
        ws = WorkerSet.create(factory, 2)
        try:
            it = ParallelRollouts(ws, mode="raw").gather_sync()
            return [int(np.asarray(b["obs"])[0]) for b in it.take(8)]
        finally:
            ws.stop()

    first, second = run(), run()
    assert first == second
    assert first == [chaos.expected_obs_base(w, n) for n in (1, 2, 3, 4) for w in (1, 2)]


@pytest.mark.chaos
def test_injector_transparent_without_faults():
    w = chaos.FaultInjector(chaos.StubWorker(3), [], seed=0)
    assert w.index == 3
    assert w.sample().count == 8
    assert w.episode_stats()["episodes"] == 1


@pytest.mark.chaos
def test_raise_on_nth_is_exact():
    w = chaos.FaultInjector(
        chaos.StubWorker(1), [chaos.RaiseOnNth("sample", n=3, exc=ValueError)], seed=0
    )
    assert w.sample().count == 8
    assert w.sample().count == 8
    with pytest.raises(ValueError, match="call #3"):
        w.sample()
    assert w.sample().count == 8
    assert w.fault_counts() == {"sample": 4}


@pytest.mark.chaos
def test_sticky_fault_simulates_death():
    w = chaos.FaultInjector(
        chaos.StubWorker(1), [chaos.RaiseOnNth("sample", n=2, sticky=True)], seed=0
    )
    w.sample()
    for _ in range(3):
        with pytest.raises(RuntimeError):
            w.sample()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_restart_window_forgives_spaced_failures():
    """With ``restart_window_s`` the restart counter resets after a healthy
    interval: a worker failing once per window restarts indefinitely."""
    a = VirtualActor(
        factory=functools.partial(chaos.make_paced_worker, 1),
        name="windowed", max_restarts=1, backoff_base=0.0, restart_window_s=0.2,
    )
    try:
        for _ in range(4):  # 4 spaced failures >> max_restarts=1
            assert a.sync("tick") >= 1
            with pytest.raises(RuntimeError, match="paced failure"):
                a.sync("tick", fail=True)
            assert wait_until(lambda: a.alive, timeout=10.0), (
                "supervisor did not heal a within-budget failure"
            )
            time.sleep(0.25)  # a healthy window passes -> budget forgiven
        assert a.num_restarts == 4
        assert a.sync("tick") >= 1
    finally:
        a.stop()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_restart_window_still_exhausts_on_crash_loop():
    a = VirtualActor(
        factory=functools.partial(chaos.make_paced_worker, 1),
        name="crash-loop", max_restarts=2, backoff_base=0.0, restart_window_s=60.0,
    )
    try:
        for _ in range(10):
            if not a.alive:
                break
            with pytest.raises(RuntimeError):
                a.sync("tick", fail=True)
            time.sleep(0.01)  # let the mailbox thread finish the rebuild
        assert not a.alive
        assert a.num_restarts == 2
    finally:
        a.stop()


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_process_worker_kill_and_recover_roundtrip():
    """True process loss: kill the OS process, then recover() the set; the
    replacement child starts from the fork server."""
    ws = WorkerSet.create(chaos.make_stub_worker, 2, backend="process")
    try:
        victim = ws.remote_workers()[0]
        victim.kill()
        assert ws.num_healthy_workers() == 1
        report = ws.recover()
        assert report["restarted"] == ["rollout-1"]
        assert ws.num_healthy_workers() == 2
        assert victim.sync("sample").count == 8
    finally:
        ws.stop()
