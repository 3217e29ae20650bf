"""Parity of the PyTorch port's flowcheck analyzer (``repro_torch.flow.analysis``)
with the JAX package's on the CPU.

Every case of the reference's ``tests/test_flow_analysis.py`` that needs no
process backend or transport is ported: each builds the same spec with both
packages' ``FlowSpec``, runs both analyzers, and asserts the reference's
own checks on the port's diagnostics plus equal rule ids, severities, nodes,
edges, details, messages and hints.  Two rules differ by design, and are
compared without their texts: ``resource-oversubscription`` counts CUDA
cards (one CPU device without a card) and names ``CUDA_VISIBLE_DEVICES``,
and ``determinism-hazard`` flags torch's global generator where the
reference exempts ``jax.random``.  A parametrised parity holds the port's
audit of its twelve plans (on CPU workers) to the reference's audit of the
same plans.
"""

import json
import os
import random
import types

import numpy as np
import pytest
import torch

import repro.flow.analysis as ref_analysis
import repro.flow.spec as ref_spec
import repro_torch.flow.analysis as port_analysis
import repro_torch.flow.spec as port_spec
from repro_torch.flow.analysis import (
    RULES,
    Diagnostic,
    FlowAnalysisError,
    Severity,
    analyze,
    audit_plans,
)
from repro.flow.plans import PLAN_BUILDERS as REF_PLAN_BUILDERS
from repro.flow.plans import REPLAY_PLANS as REF_REPLAY_PLANS
from repro_torch.flow.plans import PLAN_BUILDERS, REPLAY_PLANS
from repro_torch.flow.spec import FlowSpec

PORT = types.SimpleNamespace(
    FlowSpec=port_spec.FlowSpec, ResourceRef=port_spec.ResourceRef, analyze=port_analysis.analyze
)
REF = types.SimpleNamespace(
    FlowSpec=ref_spec.FlowSpec, ResourceRef=ref_spec.ResourceRef, analyze=ref_analysis.analyze
)

EXPECTED_RULES = {
    "graph-structure",
    "credit-deadlock",
    "unbounded-queue",
    "annotation-lowering",
    "cross-host-placement",
    "pickle-safety",
    "resource-oversubscription",
    "determinism-hazard",
}
# Rules whose texts name the device or RNG touchpoints each package swaps.
SWAPPED_TEXTS = {"resource-oversubscription", "determinism-hazard"}


# --------------------------------------------------------------- fakes
class FakeActor:
    def __init__(self, name, backend="thread"):
        self.name = name
        self.backend_name = backend


class FakeLocalWorker:
    def __init__(self, policy="policy"):
        self.policy = policy


class FakePool:
    """Duck-typed WorkerSet: just enough surface for GraphView introspection."""

    def __init__(self, n=2, backend="thread", local=None):
        self._actors = [FakeActor(f"rollout-{i + 1}", backend) for i in range(n)]
        self._local = local

    def remote_workers(self):
        return list(self._actors)

    def local_worker(self):
        return self._local


def _identity(x):
    return x


def _uses_stdlib_random(batch):
    return random.random()


# Built in isolated namespaces: the rule resolves `random` and `torch`
# through the stage's __globals__, and this module's own imports would
# otherwise decide the classification.
_NP_NS = {"np": np}
exec("def _uses_np_random(batch):\n    return np.random.rand(2)\n", _NP_NS)
_uses_np_random = _NP_NS["_uses_np_random"]
_TORCH_NS = {"torch": torch, "gen": torch.Generator().manual_seed(0)}
exec(
    "def _uses_torch_rand(batch):\n    return torch.rand(2)\n"
    "def _uses_torch_randint(batch):\n    return torch.randint(0, 4, (2,))\n"
    "def _seeds_torch(batch):\n    torch.manual_seed(0)\n    return batch\n"
    "def _threads_generator(batch):\n    return torch.randn(2, generator=gen)\n"
    "def _mixes(batch):\n    return torch.rand(2, generator=gen) + torch.rand(2)\n"
    "def _local_import(batch):\n    import torch as t\n    return batch\n",
    _TORCH_NS,
)


class _TrainStage:
    """A TrainOneStep-shaped stage: accepts the learner-group knobs."""

    num_learners = 1
    microbatch = 1

    def __call__(self, batch):
        return batch


def by_rule(diags, name):
    return [d for d in diags if d.rule == name]


def _key(d):
    key = (d.rule, d.severity, d.node, d.edge, d.details)
    if d.rule in SWAPPED_TEXTS:
        return key
    return key + (d.message, d.hint)


def _both(build):
    """Build the spec with each package, analyze both, hold the port's
    diagnostics to the reference's, and return the port's with the handles
    its builder returned."""
    spec_p, handles = build(PORT)
    spec_r, _ = build(REF)
    got, want = PORT.analyze(spec_p), REF.analyze(spec_r)
    assert [_key(d) for d in got] == [_key(d) for d in want]
    return got, handles


# ---------------------------------------------------------- registry
def test_builtin_rule_registry():
    analyze(FlowSpec("touch"))  # import side effect registers the builtins
    assert EXPECTED_RULES <= set(RULES)
    for r in RULES.values():
        assert r.name and r.description


# ----------------------------------------------------- graph-structure
def test_graph_structure_flags_missing_output_and_double_consumption():
    def build(ns):
        spec = ns.FlowSpec("broken")
        s = spec.from_items([1, 2, 3])
        s.for_each(_identity)
        s.for_each(_identity)  # second consumer of the same edge
        return spec, s

    diags, s = _both(build)
    diags = by_rule(diags, "graph-structure")
    assert any("no output set" in d.message for d in diags)
    dup = [d for d in diags if "consumed 2 times" in d.message]
    assert dup and dup[0].is_error
    assert dup[0].node == s.node_id and dup[0].edge == s.ref
    assert "duplicate" in dup[0].hint


def test_graph_structure_flags_resource_wiring():
    def build(ns):
        spec = ns.FlowSpec("wiring")
        spec.learner_thread(FakePool(), name="idle")  # declared, never wired
        out = spec.from_items([1]).enqueue(ns.ResourceRef(spec, "ghost"))  # undeclared
        spec.set_output(out)
        return spec, None

    diags = by_rule(_both(build)[0], "graph-structure")
    ghost = [d for d in diags if "'ghost'" in d.message]
    assert ghost and ghost[0].is_error and ghost[0].hint
    idle = [d for d in diags if "'idle'" in d.message]
    assert idle and idle[0].severity == Severity.WARN and "wire it" in idle[0].hint


def test_graph_structure_flags_dead_duplicate_port():
    def build(ns):
        spec = ns.FlowSpec("dead-port")
        live, dead = spec.from_items([1]).duplicate(2)
        spec.set_output(live.for_each(_identity))
        return spec, dead

    diags, dead = _both(build)
    [d] = [d for d in by_rule(diags, "graph-structure") if "never consumed" in d.message]
    assert d.severity == Severity.WARN
    assert d.node == dead.node_id and d.edge == dead.ref and d.hint


def test_clean_spec_analyzes_clean():
    def build(ns):
        spec = ns.FlowSpec("clean")
        spec.set_output(spec.from_items([1, 2]).for_each(_identity).report())
        return spec, None

    assert _both(build)[0] == []


# ----------------------------------------------------- credit-deadlock
def test_credit_deadlock_blocking_enqueue_without_dequeue():
    def build(ns):
        spec = ns.FlowSpec("wedge")
        lt = spec.learner_thread(FakePool(), out_policy="block")
        enq = spec.from_items([1], repeat=True).enqueue(lt)  # block=True default
        spec.set_output(enq)
        return spec, enq

    diags, enq = _both(build)
    [d] = by_rule(diags, "credit-deadlock")
    assert d.is_error and d.node == enq.node_id
    assert "no dequeue node drains" in d.message
    assert "spec.dequeue" in d.hint


def test_credit_deadlock_round_robin_union_owns_both_sides():
    def build(ns):
        spec = ns.FlowSpec("rr-cycle")
        lt = spec.learner_thread(FakePool(), out_policy="block")
        enq = spec.from_items([1], repeat=True).enqueue(lt)
        union = spec.concurrently([enq, spec.dequeue(lt)], mode="round_robin")
        spec.set_output(union)
        return spec, union

    diags, union = _both(build)
    [d] = by_rule(diags, "credit-deadlock")
    assert d.is_error and d.node == union.node_id
    assert "round_robin union" in d.message and "concurrently(mode='async')" in d.hint


def test_credit_deadlock_warns_on_starved_credit_window():
    def build(ns):
        spec = ns.FlowSpec("starved")
        s = spec.rollouts(FakePool(n=4), mode="async", credits=2)
        spec.set_output(s.for_each(_identity))
        return spec, s

    diags, s = _both(build)
    [d] = by_rule(diags, "credit-deadlock")
    assert d.severity == Severity.WARN and d.node == s.node_id
    assert "credits=2 is below the 4-shard pool" in d.message
    assert ">= 4" in d.hint


def test_credit_deadlock_quiet_when_cycle_is_drainable():
    def build(ns):
        spec = ns.FlowSpec("drains")
        lt = spec.learner_thread(FakePool())  # default out_policy drops, never wedges
        enq = spec.rollouts(FakePool(n=2), mode="async", credits=2).enqueue(lt)
        spec.set_output(spec.concurrently([enq, spec.dequeue(lt)], mode="round_robin"))
        return spec, None

    assert by_rule(_both(build)[0], "credit-deadlock") == []


# ----------------------------------------------------- unbounded-queue
def test_unbounded_queue_flags_creditless_async_feed():
    def build(ns):
        spec = ns.FlowSpec("unbounded")
        lt = spec.learner_thread(FakePool())
        enq = spec.rollouts(FakePool(), mode="async").enqueue(lt)
        spec.set_output(spec.concurrently([enq, spec.dequeue(lt)]))
        return spec, enq

    diags, enq = _both(build)
    [d] = by_rule(diags, "unbounded-queue")
    assert d.severity == Severity.WARN and d.node == enq.node_id
    assert "no credit bound" in d.message and "credits=" in d.hint


def test_unbounded_queue_quiet_with_credit_bound_or_sync_feed():
    def build(ns):
        spec = ns.FlowSpec("bounded")
        lt = spec.learner_thread(FakePool())
        enq = spec.rollouts(FakePool(n=2), mode="async", credits=4).enqueue(lt)
        sync_enq = spec.rollouts(FakePool(n=2)).enqueue(lt)  # bulk_sync: bounded
        spec.set_output(spec.concurrently([enq, sync_enq, spec.dequeue(lt)]))
        return spec, None

    assert by_rule(_both(build)[0], "unbounded-queue") == []


def test_unbounded_queue_flags_duplicate_into_async_union():
    def build(ns):
        spec = ns.FlowSpec("dup-async")
        a, b = spec.from_items([1], repeat=True).duplicate(2)
        spec.set_output(spec.concurrently([a.for_each(_identity), b], mode="async"))
        return spec, a

    diags, a = _both(build)
    [d] = by_rule(diags, "unbounded-queue")
    assert d.severity == Severity.WARN
    assert d.node == a.node_id and "grows without bound" in d.message
    assert "round_robin" in d.hint


# ------------------------------------------------- annotation-lowering
def test_annotation_lowering_flags_misplaced_and_invalid_knobs():
    def build(ns):
        spec = ns.FlowSpec("bad-annotations")
        s = spec.from_items([1]).for_each(_identity)
        s.annotate(overflow_policy="block", credits=4)  # neither lowers here
        out = s.enqueue(spec.learner_thread(FakePool()))
        out.annotate(overflow_policy="bogus")
        spec.set_output(out)
        return spec, (s, out)

    diags, (s, out) = _both(build)
    diags = by_rule(diags, "annotation-lowering")
    assert all(d.is_error and d.hint for d in diags)
    assert {s.node_id, out.node_id} == {d.node for d in diags}
    assert any("only enqueue nodes lower it" in d.message for d in diags)
    assert any("only gather_async/rollouts/replay" in d.message for d in diags)
    assert any("unknown overflow_policy 'bogus'" in d.message for d in diags)


def test_annotation_lowering_flags_failure_policy_misuse_and_conflict():
    def build(ns):
        pool = FakePool(n=2)
        spec = ns.FlowSpec("fp")
        a = spec.rollouts(pool, failure_policy="restart")
        b = spec.rollouts(pool, failure_policy="drop_shard")  # same pool, conflicts
        mid = spec.from_items([1]).annotate(failure_policy="restart")  # not a source
        bad = spec.rollouts(FakePool()).annotate(failure_policy="explode")
        spec.set_output(spec.concurrently([a, b, mid, bad]))
        return spec, (a, b, mid, bad)

    diags, (a, b, mid, bad) = _both(build)
    diags = by_rule(diags, "annotation-lowering")
    conflict = [d for d in diags if "conflicts with" in d.message]
    assert conflict and conflict[0].severity == Severity.WARN
    assert conflict[0].node == b.node_id and a.node_id in conflict[0].message
    assert any(d.node == mid.node_id and "source actors only" in d.message for d in diags)
    assert any(d.node == bad.node_id and "unknown failure_policy" in d.message for d in diags)


def test_annotation_lowering_learner_knobs():
    def build(ns):
        spec = ns.FlowSpec("learners")
        incapable = spec.from_items([1]).for_each(_identity).learners(2)
        capable = spec.from_items([2]).for_each(_TrainStage()).learners(2).microbatch(2)
        spec.set_output(spec.concurrently([incapable, capable]))
        return spec, incapable

    diags, incapable = _both(build)
    [d] = by_rule(diags, "annotation-lowering")
    assert d.is_error and d.node == incapable.node_id
    assert "no stage of this node accepts" in d.message
    assert "TrainOneStep" in d.hint


def test_annotation_lowering_ctx_stage_is_info_not_error():
    def build(ns):
        spec = ns.FlowSpec("ctx")
        s = spec.from_items([1]).for_each_ctx(lambda rt: _identity, "TrainCtx").learners(2)
        spec.set_output(s)
        return spec, s

    diags, s = _both(build)
    [d] = by_rule(diags, "annotation-lowering")
    assert d.severity == Severity.INFO and d.node == s.node_id


def test_annotation_lowering_vector_knobs():
    def build(ns):
        spec = ns.FlowSpec("vector")
        misplaced = spec.from_items([1]).annotate(vector=4)
        bad_mode = spec.rollouts(FakePool()).annotate(inference="remote")
        no_policy = spec.rollouts(
            FakePool(local=FakeLocalWorker(policy=None)), inference="server"
        )
        spec.set_output(spec.concurrently([misplaced, bad_mode, no_policy]))
        return spec, (misplaced, bad_mode, no_policy)

    diags, (misplaced, bad_mode, no_policy) = _both(build)
    diags = by_rule(diags, "annotation-lowering")
    assert all(d.is_error for d in diags)
    assert any(d.node == misplaced.node_id and "rollouts/" in d.message for d in diags)
    assert any(d.node == bad_mode.node_id and "unknown inference mode" in d.message for d in diags)
    assert any(d.node == no_policy.node_id and "no .policy to" in d.message for d in diags)


# -------------------------------------------------------- pickle-safety
def test_pickle_safety_server_inference_on_process_workers():
    def build(ns):
        spec = ns.FlowSpec("proc-server")
        s = spec.rollouts(FakePool(backend="process", local=FakeLocalWorker()), inference="server")
        spec.set_output(s)
        return spec, s

    diags, s = _both(build)
    [d] = by_rule(diags, "pickle-safety")
    assert d.severity == Severity.WARN and d.node == s.node_id
    assert "pickle" in d.message
    assert "thread-backend" in d.hint


def test_pickle_safety_unpicklable_parallel_stage_and_pull_fn():
    def build(ns):
        spec = ns.FlowSpec("proc-stages")
        stage = (
            spec.rollouts(FakePool(backend="process"), mode="raw")
            .for_each(lambda b: b)  # lambdas do not pickle
            .gather_sync()
        )
        par = spec.par_source(FakePool(backend="process"), pull_fn=lambda a: a)
        spec.set_output(spec.concurrently([stage, par.gather_sync()]))
        return spec, par

    diags, par = _both(build)
    diags = by_rule(diags, "pickle-safety")
    warn = [d for d in diags if d.severity == Severity.WARN]
    info = [d for d in diags if d.severity == Severity.INFO]
    assert warn and "cannot be cloned per shard" in warn[0].message and warn[0].hint
    assert info and info[0].node == par.node_id and "driver-side" in info[0].message


def test_pickle_safety_quiet_on_thread_backends():
    def build(ns):
        spec = ns.FlowSpec("threads")
        s = (
            spec.rollouts(FakePool(local=FakeLocalWorker()), mode="raw")
            .for_each(lambda b: b)
            .gather_sync()
        )
        spec.set_output(s)
        return spec, None

    assert by_rule(_both(build)[0], "pickle-safety") == []


# --------------------------------------- resource-oversubscription
def _too_many_learners(ns, n=999):
    spec = ns.FlowSpec("too-many-learners")
    s = spec.from_items([1]).for_each(_TrainStage()).learners(n)
    spec.learner_thread(FakePool(), name="lt", num_learners=n)
    spec.set_output(s.enqueue(ns.ResourceRef(spec, "lt")))
    return spec, s


def test_oversubscription_flags_learners_beyond_devices():
    diags, s = _both(_too_many_learners)
    diags = by_rule(diags, "resource-oversubscription")
    assert len(diags) == 2 and all(d.is_error for d in diags)
    assert any(d.node == s.node_id for d in diags)
    assert all("CUDA_VISIBLE_DEVICES" in d.hint for d in diags)


@pytest.mark.parametrize("cards,learners,errors", [(0, 1, 0), (0, 2, 2), (4, 4, 0), (4, 5, 2)])
def test_oversubscription_counts_cuda_cards_or_one_cpu_device(monkeypatch, cards, learners, errors):
    """Without a card the learner group has one device, as ``jax.devices()``
    reports one CPU device in the reference; with cards it has their count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    spec, _ = _too_many_learners(PORT, n=learners)
    diags = by_rule(analyze(spec), "resource-oversubscription")
    assert len(diags) == errors
    assert all(f"{max(cards, 1)} visible device" in d.message or
               f"only {max(cards, 1)} device" in d.message for d in diags)


def test_oversubscription_warns_on_cpu_demand():
    ncpu = os.cpu_count()

    def build(ns):
        spec = ns.FlowSpec("cpu-hungry")
        s = spec.rollouts(FakePool(n=4), resources={"num_cpus": ncpu})
        spec.set_output(s)
        return spec, s

    diags, s = _both(build)
    [d] = by_rule(diags, "resource-oversubscription")
    assert d.severity == Severity.WARN and d.node == s.node_id
    assert d.details == {"declared": 4 * ncpu, "available": ncpu}


def test_oversubscription_quiet_within_budget():
    def build(ns):
        spec = ns.FlowSpec("fits")
        spec.set_output(spec.from_items([1]).for_each(_TrainStage()).learners(1))
        return spec, None

    assert by_rule(_both(build)[0], "resource-oversubscription") == []


# ------------------------------------------------- determinism-hazard
def test_determinism_hazard_flags_ambient_rng():
    def build(ns):
        spec = ns.FlowSpec("rng")
        a = spec.from_items([1]).for_each(_uses_stdlib_random)
        b = spec.from_items([2]).filter(_uses_np_random)
        spec.set_output(spec.concurrently([a, b]))
        return spec, (a, b)

    diags, (a, b) = _both(build)
    diags = by_rule(diags, "determinism-hazard")
    assert {d.node for d in diags} == {a.node_id, b.node_id}
    assert all(d.severity == Severity.WARN and "seeded" in d.hint for d in diags)
    assert all("torch.Generator" in d.hint for d in diags)
    assert any("stdlib `random`" in d.message for d in diags)
    assert any("np.random" in d.message for d in diags)


def test_determinism_hazard_quiet_on_seeded_stages():
    # The idiom the hint recommends: thread an explicit Generator through
    # the stage (here via closure) so its body never names `random` at all.
    rng = np.random.default_rng(0)

    def seeded(batch):
        return rng.integers(0, 2)

    def build(ns):
        spec = ns.FlowSpec("seeded")
        spec.set_output(spec.from_items([1]).for_each(seeded))
        return spec, None

    assert by_rule(_both(build)[0], "determinism-hazard") == []


@pytest.mark.parametrize(
    "stage,flagged",
    [("_uses_torch_rand", "global generator"), ("_uses_torch_randint", "global generator"),
     ("_seeds_torch", "torch.manual_seed"), ("_mixes", "global generator"),
     ("_threads_generator", None), ("_local_import", None)],
)
def test_determinism_hazard_flags_torch_global_generator(stage, flagged):
    """The port's swap of the reference's ``jax.random`` exemption: draws
    from torch's global generator (and its global seeding) are flagged like
    ``np.random``'s; a stage that passes a ``torch.Generator`` stays quiet."""
    spec = FlowSpec("torch-rng")
    s = spec.from_items([1]).for_each(_TORCH_NS[stage])
    spec.set_output(s)
    diags = by_rule(analyze(spec), "determinism-hazard")
    if flagged is None:
        assert diags == []
    else:
        [d] = diags
        assert d.severity == Severity.WARN and d.node == s.node_id
        assert flagged in d.message and "torch.Generator" in d.hint


def _real_vs_fake(build_port, build_ref):
    """Analyze the port's spec over a real pool, the reference's over the
    fake pool it stands in for, and hold the two diagnostic lists equal."""
    got = PORT.analyze(build_port(PORT))
    assert [_key(d) for d in got] == [_key(d) for d in REF.analyze(build_ref(REF))]
    return got


def test_pickle_safety_on_a_real_process_backend_pool():
    """The fake's case on a real ``ProcessBackend`` WorkerSet: server
    inference on process workers draws the reference's warning."""
    import torch_chaos

    from repro_torch.core import ProcessBackend, WorkerSet

    ws = WorkerSet.create(
        torch_chaos.make_vec_dummy_worker, 2, backend=ProcessBackend(transport="pickle")
    )
    try:
        assert {a.backend_name for a in ws.remote_workers()} == {"process"}

        def build(pool):
            def _build(ns):
                spec = ns.FlowSpec("proc-server")
                spec.set_output(spec.rollouts(pool, inference="server"))
                return spec

            return _build

        diags = _real_vs_fake(build(ws), build(FakePool(backend="process", local=FakeLocalWorker())))
        [d] = by_rule(diags, "pickle-safety")
        assert d.severity == Severity.WARN and "pickle" in d.message
    finally:
        ws.stop()


# ------------------------------------------------- cross-host-placement
def test_cross_host_flags_undeclared_and_non_source_placement():
    def build(ns):
        spec = ns.FlowSpec("bad-hosts")
        spec.declare_host("box")
        out = spec.rollouts(FakePool(), host="ghost").for_each(_identity).host("box")
        spec.set_output(out)
        return spec, None

    diags = by_rule(_both(build)[0], "cross-host-placement")
    ghost = [d for d in diags if "'ghost'" in d.message and "not declared" in d.message]
    assert ghost and ghost[0].is_error and "declare_host" in ghost[0].hint
    nonsrc = [d for d in diags if "for_each" in d.message]
    assert nonsrc and nonsrc[0].is_error and "source node" in nonsrc[0].hint


def test_cross_host_flags_shm_edge_spanning_fragments():
    def build(ns):
        spec = ns.FlowSpec("shm-span")
        spec.declare_host("box")
        spec.set_output(spec.rollouts(FakePool(backend="process"), host="box"))
        return spec, None

    diags = by_rule(_both(build)[0], "cross-host-placement")
    span = [d for d in diags if "process-backed" in d.message]
    assert span and span[0].is_error
    assert "cannot span the host boundary" in span[0].message
    assert "thread backend" in span[0].hint


def test_cross_host_flags_a_real_process_pool_spanning_fragments():
    """The fake's shm-span case on a real ``ProcessBackend`` pool placed on
    a host: its shared-memory edge cannot span the host boundary."""
    import torch_chaos

    from repro_torch.core import ProcessBackend, WorkerSet

    ws = WorkerSet.create(torch_chaos.make_stub_worker, 2, backend=ProcessBackend(transport="shm"))
    try:
        def build(pool):
            def _build(ns):
                spec = ns.FlowSpec("shm-span")
                spec.declare_host("box")
                spec.set_output(spec.rollouts(pool, host="box"))
                return spec

            return _build

        diags = by_rule(_real_vs_fake(build(ws), build(FakePool(backend="process"))),
                        "cross-host-placement")
        span = [d for d in diags if "process-backed" in d.message]
        assert span and span[0].is_error and "cannot span the host boundary" in span[0].message
    finally:
        ws.stop()


def test_cross_host_flags_server_inference_on_remote_fragment():
    def build(ns):
        spec = ns.FlowSpec("srv-remote")
        spec.declare_host("box")
        pool = FakePool(local=FakeLocalWorker())
        spec.set_output(spec.rollouts(pool, host="box", inference="server"))
        return spec, None

    diags = by_rule(_both(build)[0], "cross-host-placement")
    srv = [d for d in diags if "inference='server'" in d.message]
    assert srv and srv[0].is_error and "driver fragment" in srv[0].message


def test_cross_host_warns_on_conflicting_and_dead_placement():
    def build(ns):
        spec = ns.FlowSpec("host-conflict")
        for h in ("box-a", "box-b", "idle"):  # "idle": declared, never placed on
            spec.declare_host(h)
        pool = FakePool()
        a = spec.rollouts(pool, host="box-a")
        b = spec.rollouts(pool, host="box-b")  # same pool, different host
        spec.set_output(spec.concurrently([a.for_each(_identity), b.for_each(_identity)]))
        return spec, None

    diags = by_rule(_both(build)[0], "cross-host-placement")
    conflict = [d for d in diags if "conflicts with" in d.message]
    assert conflict and conflict[0].severity == Severity.WARN
    dead = [d for d in diags if "'idle'" in d.message]
    assert dead and dead[0].severity == Severity.WARN and "dead" in dead[0].message


def test_cross_host_quiet_on_clean_two_fragment_plan():
    def build(ns):
        spec = ns.FlowSpec("clean-hosts")
        spec.declare_host("box")
        spec.set_output(spec.rollouts(FakePool(), host="box").for_each(_identity))
        return spec, None

    assert not by_rule(_both(build)[0], "cross-host-placement")


# ------------------------------------------------------ engine plumbing
def test_crashing_rule_surfaces_as_analyzer_internal():
    from repro_torch.flow.analysis import rule

    @rule("crashing-rule", "always explodes (test)")
    def _crash(view):
        raise RuntimeError("boom")

    try:
        spec = FlowSpec("crash")
        spec.set_output(spec.from_items([1]))
        [d] = analyze(spec, rules=["crashing-rule"])
        assert d.rule == "analyzer-internal" and d.is_error
        assert "'crashing-rule' crashed" in d.message
    finally:
        del RULES["crashing-rule"]


def test_spec_check_matches_analyze_and_orders_by_severity():
    def build(ns):
        spec = ns.FlowSpec("ordering")
        s = spec.from_items([1]).for_each(_uses_stdlib_random)
        s.annotate(credits="nope")
        spec.set_output(s)
        return spec, spec

    _, spec = _both(build)
    diags = spec.check()
    assert diags == analyze(spec)
    ranks = [Severity.rank(d.severity) for d in diags]
    assert ranks == sorted(ranks) and ranks[0] == Severity.rank(Severity.ERROR)


def test_diagnostic_format_and_json_roundtrip():
    d = Diagnostic(
        "credit-deadlock", Severity.ERROR, "msg", node="n1_enqueue",
        edge=("n0_rollouts", 0), hint="fix it", details={"k": 1},
    )
    text = d.format()
    assert "error[credit-deadlock]" in text and "n1_enqueue" in text
    assert "hint: fix it" in text
    js = d.to_json()
    assert js["rule"] == "credit-deadlock" and js["edge"] == ["n0_rollouts", 0]
    assert json.loads(json.dumps(js)) == js


def test_analyzer_never_crashes_on_arbitrary_annotations():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    WEIRD = [
        {}, {"credits": -1}, {"credits": "many"}, {"overflow_policy": "bogus"},
        {"num_learners": 0}, {"microbatch": "k"}, {"failure_policy": "explode"},
        {"vector": "wide"}, {"inference": 17}, {"inference_credits": 0},
        {"resources": {"num_cpus": 10**6}},
    ]

    @hypothesis.given(st.data())
    @hypothesis.settings(max_examples=30, deadline=None)
    def run(data):
        spec = FlowSpec("prop")
        s = spec.from_items(list(range(1 + data.draw(st.integers(0, 2)))))
        for _ in range(data.draw(st.integers(0, 3))):
            op = data.draw(st.sampled_from(["for_each", "filter", "annotate"]))
            if op == "for_each":
                s = s.for_each(_identity)
            elif op == "filter":
                s = s.filter(_identity)
            else:
                s.annotate(**data.draw(st.sampled_from(WEIRD)))
        if data.draw(st.booleans()):
            spec.set_output(s)
        diags = analyze(spec)
        assert all(isinstance(d, Diagnostic) for d in diags)
        assert not [d for d in diags if d.rule == "analyzer-internal"]

    run()


# ---------------------------------------------- the committed plans gate
@pytest.fixture(scope="module")
def port_audit():
    return audit_plans(device="cpu")


@pytest.fixture(scope="module")
def ref_audit():
    return ref_analysis.audit_plans(plans=sorted(PLAN_BUILDERS))


def test_plan_catalog_is_the_reference_catalog():
    assert set(PLAN_BUILDERS) == set(REF_PLAN_BUILDERS)
    assert REPLAY_PLANS == REF_REPLAY_PLANS


def test_all_ported_plans_are_error_clean(port_audit):
    assert set(port_audit) == set(PLAN_BUILDERS) and len(PLAN_BUILDERS) == 12
    errors = {
        name: [d.format() for d in ds if d.is_error]
        for name, ds in port_audit.items()
        if any(d.is_error for d in ds)
    }
    assert errors == {}
    # The three known warns (blocking learner feeds with credit-unbounded
    # async windows), pinned as the reference pins them.
    for plan in ("apex", "appo", "impala"):
        assert [d.rule for d in port_audit[plan]] == ["unbounded-queue"], plan


@pytest.mark.parametrize("plan", sorted(PLAN_BUILDERS))
def test_audit_matches_reference_plan_by_plan(plan, port_audit, ref_audit):
    got = [(d.rule, d.severity, d.node) for d in port_audit[plan]]
    want = [(d.rule, d.severity, d.node) for d in ref_audit[plan]]
    assert got == want


def test_audit_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audit_plans(plans=["a2c"])


# --------------------------------------------- strict compile + promotion
@pytest.fixture(scope="module")
def pg_workers():
    from repro_torch.core.workers import WorkerSet
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    def mk(i):
        return RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2), algo="pg",
            num_envs=2, rollout_len=8, seed=0, worker_index=i, device="cpu",
        )

    ws = WorkerSet.create(mk, 2)
    yield ws
    ws.stop()


def test_strict_compile_rejects_error_diagnostics(pg_workers):
    spec = FlowSpec("strict-static")
    s = spec.rollouts(pg_workers).for_each(_identity)
    s.annotate(credits=3)  # cannot lower on a for_each: error severity
    spec.set_output(s)
    with pytest.raises(FlowAnalysisError) as ei:
        spec.compile(strict=True)
    assert any(d.rule == "annotation-lowering" for d in ei.value.diagnostics)


def test_strict_compile_builds_a_clean_plan(pg_workers):
    from repro_torch.flow import build_a2c

    compiled = build_a2c(pg_workers).compile(strict=True)
    try:
        assert compiled.diagnostics == []
    finally:
        compiled.stop()


def test_lowering_fallbacks_promote_to_diagnostics(pg_workers):
    spec = FlowSpec("promoted")
    spec.set_output(spec.rollouts(pg_workers).for_each(_identity).learners(2))
    compiled = spec.compile()  # non-strict: lowers, records the degradation
    try:
        fallbacks = by_rule(compiled.diagnostics, "lowering-fallback")
        assert fallbacks and fallbacks[0].is_error
        assert "learner" in fallbacks[0].message
    finally:
        compiled.stop()
    with pytest.raises(FlowAnalysisError):
        spec.compile(strict=True)


def test_algorithm_check_merges_static_and_lowering(pg_workers):
    from repro_torch.flow import Algorithm

    spec = FlowSpec("algo-check")
    spec.set_output(spec.rollouts(pg_workers).for_each(_identity).learners(2))
    with Algorithm.from_plan(spec, pg_workers, own_workers=False) as algo:
        rules = {d.rule for d in algo.check()}
    assert {"annotation-lowering", "lowering-fallback"} <= rules
    with Algorithm.from_plan("a3c", pg_workers, own_workers=False) as algo:
        assert algo.check() == []
