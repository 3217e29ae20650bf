"""The paper's algorithm suite as declarative flow graphs (PyTorch port).

Each ``build_*`` function assembles a ``FlowSpec`` — the graph the paper
draws in Figures 9–12, as a value you can inspect (``to_dot()``), optimize
(stage fusion), and lower (``compile()``); ``repro_torch.flow.Algorithm``
is the run-facade.  The port carries ``build_ppo`` (Fig 10b), its
language-model variant ``build_ppo_lm``, and the asynchronous learner-thread
pipelines ``build_impala`` (Fig 11) and ``build_appo``; the other builders
of ``repro/flow/plans.py`` follow their workers and buffers.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.metrics import STEPS_TRAINED_COUNTER, get_metrics
from repro_torch.core.operators import ConcatBatches, StandardizeFields, TrainOneStep
from repro_torch.core.workers import WorkerSet
from repro_torch.flow.spec import FlowSpec, pure

__all__ = [
    "PLAN_BUILDERS",
    "REPLAY_PLANS",
    "build_appo",
    "build_impala",
    "build_ppo",
    "build_ppo_lm",
]


# --------------------------------------------------------------------- PPO
def build_ppo(
    workers: WorkerSet,
    train_batch_size: int = 4000,
    num_sgd_iter: int = 8,
    sgd_minibatch_size: int = 128,
    num_learners: int = 0,
    microbatch: int = 0,
    vector: int = 0,
    inference: str = None,
    inference_replicas: int = 0,
    inference_routing: str = None,
    failure_policy: str = None,
    host: str = None,
) -> FlowSpec:
    """Synchronous sample -> concat -> standardize -> multi-epoch SGD.

    ``num_learners``/``microbatch`` annotate the TrainOneStep node
    (``stream.learners(n).microbatch(k)``); ``compile()`` lowers the
    annotations onto a sharded SPMD learner group (ISSUE 4).

    ``vector``/``inference`` annotate the rollouts node with the vectorized
    rollout engine (ISSUE 5): N synchronized env lanes per worker with one
    batched policy dispatch per step, optionally served by a decoupled
    InferenceActor (``inference='server'``).  ``inference_replicas``/
    ``inference_routing`` scale that into a multi-replica serving tier
    behind an ``InferenceRouter`` (ISSUE 9); ``failure_policy`` on the
    rollouts node doubles as the replica-loss policy.

    ``host`` places the rollout fragment on a declared host (ISSUE 7): the
    caller must also ``spec.declare_host(host)`` on the returned spec, and
    ``compile()`` rehomes the rollout actors onto that host's
    ``RemoteBackend`` so samples cross the socket transport.
    """
    spec = FlowSpec("ppo")
    train_op = (
        spec.rollouts(
            workers, mode="bulk_sync", vector=vector or None, inference=inference,
            inference_replicas=inference_replicas or None,
            inference_routing=inference_routing,
            failure_policy=failure_policy,
            host=host,
        )
        .for_each(ConcatBatches(train_batch_size), label=f"ConcatBatches({train_batch_size})")
        .for_each(StandardizeFields(["advantages"]))
        .for_each(
            TrainOneStep(
                workers,
                num_sgd_iter=num_sgd_iter,
                sgd_minibatch_size=sgd_minibatch_size,
            )
        )
    )
    if num_learners:
        train_op = train_op.learners(num_learners)
    if microbatch:
        train_op = train_op.microbatch(microbatch)
    spec.set_output(train_op.report(workers))
    return spec


# --------------------------------------------------------------- PPO on an LM
def build_ppo_lm(
    workers: WorkerSet,
    train_batch_size: int = 256,
    num_sgd_iter: int = 4,
    sgd_minibatch_size: int = 64,
    num_learners: int = 0,
    microbatch: int = 0,
    vector: int = 0,
    inference: str = None,
    inference_replicas: int = 0,
    inference_routing: str = None,
    decode: str = "cache",
) -> FlowSpec:
    """PPO on a language-model workload (RLHF-style token generation).

    Same dataflow shape as ``build_ppo`` (sample -> concat -> standardize ->
    multi-epoch SGD), but the rollouts node carries ``decode='cache'``:
    ``compile()`` lowers it onto the stateful-policy protocol so each env
    lane generates tokens through a per-lane KV cache (prefill once per
    episode, then one ``ops.decode_attention`` step per action) instead of
    re-running the O(S) forward every token.  ``decode='forward'`` takes the
    no-cache path; workers whose policy lacks the protocol fall back to it.
    """
    spec = FlowSpec("ppo_lm")
    train_op = (
        spec.rollouts(
            workers, mode="bulk_sync", vector=vector or None, inference=inference,
            inference_replicas=inference_replicas or None,
            inference_routing=inference_routing,
            decode=decode,
        )
        .for_each(ConcatBatches(train_batch_size), label=f"ConcatBatches({train_batch_size})")
        .for_each(StandardizeFields(["advantages"]))
        .for_each(
            TrainOneStep(
                workers,
                num_sgd_iter=num_sgd_iter,
                sgd_minibatch_size=sgd_minibatch_size,
            )
        )
    )
    if num_learners:
        train_op = train_op.learners(num_learners)
    if microbatch:
        train_op = train_op.microbatch(microbatch)
    spec.set_output(train_op.report(workers))
    return spec


# ------------------------------------------------------------------- IMPALA
def build_impala(
    workers: WorkerSet,
    train_batch_size: int = 512,
    num_async: int = 2,
    broadcast_interval: int = 1,
    enqueue_policy: str = None,
    rollout_credits: int = None,
    num_learners: int = 0,
    microbatch: int = 0,
    vector: int = 0,
    inference: str = None,
    name: str = "impala",
) -> FlowSpec:
    """Async rollouts -> learner thread -> periodic weight broadcast.

    ``enqueue_policy``/``rollout_credits`` expose the data-plane
    backpressure knobs; the default blocking enqueue backpressures the
    rollout pipeline when the learner saturates.  ``num_learners``/
    ``microbatch`` would shard the learner thread's update onto an SPMD
    learner group, which is not ported: the learner thread raises
    ``NotImplementedError``.  ``vector``/``inference`` configure the
    vectorized rollout engine on the sampling side — the many-shard async
    pipeline with N env lanes per shard is the high-env-count IMPALA
    scenario (``inference='server'`` is not ported and raises).
    """
    spec = FlowSpec(name)
    learner = spec.learner_thread(
        workers, num_learners=num_learners, microbatch=microbatch
    )

    enqueue_op = (
        spec.rollouts(
            workers, mode="async", num_async=num_async, credits=rollout_credits,
            vector=vector or None, inference=inference,
        )
        .for_each(ConcatBatches(train_batch_size), label=f"ConcatBatches({train_batch_size})")
        .enqueue(learner, block=True, policy=enqueue_policy)
    )

    # The broadcast gate reads the learner thread's dirty bit, so it is a
    # context stage: the callable is built at compile time from the runtime.
    def _broadcast_factory(rt):
        lt = rt.resource("learner")
        state = {"since_broadcast": 0}

        @pure
        def _broadcast(item):
            _actor, batch, info = item
            get_metrics().counters[STEPS_TRAINED_COUNTER] += batch.count
            state["since_broadcast"] += 1
            if state["since_broadcast"] >= broadcast_interval and lt.weights_updated:
                lt.weights_updated = False
                state["since_broadcast"] = 0
                workers.sync_weights()
            return batch, info

        return _broadcast

    update_op = spec.dequeue(learner).for_each_ctx(_broadcast_factory, label="BroadcastWeights")
    merged = spec.concurrently([enqueue_op, update_op], mode="async", output_indexes=[1])
    spec.set_output(merged.report(workers))
    return spec


# --------------------------------------------------------------------- APPO
def build_appo(
    workers: WorkerSet,
    train_batch_size: int = 512,
    num_async: int = 2,
    broadcast_interval: int = 1,
) -> FlowSpec:
    """Async PPO (IMPACT/APPO): IMPALA's async pipeline with a clipped-
    surrogate learner — same dataflow, different numerics."""
    return build_impala(
        workers,
        train_batch_size=train_batch_size,
        num_async=num_async,
        broadcast_interval=broadcast_interval,
        name="appo",
    )


PLAN_BUILDERS: Dict[str, Any] = {
    "ppo": build_ppo,
    "ppo_lm": build_ppo_lm,
    "impala": build_impala,
    "appo": build_appo,
}

# No replay plan is ported yet (DQN/Ape-X/SAC/MBPO wait for rl/replay.py).
REPLAY_PLANS: frozenset = frozenset()
