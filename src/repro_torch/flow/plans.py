"""The paper's algorithm suite as declarative flow graphs (PyTorch port).

Each ``build_*`` function assembles a ``FlowSpec`` — the graph the paper
draws in Figures 9–12, as a value you can inspect (``to_dot()``), optimize
(stage fusion), and lower (``compile()``); ``repro_torch.flow.Algorithm``
is the run-facade.  The port carries all twelve of the reference's plans:
``build_a3c`` (Fig 9a) and ``build_a2c``, ``build_ppo`` (Fig 10b) and its
language-model variant ``build_ppo_lm``, the replay plans ``build_dqn``,
``build_apex`` (Listing A3) and ``build_sac``, the asynchronous
learner-thread pipelines ``build_impala`` (Fig 11) and ``build_appo``,
``build_maml`` (Fig A2), ``build_mbpo`` (§2.2) and the multi-agent
composition ``build_multi_agent_ppo_dqn`` (Figs 11-12).

``rl/lowlevel.py`` keeps the hand-written low-level versions these builders
are counted against (Table 2) and timed against (Fig 13).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from repro_torch.core.actor import ActorPool
from repro_torch.core.metrics import STEPS_TRAINED_COUNTER, get_metrics
from repro_torch.core.operators import (
    ApplyGradients,
    AverageGradients,
    ConcatBatches,
    SelectExperiences,
    StandardizeFields,
    StoreToReplayBuffer,
    TrainOneStep,
    UpdateReplayPriorities,
    UpdateTargetNetwork,
    UpdateWorkerWeights,
)
from repro_torch.core.workers import WorkerSet
from repro_torch.flow.spec import FlowSpec, pure

__all__ = [
    "PLAN_BUILDERS",
    "REPLAY_PLANS",
    "build_a2c",
    "build_a3c",
    "build_apex",
    "build_appo",
    "build_dqn",
    "build_impala",
    "build_maml",
    "build_mbpo",
    "build_multi_agent_ppo_dqn",
    "build_ppo",
    "build_ppo_lm",
    "build_sac",
]


# --------------------------------------------------------------------- A3C
def build_a3c(workers: WorkerSet, num_async: int = 1) -> FlowSpec:
    """Figure 9a: async per-worker gradients applied centrally."""
    spec = FlowSpec("a3c")
    grads = spec.par_gradients(workers).gather_async(num_async=num_async)
    apply_op = grads.for_each(ApplyGradients(workers, update_all=False))
    spec.set_output(apply_op.report(workers))
    return spec


# --------------------------------------------------------------------- A2C
def build_a2c(
    workers: WorkerSet,
    vector: int = 0,
    inference: str = None,
) -> FlowSpec:
    """Synchronous A3C: barrier-gather gradients, average, apply, broadcast.

    ``vector=N`` runs each gradient worker's sampling through the
    vectorized rollout engine (N lanes, one batched dispatch per step);
    ``inference='server'`` decouples acting onto a shared InferenceActor.
    """
    spec = FlowSpec("a2c")
    grads = spec.par_gradients(
        workers, vector=vector or None, inference=inference
    ).batch_across_shards()
    apply_op = grads.for_each(AverageGradients()).for_each(
        ApplyGradients(workers, update_all=True)
    )
    spec.set_output(apply_op.report(workers))
    return spec


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


# --------------------------------------------------------------------- DQN
def build_dqn(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 500,
    store_weight: int = 1,
    replay_weight: int = 1,
    name: str = "dqn",
) -> FlowSpec:
    """Store/replay sub-flows composed round-robin (rate-limited 1:1)."""
    spec = FlowSpec(name)
    store_op = spec.rollouts(workers, mode="bulk_sync").for_each(
        StoreToReplayBuffer(replay_actors)
    )

    # Train on replayed batches, then push new priorities back to the source
    # replay actor (fine-grained message passing).
    train = TrainOneStep(workers)

    @pure
    def _train_keeping_actor(pair):
        batch, actor = pair
        return train(batch), actor

    replay_op = (
        spec.replay(replay_actors)
        .zip_with_source_actor()
        .for_each(_train_keeping_actor, label="TrainOneStep")
        .for_each(UpdateReplayPriorities())
        .for_each(UpdateTargetNetwork(workers, target_update_freq))
    )
    merged = spec.concurrently(
        [store_op, replay_op],
        mode="round_robin",
        output_indexes=[1],
        round_robin_weights=[store_weight, replay_weight],
    )
    spec.set_output(merged.report(workers))
    return spec


# -------------------------------------------------------------------- Ape-X
def build_apex(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 2500,
    max_weight_sync_delay: int = 400,
    num_async_rollouts: int = 2,
    num_async_replay: int = 4,
    block_on_enqueue: bool = True,
    enqueue_policy: str = None,
    replay_credits: int = None,
) -> FlowSpec:
    """Listing A3: three concurrent sub-flows around a learner thread.

    The learner thread is a *deferred resource*: declared here, constructed
    at compile time, started on the first pull, joined on ``stop()``.

    Backpressure knobs (data plane): ``enqueue_policy`` sets the
    learner-feed overflow policy directly ("block" | "drop_newest" |
    "drop_oldest"); ``block_on_enqueue=False`` remains as shorthand for the
    paper's lossy feed ("drop_newest": when the learner falls behind,
    batches are dropped and counted as ``num_samples_dropped`` in train()
    results instead of backpressuring the replay sub-flow).
    ``replay_credits`` caps the replay gather's total in-flight window.
    """
    spec = FlowSpec("apex")
    learner = spec.learner_thread(workers)

    # (1) rollouts -> replay actors; fine-grained weight refresh.
    store_op = (
        spec.rollouts(workers, mode="async", num_async=num_async_rollouts)
        .for_each(StoreToReplayBuffer(replay_actors))
        .zip_with_source_actor()
        .for_each(UpdateWorkerWeights(workers, max_weight_sync_delay))
    )

    # (2) replayed batches -> learner in-queue (credit-bounded gather).
    replay_op = (
        spec.replay(replay_actors, num_async=num_async_replay, credits=replay_credits)
        .zip_with_source_actor()
        .enqueue(learner, block=block_on_enqueue, policy=enqueue_policy)
    )

    # (3) learner out-queue -> priority updates + target sync + metrics.
    @pure
    def _record(item):
        actor, batch, info = item
        get_metrics().counters[STEPS_TRAINED_COUNTER] += batch.count
        return ((batch, info), actor)

    update_op = (
        spec.dequeue(learner)
        .for_each(_record, label="CountTrained")
        .for_each(UpdateReplayPriorities())
        .for_each(UpdateTargetNetwork(workers, target_update_freq))
    )

    merged = spec.concurrently(
        [store_op, replay_op, update_op], mode="async", output_indexes=[2]
    )
    spec.set_output(merged.report(workers))
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
    ``microbatch`` shard the learner thread's update onto a data-parallel
    learner group (``rl/learner_group.py``).  ``vector``/``inference`` configure the
    vectorized rollout engine on the sampling side — the many-shard async
    pipeline with N env lanes per shard is the high-env-count IMPALA
    scenario.
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


# ---------------------------------------------------------------------- SAC
def build_sac(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 1,
    store_weight: int = 1,
    replay_weight: int = 1,
) -> FlowSpec:
    """Off-policy continuous control: same dataflow shape as DQN."""
    return build_dqn(
        workers,
        replay_actors,
        target_update_freq=target_update_freq,
        store_weight=store_weight,
        replay_weight=replay_weight,
        name="sac",
    )


# --------------------------------------------------------------------- MAML
def build_maml(workers: WorkerSet, inner_steps: int = 1) -> FlowSpec:
    """Figure A2: nested optimization — inner adaptation on workers, meta
    update on the driver, broadcast."""
    spec = FlowSpec("maml")

    def _inner_adaptation(w: Any) -> Any:
        pre = w.sample()
        for _ in range(inner_steps):
            w.inner_adapt(pre)
        post = w.sample()
        return {"pre": pre, "post": post}

    rollouts = spec.par_source(workers.remote_workers(), _inner_adaptation, name="MAMLInner")
    meta = TrainOneStep(workers)

    @pure
    def _meta_update(items: Sequence[Dict[str, Any]]) -> Any:
        from repro_torch.rl.sample_batch import SampleBatch

        batch = SampleBatch.concat_samples([d["post"] for d in items])
        out = meta(batch)
        # TrainOneStep already broadcast new weights; workers reset inner state.
        for f in workers.remote_workers().broadcast("reset_inner"):
            f.result()
        return out

    train_op = rollouts.batch_across_shards().for_each(_meta_update, label="MetaUpdate")
    spec.set_output(train_op.report(workers))
    return spec


# --------------------------------------------------------------------- MBPO
def build_mbpo(
    workers: WorkerSet,
    replay_actors: ActorPool,
    model_train_weight: int = 1,
    policy_train_weight: int = 1,
) -> FlowSpec:
    """Model-based RL as three concurrent sub-flows (paper §2.2):

      (1) real rollouts -> replay buffer
      (2) replayed real batches -> supervised dynamics-model training
      (3) replayed states -> synthetic rollouts through the learned model
          -> policy TrainOneStep
    """
    spec = FlowSpec("mbpo")
    lw = workers.local_worker()
    store_op = spec.rollouts(workers, mode="bulk_sync").for_each(
        StoreToReplayBuffer(replay_actors)
    )

    model_op = spec.replay(replay_actors).for_each(
        pure(lambda b: lw.train_dynamics(b)), label="TrainDynamicsModel"
    )

    policy_op = (
        spec.replay(replay_actors)
        .for_each(pure(lambda b: lw.synthesize(b)), label="SynthesizeRollouts")
        .for_each(TrainOneStep(workers))
    )

    merged = spec.concurrently(
        [store_op, model_op, policy_op],
        mode="round_robin",
        output_indexes=[2],
        round_robin_weights=[1, model_train_weight, policy_train_weight],
    )
    spec.set_output(merged.report(workers))
    return spec


# ------------------------------------------------- Multi-agent composition
def build_multi_agent_ppo_dqn(
    workers: WorkerSet,
    replay_actors: ActorPool,
    ppo_policies: Sequence[str] = ("ppo_policy",),
    dqn_policies: Sequence[str] = ("dqn_policy",),
    ppo_batch_size: int = 1024,
    dqn_target_update_freq: int = 500,
) -> FlowSpec:
    """Figure 11/12: one environment, PPO trains some policies, DQN others.

    The rollout stream is duplicated; each branch selects its policies and
    runs its own training dataflow; the union composes them.
    """
    spec = FlowSpec("multi_agent_ppo_dqn")
    ppo_rollouts, dqn_rollouts = spec.rollouts(workers, mode="bulk_sync").duplicate(2)

    ppo_op = (
        ppo_rollouts.for_each(SelectExperiences(ppo_policies), label="SelectExperiences(ppo)")
        .for_each(ConcatBatches(ppo_batch_size), label=f"ConcatBatches({ppo_batch_size})")
        .for_each(StandardizeFields(["advantages"]))
        .for_each(TrainOneStep(workers, policies=ppo_policies), label="TrainOneStep(ppo)")
    )

    @pure
    def _select_dqn(batch):
        selected = SelectExperiences(dqn_policies)(batch)
        # Replay stores flat SampleBatches; all dqn policies share the buffer.
        from repro_torch.rl.sample_batch import SampleBatch

        return SampleBatch.concat_samples(list(selected.policy_batches.values()))

    store_op = dqn_rollouts.for_each(_select_dqn, label="SelectExperiences(dqn)").for_each(
        StoreToReplayBuffer(replay_actors)
    )
    train_dqn = TrainOneStep(workers, policies=dqn_policies)

    @pure
    def _train_keeping_actor(pair):
        batch, actor = pair
        return train_dqn(batch), actor

    dqn_op = (
        spec.replay(replay_actors)
        .zip_with_source_actor()
        .for_each(_train_keeping_actor, label="TrainOneStep(dqn)")
        .for_each(UpdateReplayPriorities())
        .for_each(UpdateTargetNetwork(workers, dqn_target_update_freq))
    )

    merged = spec.concurrently(
        [ppo_op, store_op, dqn_op], mode="round_robin", output_indexes=[0, 2]
    )
    spec.set_output(merged.report(workers))
    return spec


PLAN_BUILDERS: Dict[str, Any] = {
    "a3c": build_a3c,
    "a2c": build_a2c,
    "ppo": build_ppo,
    "ppo_lm": build_ppo_lm,
    "dqn": build_dqn,
    "apex": build_apex,
    "impala": build_impala,
    "sac": build_sac,
    "maml": build_maml,
    "appo": build_appo,
    "mbpo": build_mbpo,
    "multi_agent_ppo_dqn": build_multi_agent_ppo_dqn,
}

# Plans whose builders take (workers, replay_actors, ...).
REPLAY_PLANS = frozenset({"dqn", "apex", "sac", "mbpo", "multi_agent_ppo_dqn"})
