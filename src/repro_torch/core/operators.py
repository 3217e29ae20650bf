"""The RL-specific dataflow operator library (paper §4–5).

Creation operators return iterators; transformation operators are callable
classes applied with ``for_each``.  Together with the sequencing/concurrency
primitives in ``iterators.py`` / ``concurrency.py`` these are sufficient to
express every algorithm plan in ``plans.py`` — the paper's Table 2 suite.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.actor import ActorPool, VirtualActor
from repro_torch.core.iterators import (
    LocalIterator,
    NextValueNotReady,
    ParallelIterator,
)
from repro_torch.core.metrics import (
    APPLY_GRADS_TIMER,
    LEARN_ON_BATCH_TIMER,
    STEPS_SAMPLED_COUNTER,
    STEPS_TRAINED_COUNTER,
    TARGET_NET_UPDATES,
    get_metrics,
)
from repro_torch.core.workers import WorkerSet
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch
from repro_torch.tree import tree_map

__all__ = [
    "ParallelRollouts",
    "configure_vectorized_rollouts",
    "ComputeGradients",
    "ApplyGradients",
    "AverageGradients",
    "TrainOneStep",
    "ConcatBatches",
    "SelectExperiences",
    "StandardizeFields",
    "StoreToReplayBuffer",
    "Replay",
    "UpdateReplayPriorities",
    "UpdateTargetNetwork",
    "UpdateWorkerWeights",
    "ReportMetrics",
    "StandardMetricsReporting",
]


# --------------------------------------------------------------------------
# Creation
# --------------------------------------------------------------------------
def configure_vectorized_rollouts(
    workers: WorkerSet,
    vector: Optional[int] = None,
    inference: Optional[str] = None,
    inference_clients: Optional[Sequence[Any]] = None,
    decode: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Broadcast vectorization config onto the rollout workers.

    The graph carries ``vector=``/``inference=``/``decode=`` declaratively
    (FlowSpec annotations on the rollouts node); this is the lowering step —
    workers exposing ``configure_vectorization`` (``VectorizedRolloutWorker``)
    rebuild their ``VectorEnv`` to ``vector`` lanes and adopt the inference
    mode; anything else (plain ``RolloutWorker``, stubs) is skipped with a
    one-time warning, mirroring the learner-annotation fallback.

    ``inference_clients``: one ``InferenceClient`` per shard (round-robin if
    fewer).  Clients hold live actor handles and do not pickle, so for
    process-backed workers the client is withheld and the worker keeps
    local inference — vectorization still applies.

    ``decode='cache'`` routes local acting through the stateful-policy
    protocol (per-lane KV cache through the rollout scan); workers whose
    policy lacks the protocol fall back to ``'forward'`` in their ack.
    """
    if vector is None and inference is None and decode is None:
        return []
    import logging

    clients = list(inference_clients or [])
    acks: List[Dict[str, Any]] = []
    skipped: List[str] = []
    fell_back: List[str] = []
    for idx, actor in enumerate(workers.remote_workers()):
        client = clients[idx % len(clients)] if clients else None
        if client is not None and actor.backend_name != "thread":
            # Actor handles don't cross the process RPC boundary.
            client = None
            fell_back.append(actor.name)
        kwargs: Dict[str, Any] = dict(
            vector=vector,
            inference=inference if client is not None or inference != "server" else "local",
            client=client,
        )
        if decode is not None:
            # Only sent when requested: legacy configure_vectorization
            # signatures (pre-decode fakes/workers) stay callable.
            kwargs["decode"] = decode
        try:
            acks.append(actor.sync("configure_vectorization", **kwargs))
        except AttributeError:
            skipped.append(actor.name)
    log = logging.getLogger(__name__)
    if skipped:
        log.warning(
            "vector=%s/inference=%s/decode=%s requested but workers %s do not "
            "support configure_vectorization (expected VectorizedRolloutWorker); "
            "they keep their existing rollout path", vector, inference, decode, skipped,
        )
    if fell_back:
        log.warning(
            "inference='server' needs thread-backend rollout workers (actor "
            "handles do not pickle); workers %s fall back to local inference",
            fell_back,
        )
    return acks


def ParallelRollouts(
    workers: WorkerSet,
    mode: str = "bulk_sync",
    num_async: int = 1,
    credits: Optional[int] = None,
    metrics_key: Optional[str] = None,
    vector: Optional[int] = None,
    inference: Optional[str] = None,
    inference_clients: Optional[Sequence[Any]] = None,
    decode: Optional[str] = None,
) -> Any:
    """Stream of experience batches from the rollout workers (paper Fig 5).

    mode='raw'       -> ParIter[SampleBatch]   (caller sequences it)
    mode='bulk_sync' -> Iter[SampleBatch]      (synchronously concatenated
                        across workers per round — PPO/A2C style)
    mode='async'     -> Iter[SampleBatch]      (completion order — Ape-X/
                        IMPALA style, pipeline depth ``num_async``; the
                        total in-flight window is capped at ``credits``
                        when given — credit-based backpressure)

    ``vector=``/``inference=`` configure the vectorized rollout engine on
    the workers before the stream starts (see
    ``configure_vectorized_rollouts``): ``vector=N`` resizes each worker's
    ``VectorEnv`` to N lanes; ``inference='server'`` routes acting through
    the given ``inference_clients`` (decoupled batched inference);
    ``decode='cache'`` carries per-lane model state (KV cache) through the
    rollout scan via the stateful-policy protocol.
    """
    if credits is not None and mode != "async":
        raise ValueError(
            f"credits= is an async-gather window; rollout mode {mode!r} has no "
            "in-flight pipeline to bound (use mode='async')"
        )
    configure_vectorized_rollouts(workers, vector, inference, inference_clients, decode)
    par = ParallelIterator.from_actors(
        workers.remote_workers(), lambda w: w.sample(), name="ParallelRollouts"
    )

    def _count(batch: SampleBatch) -> SampleBatch:
        get_metrics().counters[STEPS_SAMPLED_COUNTER] += batch.count
        return batch

    if mode == "raw":
        return par
    if mode == "bulk_sync":
        def _concat(batches: List[SampleBatch]) -> SampleBatch:
            if batches and isinstance(batches[0], MultiAgentBatch):
                out: Any = MultiAgentBatch.concat_samples(batches)
            else:
                out = SampleBatch.concat_samples(batches)
            get_metrics().counters[STEPS_SAMPLED_COUNTER] += out.count
            return out

        return par.batch_across_shards(metrics_key=metrics_key).for_each(_concat)
    if mode == "async":
        return par.gather_async(
            num_async=num_async, credits=credits, metrics_key=metrics_key
        ).for_each(_count)
    raise ValueError(f"unknown rollout mode {mode!r}")


def Replay(
    actors: ActorPool,
    num_async: int = 4,
    credits: Optional[int] = None,
    metrics_key: Optional[str] = None,
) -> LocalIterator[SampleBatch]:
    """Stream of replayed batches from replay-buffer actors (Ape-X §5.2).

    Pulls with ``num_async``-deep pipelining; buffers that are not yet warm
    return None, which is skipped (NextValueNotReady semantics).  ``credits``
    caps the total in-flight window across replay actors (backpressure
    against a consumer that falls behind, e.g. a saturated learner feed).
    """
    par = ParallelIterator.from_actors(actors, lambda r: r.replay(), name="Replay")

    def _skip_cold(item: Any) -> Any:
        return NextValueNotReady() if item is None else item

    return par.gather_async(
        num_async=num_async, credits=credits, metrics_key=metrics_key
    ).for_each(_skip_cold)


# --------------------------------------------------------------------------
# Gradient-based transformations
# --------------------------------------------------------------------------
class ComputeGradients:
    """batch -> (grads, info); runs ON the source rollout actor, reading its
    local policy snapshot (paper §4, Transformation)."""

    def __call__(self, batch: SampleBatch) -> Tuple[Any, Dict[str, Any]]:
        # Inside a parallel for_each this executes on the actor thread; the
        # actor's target is reachable through the batch producer closure, so
        # RLlib Flow instead passes the *worker itself* via ParallelIterator
        # scheduling. We mirror that: plans use `par_compute_gradients`.
        raise RuntimeError(
            "ComputeGradients must be applied with par_compute_gradients() "
            "on a raw ParallelRollouts iterator"
        )


def par_compute_gradients(
    workers: WorkerSet,
    vector: Optional[int] = None,
    inference: Optional[str] = None,
    inference_clients: Optional[Sequence[Any]] = None,
    decode: Optional[str] = None,
) -> ParallelIterator:
    """ParIter[(grads, info)] — sample + grad computed on each worker.

    ``vector=``/``inference=``/``decode=`` configure the vectorized rollout
    engine on the workers first (A2C/A3C share the knob with
    ``ParallelRollouts``)."""
    configure_vectorized_rollouts(workers, vector, inference, inference_clients, decode)

    def _sample_and_grad(w: Any) -> Tuple[Any, Dict[str, Any]]:
        batch = w.sample()
        grads, info = w.compute_gradients(batch)
        info = dict(info)
        info["batch_count"] = batch.count
        return grads, info

    return ParallelIterator.from_actors(
        workers.remote_workers(), _sample_and_grad, name="ComputeGradients"
    )


class ApplyGradients:
    """Apply (grads, info) on the local worker; push weights to the source
    actor (A3C) or all actors (synchronous algorithms).  Paper Table 1:
    ApplyGradients (Fig 9a's central apply step)."""

    share_across_shards = True
    flow_pure = True  # never emits NextValueNotReady (see repro_torch.flow.spec.pure)

    def __init__(self, workers: WorkerSet, update_all: bool = False):
        self.workers = workers
        self.update_all = update_all

    def __call__(self, item: Tuple[Any, Dict[str, Any]]) -> Dict[str, Any]:
        grads, info = item
        metrics = get_metrics()
        with metrics.timers[APPLY_GRADS_TIMER]:
            self.workers.local_worker().apply_gradients(grads)
        metrics.counters[STEPS_TRAINED_COUNTER] += info.get("batch_count", 0)
        metrics.counters[STEPS_SAMPLED_COUNTER] += info.get("batch_count", 0)
        if self.update_all:
            self.workers.sync_weights()
        else:
            # Fine-grained message passing: update only the producing actor.
            actor = metrics.current_actor
            if actor is not None:
                weights = self.workers.local_worker().get_weights()
                actor.call("set_weights", weights)
        return info


class AverageGradients:
    """List[(grads, info)] -> (averaged grads, merged info).  Paper Table 1:
    AverageGradients (the barrier-reduce of synchronous A2C)."""

    flow_pure = True

    def __call__(self, items: Sequence[Tuple[Any, Dict[str, Any]]]) -> Tuple[Any, Dict]:
        grads = [g for g, _ in items if g is not None]
        info = dict(items[0][1]) if items else {}
        info["batch_count"] = sum(i.get("batch_count", 0) for _, i in items)
        avg = tree_map(lambda *gs: sum(gs) / len(gs), *grads)
        return avg, info


class TrainOneStep:
    """Take a (possibly multi-agent) batch, run one learner update on the
    local worker, then broadcast new weights (paper Fig 10b/11b:
    TrainOneStep).

    ``num_learners``/``microbatch`` lower the update onto a data-parallel
    learner group (``repro_torch.rl.learner_group.ShardedLearnerGroup``):
    batch rows are split across learner ranks at the transport boundary
    and gradients accumulate over ``microbatch`` slices.  Flow
    graphs set these declaratively — ``stream.learners(4).microbatch(2)``
    on the TrainOneStep node — and ``compile()`` lowers the annotations
    onto this operator.  The sharded path needs the local worker's pure
    loss (``_loss_for``); multi-agent or per-policy routing falls back to
    the plain ``learn_on_batch`` with a one-time warning.
    """

    share_across_shards = True
    flow_pure = True

    def __init__(
        self,
        workers: WorkerSet,
        policies: Optional[Sequence[str]] = None,
        num_sgd_iter: int = 1,
        sgd_minibatch_size: int = 0,
        num_learners: int = 0,
        microbatch: int = 0,
    ):
        self.workers = workers
        self.policies = list(policies) if policies else None
        self.num_sgd_iter = num_sgd_iter
        self.sgd_minibatch_size = sgd_minibatch_size
        self.num_learners = num_learners
        self.microbatch = microbatch
        self._group: Any = None
        self._warned_fallback = False
        self._rng = np.random.default_rng(0)

    def _sharded(self) -> bool:
        return self.num_learners > 1 or self.microbatch > 1

    def _learner_group(self, lw: Any) -> Any:
        if self._group is None or self._group.worker is not lw:
            from repro_torch.rl.learner_group import ShardedLearnerGroup

            self.close()
            self._group = ShardedLearnerGroup(
                lw, num_learners=self.num_learners, microbatch=self.microbatch
            )
        return self._group

    def close(self) -> None:
        """Stop the learner group's child ranks (the compiled flow's
        teardown calls this; a later step starts them again)."""
        if self._group is not None:
            self._group.close()

    def __call__(self, batch: Any) -> Any:
        metrics = get_metrics()
        lw = self.workers.local_worker()
        with metrics.timers[LEARN_ON_BATCH_TIMER]:
            if self.num_sgd_iter > 1 or self.sgd_minibatch_size:
                infos = []
                mbs = self.sgd_minibatch_size or batch.count
                for _ in range(self.num_sgd_iter):
                    for mb in batch.minibatches(mbs, self._rng):
                        infos.append(self._learn(lw, mb))
                info = infos[-1] if infos else {}
            else:
                info = self._learn(lw, batch)
        metrics.counters[STEPS_TRAINED_COUNTER] += batch.count
        self.workers.sync_weights()
        return batch, info

    def reset_warnings(self) -> None:
        """Re-arm the warn-once fallback latch.

        Called by ``CompiledFlow._instantiate`` once per compile: operator
        instances that survive a deepcopy carry the old latch into the new
        flow, and instances that *can't* be deep-copied (this one holds a
        live WorkerSet) are shared across every compile of the spec — either
        way, without the reset a fallback in one Algorithm would silently
        suppress the warning in every later Algorithm built from the same
        operators (and across test runs in one process).
        """
        self._warned_fallback = False

    def _warn_fallback(self, lw: Any, why: str) -> None:
        if self._warned_fallback:
            return
        self._warned_fallback = True
        import logging

        logging.getLogger(__name__).warning(
            "TrainOneStep(num_learners=%d, microbatch=%d): %s (worker %s); "
            "falling back to the plain single-device learn_on_batch",
            self.num_learners, self.microbatch, why, type(lw).__name__,
        )

    def _learn(self, lw: Any, batch: Any) -> Dict[str, Any]:
        if isinstance(batch, MultiAgentBatch):
            if self._sharded():
                self._warn_fallback(lw, "multi-agent batches route per policy")
            out = {}
            for pid, b in batch.policy_batches.items():
                if self.policies is None or pid in self.policies:
                    out[pid] = lw.learn_on_batch(b, policy_id=pid)
            return out
        if self.policies:
            if self._sharded():
                self._warn_fallback(lw, "per-policy routing is not sharded")
            return lw.learn_on_batch(batch, policy_id=self.policies[0])
        if self._sharded():
            if hasattr(lw, "_loss_for"):
                return self._learner_group(lw).learn_on_batch(batch)
            self._warn_fallback(lw, "worker has no pure loss (_loss_for)")
        return lw.learn_on_batch(batch)


# --------------------------------------------------------------------------
# Batch shaping
# --------------------------------------------------------------------------
class ConcatBatches:
    """Buffer incoming batches until ``min_batch_size`` steps accumulated.
    Paper Table 1: ConcatBatches (PPO's train-batch assembly, Fig 10)."""

    def __init__(self, min_batch_size: int):
        self.min_batch_size = min_batch_size
        self._buf: List[SampleBatch] = []
        self._count = 0

    def __call__(self, batch: Any) -> Any:
        self._buf.append(batch)
        self._count += batch.count
        if self._count >= self.min_batch_size:
            cls = MultiAgentBatch if isinstance(self._buf[0], MultiAgentBatch) else SampleBatch
            out = cls.concat_samples(self._buf)
            self._buf, self._count = [], 0
            return out
        return NextValueNotReady()


class SelectExperiences:
    """Keep only the given policies' experiences (multi-agent, paper §5.3)."""

    flow_pure = True

    def __init__(self, policy_ids: Sequence[str]):
        self.policy_ids = list(policy_ids)

    def __call__(self, batch: Any) -> Any:
        if isinstance(batch, MultiAgentBatch):
            return batch.select(self.policy_ids)
        return batch


class StandardizeFields:
    """Z-score the given columns.  Paper Table 1: StandardizeFields (PPO's
    advantage normalization stage)."""

    flow_pure = True

    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)

    def __call__(self, batch: Any) -> Any:
        if isinstance(batch, MultiAgentBatch):
            for b in batch.policy_batches.values():
                self._standardize(b)
            return batch
        self._standardize(batch)
        return batch

    def _standardize(self, batch: SampleBatch) -> None:
        for f in self.fields:
            if f in batch:
                col = batch[f]
                batch[f] = (col - col.mean()) / max(1e-4, col.std())


# --------------------------------------------------------------------------
# Replay interaction
# --------------------------------------------------------------------------
class StoreToReplayBuffer:
    """Send each batch to a random replay actor.  Paper Table 1:
    StoreToReplayBuffer (the Ape-X/DQN store sub-flow, §5.2)."""

    share_across_shards = True
    flow_pure = True

    def __init__(self, actors: ActorPool, seed: int = 0):
        self.actors = actors
        self._rng = np.random.default_rng(seed)

    def __call__(self, batch: SampleBatch) -> SampleBatch:
        actor = self.actors[int(self._rng.integers(len(self.actors)))]
        actor.call("add_batch", batch)
        return batch


class UpdateReplayPriorities:
    """Push new TD-error priorities back to the producing replay actor.
    Paper §5.2: Ape-X's UpdatePriorities message-passing operator.

    Consumes ((batch, info), replay_actor) tuples produced by
    ``Replay(...).zip_with_source_actor()`` + TrainOneStep.
    """

    share_across_shards = True
    flow_pure = True

    def __call__(self, item: Tuple[Tuple[Any, Dict], VirtualActor]) -> Any:
        (batch, info), actor = item
        td = info.get("td_error") if isinstance(info, dict) else None
        if td is not None and actor is not None and "batch_indices" in batch:
            actor.call("update_priorities", batch["batch_indices"], np.abs(td))
        return batch, info


# --------------------------------------------------------------------------
# Actor message-passing operators
# --------------------------------------------------------------------------
class UpdateTargetNetwork:
    """Periodically sync the target network (DQN family).  Paper Table 1:
    UpdateTargetNetwork (actor message-passing operator, §4)."""

    share_across_shards = True
    flow_pure = True

    def __init__(self, workers: WorkerSet, target_update_freq: int):
        self.workers = workers
        self.target_update_freq = target_update_freq
        self._last = 0

    def __call__(self, item: Any) -> Any:
        metrics = get_metrics()
        trained = metrics.counters[STEPS_TRAINED_COUNTER]
        if trained - self._last >= self.target_update_freq:
            self._last = trained
            self.workers.local_worker().update_target()
            metrics.counters[TARGET_NET_UPDATES] += 1
        return item


class UpdateWorkerWeights:
    """Fine-grained weight push to the actor that produced the item
    (Ape-X: max_weight_sync_delay staleness control)."""

    share_across_shards = True
    flow_pure = True

    def __init__(self, workers: WorkerSet, max_weight_sync_delay: int = 400):
        self.workers = workers
        self.max_weight_sync_delay = max_weight_sync_delay
        self._steps_since: Dict[int, int] = {}

    def __call__(self, item: Tuple[Any, VirtualActor]) -> Any:
        batch, actor = item
        if actor is None:
            return batch
        n = self._steps_since.get(actor.actor_id, 0) + getattr(batch, "count", 0)
        if n >= self.max_weight_sync_delay:
            weights = self.workers.local_worker().get_weights()
            actor.call("set_weights", weights)
            n = 0
        self._steps_since[actor.actor_id] = n
        return batch


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------
class ReportMetrics:
    """item -> training-result dict, merging the shared metrics context.
    The per-item half of the paper's StandardMetricsReporting (Listing A2)."""

    share_across_shards = True
    flow_pure = True

    def __init__(self, workers: Optional[WorkerSet] = None):
        self.workers = workers
        self._t0 = time.perf_counter()
        # None = unknown, probed on first report; False = targets lack
        # episode_stats(), stop dispatching (and spamming logs) every tick.
        self._remote_has_stats: Optional[bool] = None

    def __call__(self, item: Any) -> Dict[str, Any]:
        metrics = get_metrics()
        info = item[1] if isinstance(item, tuple) and len(item) == 2 else item
        result = dict(metrics.save())
        # Per-item learner info wins over the context's info blob.
        result["info"] = info
        result["time_total_s"] = time.perf_counter() - self._t0
        if self.workers is not None:
            stats = []
            lw = self.workers.local_worker()
            if hasattr(lw, "episode_stats"):
                stats.append(lw.episode_stats())
            # Per-worker stats: dispatch to all live workers in parallel
            # (batched wait, not N serial round-trips), then absorb per-
            # worker failures — a dropped shard must not poison reporting.
            # apply() (not call()) so a missing episode_stats() doesn't hit
            # the fire-and-forget ERROR logger; after one AttributeError the
            # capability is cached and dispatch stops entirely.
            futures = []
            if self._remote_has_stats is not False:
                for actor in self.workers.remote_workers():
                    if not getattr(actor, "alive", True):
                        continue
                    try:
                        futures.append(actor.apply(lambda t: t.episode_stats()))
                    except RuntimeError:
                        continue
            for f in futures:
                try:
                    stats.append(f.result())
                except AttributeError:
                    self._remote_has_stats = False
                    break  # targets predate episode_stats(): skip the rest
                except Exception:
                    continue
            else:
                if futures:
                    self._remote_has_stats = True
            rewards = [
                s["episode_reward_mean"]
                for s in stats
                if s.get("episodes", 0) > 0 and s["episode_reward_mean"] == s["episode_reward_mean"]
            ]
            result["episodes"] = {
                "episode_reward_mean": float(np.mean(rewards)) if rewards else float("nan"),
                "episodes": int(sum(s.get("episodes", 0) for s in stats)),
            }
        return result


def StandardMetricsReporting(
    train_op: LocalIterator,
    workers: WorkerSet,
    report_interval: int = 1,
) -> LocalIterator[Dict[str, Any]]:
    """Wrap a train op into the standard result stream (every Nth item).
    Paper Table 1 / Listing A2: StandardMetricsReporting."""
    it = train_op
    if report_interval > 1:
        counter = {"n": 0}

        def _every(item: Any) -> Any:
            counter["n"] += 1
            if counter["n"] % report_interval == 0:
                return item
            return NextValueNotReady()

        it = it.for_each(_every)
    return it.for_each(ReportMetrics(workers))
