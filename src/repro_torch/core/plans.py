"""Execution plans: compat shims over the declarative flow graphs (PyTorch
port of ``repro/core/plans.py``).

The paper's Table 2 algorithm suite now lives in ``repro_torch.flow.plans`` as
``FlowSpec`` graph builders — the graph is a first-class value there
(inspectable via ``to_dot()``, optimizable via stage fusion, runnable via
``repro.flow.Algorithm``).  These functions keep the original eager plan
signatures working: each builds the graph, compiles it, and returns the
result iterator, with side effects (learner-thread start) deferred to the
first pull instead of firing at build time.

New code should prefer::

    from repro_torch.flow import Algorithm
    algo = Algorithm.from_plan("apex", workers, replay_actors)

``repro_torch.flow`` is imported when a shim is first called: its plans
import ``repro_torch.core``, whose package exports these shims.
"""

from __future__ import annotations

from typing import Dict, Sequence

from typing import TYPE_CHECKING

from repro_torch.core.actor import ActorPool
from repro_torch.core.iterators import LocalIterator
from repro_torch.core.workers import WorkerSet

if TYPE_CHECKING:
    from repro_torch.flow.spec import FlowSpec

__all__ = [
    "a3c_plan",
    "a2c_plan",
    "ppo_plan",
    "dqn_plan",
    "apex_plan",
    "impala_plan",
    "sac_plan",
    "maml_plan",
    "appo_plan",
    "mbpo_plan",
    "multi_agent_ppo_dqn_plan",
]


def _builders():
    from repro_torch.flow import plans

    return plans


def _as_plan_iterator(spec: "FlowSpec") -> LocalIterator[Dict]:
    """Compile a flow graph and expose the legacy plan-iterator surface.

    The returned iterator carries ``.flow`` (the CompiledFlow) and, when the
    graph declares one, ``.learner_thread`` — kept so existing drivers'
    ``plan.learner_thread.stop()`` still works.  The learner thread only
    starts on the first pull.
    """
    compiled = spec.compile()
    it = compiled.iterator()
    it.flow = compiled
    learner = compiled.runtime.resources.get("learner")
    if learner is not None:
        it.learner_thread = learner
    return it


def a3c_plan(workers: WorkerSet, num_async: int = 1) -> LocalIterator[Dict]:
    return _as_plan_iterator(_builders().build_a3c(workers, num_async=num_async))


def a2c_plan(workers: WorkerSet) -> LocalIterator[Dict]:
    return _as_plan_iterator(_builders().build_a2c(workers))


def ppo_plan(
    workers: WorkerSet,
    train_batch_size: int = 4000,
    num_sgd_iter: int = 8,
    sgd_minibatch_size: int = 128,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_ppo(
            workers,
            train_batch_size=train_batch_size,
            num_sgd_iter=num_sgd_iter,
            sgd_minibatch_size=sgd_minibatch_size,
        )
    )


def dqn_plan(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 500,
    store_weight: int = 1,
    replay_weight: int = 1,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_dqn(
            workers,
            replay_actors,
            target_update_freq=target_update_freq,
            store_weight=store_weight,
            replay_weight=replay_weight,
        )
    )


def apex_plan(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 2500,
    max_weight_sync_delay: int = 400,
    num_async_rollouts: int = 2,
    num_async_replay: int = 4,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_apex(
            workers,
            replay_actors,
            target_update_freq=target_update_freq,
            max_weight_sync_delay=max_weight_sync_delay,
            num_async_rollouts=num_async_rollouts,
            num_async_replay=num_async_replay,
        )
    )


def impala_plan(
    workers: WorkerSet,
    train_batch_size: int = 512,
    num_async: int = 2,
    broadcast_interval: int = 1,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_impala(
            workers,
            train_batch_size=train_batch_size,
            num_async=num_async,
            broadcast_interval=broadcast_interval,
        )
    )


def sac_plan(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 1,
    store_weight: int = 1,
    replay_weight: int = 1,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_sac(
            workers,
            replay_actors,
            target_update_freq=target_update_freq,
            store_weight=store_weight,
            replay_weight=replay_weight,
        )
    )


def maml_plan(workers: WorkerSet, inner_steps: int = 1) -> LocalIterator[Dict]:
    return _as_plan_iterator(_builders().build_maml(workers, inner_steps=inner_steps))


def appo_plan(
    workers: WorkerSet,
    train_batch_size: int = 512,
    num_async: int = 2,
    broadcast_interval: int = 1,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_appo(
            workers,
            train_batch_size=train_batch_size,
            num_async=num_async,
            broadcast_interval=broadcast_interval,
        )
    )


def mbpo_plan(
    workers: WorkerSet,
    replay_actors: ActorPool,
    model_train_weight: int = 1,
    policy_train_weight: int = 1,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_mbpo(
            workers,
            replay_actors,
            model_train_weight=model_train_weight,
            policy_train_weight=policy_train_weight,
        )
    )


def multi_agent_ppo_dqn_plan(
    workers: WorkerSet,
    replay_actors: ActorPool,
    ppo_policies: Sequence[str] = ("ppo_policy",),
    dqn_policies: Sequence[str] = ("dqn_policy",),
    ppo_batch_size: int = 1024,
    dqn_target_update_freq: int = 500,
) -> LocalIterator[Dict]:
    return _as_plan_iterator(
        _builders().build_multi_agent_ppo_dqn(
            workers,
            replay_actors,
            ppo_policies=ppo_policies,
            dqn_policies=dqn_policies,
            ppo_batch_size=ppo_batch_size,
            dqn_target_update_freq=dqn_target_update_freq,
        )
    )
