"""The paper's algorithm suite as declarative flow graphs (PyTorch port).

Each ``build_*`` function assembles a ``FlowSpec`` — the graph the paper
draws in Figures 9–12, as a value you can inspect (``to_dot()``), optimize
(stage fusion), and lower (``compile()``); ``repro_torch.flow.Algorithm``
is the run-facade.  The port carries ``build_ppo`` (Fig 10b) so far; the
other builders of ``repro/flow/plans.py`` follow their workers and buffers.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.operators import ConcatBatches, StandardizeFields, TrainOneStep
from repro_torch.core.workers import WorkerSet
from repro_torch.flow.spec import FlowSpec

__all__ = ["PLAN_BUILDERS", "REPLAY_PLANS", "build_ppo"]


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


PLAN_BUILDERS: Dict[str, Any] = {"ppo": build_ppo}

# No replay plan is ported yet (DQN/Ape-X/SAC/MBPO wait for rl/replay.py).
REPLAY_PLANS: frozenset = frozenset()
