"""RLlib Flow core (PyTorch port): the hybrid actor-dataflow runtime.

Exports what the port has, the eager plan shims (``core/plans.py``)
included; the multi-host backend (``core/remote.py``) waits for a later
slice.
"""

from repro_torch.core.actor import (
    ActorHandle,
    ActorPool,
    VirtualActor,
    create_colocated,
    get,
    wait,
)
from repro_torch.core.concurrency import Concurrently, Dequeue, Enqueue
from repro_torch.core.executor import (
    ActorDiedError,
    ActorError,
    ExecutionBackend,
    FailurePolicy,
    ProcessBackend,
    SupervisorSpec,
    ThreadBackend,
    resolve_backend,
)
from repro_torch.core.iterators import (
    LocalIterator,
    NextValueNotReady,
    ParallelIterator,
    from_actors,
    from_items,
    from_iterators,
)
from repro_torch.core.learner_thread import LearnerThread
from repro_torch.core.metrics import LatencyStat, MetricsContext, TimerStat, get_metrics
from repro_torch.core.operators import (
    ApplyGradients,
    AverageGradients,
    ConcatBatches,
    ParallelRollouts,
    Replay,
    ReportMetrics,
    SelectExperiences,
    StandardizeFields,
    StandardMetricsReporting,
    StoreToReplayBuffer,
    TrainOneStep,
    UpdateReplayPriorities,
    UpdateTargetNetwork,
    UpdateWorkerWeights,
    par_compute_gradients,
)
from repro_torch.core.plans import (
    a2c_plan,
    a3c_plan,
    apex_plan,
    appo_plan,
    dqn_plan,
    impala_plan,
    maml_plan,
    mbpo_plan,
    multi_agent_ppo_dqn_plan,
    ppo_plan,
    sac_plan,
)
from repro_torch.core.transport import CreditPool, OverflowPolicy
from repro_torch.core.workers import WorkerSet

__all__ = [k for k in dir() if not k.startswith("_")]
