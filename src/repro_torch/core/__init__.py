"""RLlib Flow core (PyTorch port): the hybrid actor-dataflow runtime.

Exports what this slice ports; the eager plan shims (``core/plans.py``),
the multi-host backend (``core/remote.py``) and the SPMD helpers wait for
later slices.
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
from repro_torch.core.transport import CreditPool, OverflowPolicy
from repro_torch.core.workers import WorkerSet

__all__ = [k for k in dir() if not k.startswith("_")]
