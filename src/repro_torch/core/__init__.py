"""RLlib Flow core (PyTorch port): the hybrid actor-dataflow runtime.

Exports what the reference's ``repro.core`` exports: the actors, the
iterators and operators, the eager plan shims (``core/plans.py``), the
thread, process and remote backends and the transports.
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
    stop_helper_processes,
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
from repro_torch.core.remote import (
    LocalHostHandle,
    RemoteBackend,
    RemoteCell,
    start_local_host,
)
from repro_torch.core.transport import (
    CreditPool,
    FrameDecoder,
    OverflowPolicy,
    PickleTransport,
    SharedMemoryTransport,
    SocketTransport,
    Transport,
    encode_frame,
    list_segments,
    resolve_transport,
)
from repro_torch.core.workers import WorkerSet

__all__ = [k for k in dir() if not k.startswith("_")]
