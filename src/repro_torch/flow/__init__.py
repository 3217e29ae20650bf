"""repro_torch.flow: the dataflow-graph IR and the Algorithm runtime
(PyTorch port; ``build_ppo`` and ``build_ppo_lm`` are the plans ported so
far).

    from repro_torch.flow import Algorithm

    algo = Algorithm.from_plan("ppo", workers, train_batch_size=1024)
    result = algo.train()                         # side effects start here
    algo.stop()                                   # ... and end here
"""

from repro_torch.flow.algorithm import Algorithm
from repro_torch.flow.analysis import Diagnostic, FlowAnalysisError, Severity
from repro_torch.flow.compile import (
    CompiledFlow,
    FlowRuntime,
    compose_stages,
    fuse_for_each,
    partition_flowspec,
)
from repro_torch.flow.plans import PLAN_BUILDERS, REPLAY_PLANS, build_ppo, build_ppo_lm
from repro_torch.flow.spec import (
    FlowSpec,
    HostSpec,
    Node,
    ResourceRef,
    StageSpec,
    Stream,
    pure,
)

__all__ = [
    "Algorithm",
    "CompiledFlow",
    "Diagnostic",
    "FlowAnalysisError",
    "FlowRuntime",
    "FlowSpec",
    "HostSpec",
    "Node",
    "PLAN_BUILDERS",
    "REPLAY_PLANS",
    "ResourceRef",
    "Severity",
    "StageSpec",
    "Stream",
    "build_ppo",
    "build_ppo_lm",
    "compose_stages",
    "fuse_for_each",
    "partition_flowspec",
    "pure",
]
