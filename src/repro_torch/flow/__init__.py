"""repro_torch.flow: the dataflow-graph IR, the Algorithm runtime and the
flowcheck analyzer (PyTorch port; all twelve of the reference's plans:
``a2c``, ``a3c``, ``ppo``, ``ppo_lm``, ``dqn``, ``apex``, ``sac``, ``impala``,
``appo``, ``maml``, ``mbpo`` and ``multi_agent_ppo_dqn``).

    from repro_torch.flow import Algorithm

    algo = Algorithm.from_plan("ppo", workers, train_batch_size=1024)
    result = algo.train()                         # side effects start here
    algo.stop()                                   # ... and end here
"""

from repro_torch.flow.algorithm import Algorithm
from repro_torch.flow.explain import ExplainReport, StageCost, explain_flow
from repro_torch.flow.analysis import Diagnostic, FlowAnalysisError, Severity, analyze
from repro_torch.flow.compile import (
    CompiledFlow,
    FlowRuntime,
    compose_stages,
    fuse_for_each,
    partition_flowspec,
)
from repro_torch.flow.plans import (
    PLAN_BUILDERS,
    REPLAY_PLANS,
    build_a2c,
    build_a3c,
    build_apex,
    build_appo,
    build_dqn,
    build_impala,
    build_maml,
    build_mbpo,
    build_multi_agent_ppo_dqn,
    build_ppo,
    build_ppo_lm,
    build_sac,
)
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
    "ExplainReport",
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
    "StageCost",
    "StageSpec",
    "Stream",
    "analyze",
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
    "compose_stages",
    "explain_flow",
    "fuse_for_each",
    "partition_flowspec",
    "pure",
]
