"""Audit the committed plan catalog: build each plan, run the analyzer
(PyTorch port of ``repro/flow/analysis/audit.py``).

Every builder in ``PLAN_BUILDERS``, constructed over a small real worker
group, must carry zero error-severity diagnostics.  The workers run on the
card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.flow.analysis.diagnostics import Diagnostic
from repro_torch.flow.analysis.engine import analyze

__all__ = ["audit_plans", "build_plan_specs"]


def build_plan_specs(plans: Optional[Sequence[str]] = None, device: Any = "cuda"):
    """Yield ``(name, spec)`` for each requested committed plan.

    Builds one shared 2-worker group on ``device`` (and a replay pool for
    the plans that need one), as the reference's audit does, and tears both
    down when the generator is exhausted or closed.
    """
    from repro_torch.core.actor import ActorPool
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow.plans import PLAN_BUILDERS, REPLAY_PLANS
    from repro_torch.rl import ActorCriticPolicy, CartPole, ReplayBuffer, RolloutWorker

    names = sorted(PLAN_BUILDERS) if plans is None else list(plans)
    unknown = sorted(set(names) - set(PLAN_BUILDERS))
    if unknown:
        raise KeyError(f"unknown plans: {unknown}")

    def factory(i: int) -> RolloutWorker:
        return RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2), algo="pg",
            num_envs=2, rollout_len=8, seed=0, worker_index=i, device=device,
        )

    workers = WorkerSet.create(factory, 2)
    replay = None
    try:
        for name in names:
            if name in REPLAY_PLANS:
                if replay is None:
                    replay = ActorPool.from_targets([
                        ReplayBuffer(
                            capacity=1024, sample_batch_size=32,
                            learning_starts=64,
                        )
                    ])
                yield name, PLAN_BUILDERS[name](workers, replay)
            else:
                yield name, PLAN_BUILDERS[name](workers)
    finally:
        if replay is not None:
            replay.stop()
        workers.stop()


def audit_plans(
    plans: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
    device: Any = "cuda",
) -> Dict[str, List[Diagnostic]]:
    """Analyze each committed plan; plan name -> sorted diagnostics."""
    return {
        name: analyze(spec, rules=rules)
        for name, spec in build_plan_specs(plans, device=device)
    }
