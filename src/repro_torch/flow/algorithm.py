"""``Algorithm``: the unified runtime facade over compiled flow graphs.

One object owns the whole lifecycle every driver used to hand-roll:

    algo = Algorithm.from_plan("ppo", workers, train_batch_size=1024)
    result = algo.train()          # one result dict from the plan's stream
    algo.stop()                    # joins learner threads, stops actors

or as a context manager::

    with Algorithm.from_plan("ppo", workers, train_batch_size=1024) as algo:
        for _ in range(100):
            print(algo.train()["episodes"]["episode_reward_mean"])

Side effects are deferred: constructing the Algorithm compiles the graph but
starts nothing; the first ``train()`` starts learner threads; ``stop()``
joins them — after it returns, no flow-owned threads are alive.

The PyTorch port registers nine plans (``"a2c"``, ``"a3c"``, ``"ppo"``,
``"ppo_lm"``, ``"dqn"``, ``"apex"``, ``"sac"``, ``"impala"``, ``"appo"``);
``explain``, ``save`` and ``restore`` of the JAX package are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

from repro_torch.core.iterators import LocalIterator
from repro_torch.flow.analysis.diagnostics import sort_diagnostics
from repro_torch.flow.compile import CompiledFlow
from repro_torch.flow.plans import PLAN_BUILDERS, REPLAY_PLANS
from repro_torch.flow.spec import FlowSpec

__all__ = ["Algorithm"]


class Algorithm:
    """Run-facade for a compiled flow: train / introspect / stop."""

    def __init__(
        self,
        compiled: CompiledFlow,
        workers: Any,
        replay_actors: Any = None,
        own_workers: bool = True,
    ):
        self._compiled = compiled
        self._workers = workers
        self._replay = replay_actors
        self._own_workers = own_workers
        self._it: LocalIterator = compiled.iterator()
        self._stopped = False

    # ------------------------------------------------------------ creation
    @classmethod
    def from_plan(
        cls,
        plan: Union[str, Callable[..., FlowSpec], FlowSpec],
        workers: Any,
        replay_actors: Any = None,
        *,
        fuse: bool = True,
        strict: bool = False,
        own_workers: bool = True,
        **plan_kwargs: Any,
    ) -> "Algorithm":
        """Build, optimize, and lower a plan.

        ``plan`` is a registered name (``"ppo"``, ``"apex"``, ...), a builder
        callable returning a ``FlowSpec``, or an already-built ``FlowSpec``.
        ``strict=True`` gates compilation on the static analyzer
        (``FlowAnalysisError`` on any error-severity diagnostic).
        """
        if isinstance(plan, FlowSpec):
            if plan_kwargs:
                raise ValueError(
                    "plan kwargs have no effect on an already-built FlowSpec; "
                    f"pass them to the builder instead (got {sorted(plan_kwargs)})"
                )
            spec = plan
        else:
            if isinstance(plan, str):
                if plan not in PLAN_BUILDERS:
                    raise ValueError(
                        f"unknown plan {plan!r}; known: {sorted(PLAN_BUILDERS)}"
                    )
                if plan in REPLAY_PLANS and replay_actors is None:
                    raise ValueError(f"plan {plan!r} requires replay_actors")
                builder = PLAN_BUILDERS[plan]
            else:
                builder = plan
            args = (workers,) if replay_actors is None else (workers, replay_actors)
            spec = builder(*args, **plan_kwargs)
        return cls(
            spec.compile(fuse=fuse, strict=strict),
            workers,
            replay_actors,
            own_workers=own_workers,
        )

    # ------------------------------------------------------------ training
    def train(self) -> Dict[str, Any]:
        """Pull one result dict (starts deferred resources on first call)."""
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        return next(self._it)

    def iterate(self, n: int) -> List[Dict[str, Any]]:
        """Pull ``n`` results (fewer if the flow is finite and drains)."""
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        return self._it.take(n)

    def __iter__(self):
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        return iter(self._it)

    # ------------------------------------------------------ introspection
    @property
    def spec(self) -> FlowSpec:
        return self._compiled.spec

    @property
    def compiled(self) -> CompiledFlow:
        return self._compiled

    @property
    def workers(self) -> Any:
        return self._workers

    @property
    def resources(self) -> Dict[str, Any]:
        """Deferred runtime resources by name (e.g. learner threads)."""
        return self._compiled.runtime.resources

    def check(self) -> List[Any]:
        """Static analysis of this algorithm's plan (``FlowSpec.check``).

        Returns the combined diagnostic list: the analyzer's findings over
        the *source* spec (pre-fusion, so node ids match what the builder
        created) plus anything the lowering fallbacks recorded while this
        flow compiled.  Empty list = clean.
        """
        return sort_diagnostics(
            list(self._compiled.source_spec.check()) + list(self._compiled.diagnostics)
        )

    def to_dot(self, with_metrics: bool = False) -> str:
        """DOT rendering of the plan; ``with_metrics=True`` labels data-plane
        edges with live bytes-moved counters and queue occupancy."""
        if with_metrics:
            return self._compiled.spec.to_dot(metrics=self._it.metrics)
        return self._compiled.to_dot()

    # ------------------------------------------------- fault tolerance
    def recover(self) -> Dict[str, List[str]]:
        """Heal the worker group after failures: dead rollout workers are
        restarted in place (factory rebuild) or replaced, then the canonical
        weights are re-broadcast.  Pool-aware gather loops pick the healed
        workers back up mid-stream.  Returns a report of what was done."""
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        if not hasattr(self._workers, "recover"):
            raise RuntimeError("workers do not support recover()")
        return self._workers.recover()

    def add_workers(self, num_workers: int) -> List[str]:
        """Elastically grow the rollout group mid-training; new workers join
        the compiled flow's gather loops via the pool version bump."""
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        return [a.name for a in self._workers.add_workers(num_workers)]

    def remove_workers(self, num_workers: int = 1) -> List[str]:
        """Elastically shrink the rollout group mid-training."""
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        return self._workers.remove_workers(num_workers)

    # ------------------------------------------------------------ shutdown
    def stop(self) -> None:
        """Stop learner threads (joined), then workers and replay actors."""
        if self._stopped:
            return
        self._stopped = True
        self._compiled.stop()
        if self._own_workers:
            self._workers.stop()
            if self._replay is not None:
                self._replay.stop()

    def __enter__(self) -> "Algorithm":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Algorithm({self.spec.name!r}, stopped={self._stopped})"
