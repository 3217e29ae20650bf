"""``Algorithm``: the unified runtime facade over compiled flow graphs.

One object owns the whole lifecycle every driver used to hand-roll:

    algo = Algorithm.from_plan("ppo", workers, train_batch_size=1024)
    result = algo.train()          # one result dict from the plan's stream
    algo.save("ckpt.npz")          # durable state = policy weights (§3)
    algo.stop()                    # joins learner threads, stops actors

or as a context manager::

    with Algorithm.from_plan("ppo", workers, train_batch_size=1024) as algo:
        for _ in range(100):
            print(algo.train()["episodes"]["episode_reward_mean"])

Side effects are deferred: constructing the Algorithm compiles the graph but
starts nothing; the first ``train()`` starts learner threads; ``stop()``
joins them — after it returns, no flow-owned threads are alive.

The PyTorch port registers all twelve of the reference's plans;
``explain`` prices each stage with the cost walker at H100 rates
(``flow/explain.py``).
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
    """Run-facade for a compiled flow: train / checkpoint / introspect / stop."""

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

    def explain(self, hw: Any = None) -> Any:
        """Roofline-driven per-stage cost attribution (``ExplainReport``).

        Runs each stage's step (rollout, learn step) once under the cost
        walker, prices it against ``hw`` (default ``HW_H100``), and joins
        the live per-node metrics this flow has accumulated — so run a few
        ``train()`` calls first if you want the wall-time columns populated.
        Memory-bound stages are flagged as kernel candidates.  The learn
        step runs on fake tensors, but its probe batch is one real
        ``sample()`` on the local worker's device; a rollout is priced on
        fake tensors, except one whose control flow branches on its data
        (the LM policy's), which runs for real on that device.  Purely
        introspective: worker state is restored after each probe.
        """
        if self._stopped:
            raise RuntimeError("Algorithm is stopped")
        from repro_torch.distributed.hlo_analysis import HW_H100
        from repro_torch.flow.explain import explain_flow

        return explain_flow(
            self._compiled, self._workers, self._it.metrics,
            hw=hw if hw is not None else HW_H100,
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

    # -------------------------------------------------------- durability
    def save(self, path: str) -> None:
        """Checkpoint the canonical policy weights plus the flow's resumable
        state (metrics counters, replay-buffer contents and RNG, and every
        worker's ``get_state``: env state and key chains).

        Weights go to ``path`` (.npz, the reference's format: either package
        restores the other's); the flow state goes to ``path +
        ".state.pkl"`` so a mid-stream restore resumes training with
        identical counters, replay state and rollout streams.

        All state is collected *before* any file is written: a dead replay
        actor raises here (recover() first), never leaving a half-written
        checkpoint that would later restore silently without flow state."""
        import pickle

        from repro_torch.checkpoint import save_pytree

        weights = self._workers.local_worker().get_weights()
        state: Dict[str, Any] = {"counters": self._it.metrics.snapshot_counters()}
        if self._replay is not None:
            try:
                state["replay"] = [a.sync("get_state") for a in self._replay]
            except AttributeError:
                pass  # replay target without get_state(): counters-only state
        lw = self._workers.local_worker()
        if hasattr(lw, "get_state"):
            state["local_worker"] = lw.get_state()
        if hasattr(self._workers, "remote_workers"):
            remote_states: Dict[str, Any] = {}
            for actor in self._workers.remote_workers():
                if not getattr(actor, "alive", True):
                    continue
                try:
                    remote_states[actor.name] = actor.sync("get_state")
                except AttributeError:
                    pass  # worker without get_state(): weights-only worker
            if remote_states:
                state["remote_workers"] = remote_states
        save_pytree(path, weights)
        with open(path + ".state.pkl", "wb") as f:
            pickle.dump(state, f)

    def restore(self, path: str) -> None:
        """Restore weights into the local worker (copied into its own
        tensors), broadcast them to the remotes, and (when a state sidecar
        exists) restore metrics counters, replay state and every worker's
        state so training resumes exactly where ``save()`` left off."""
        import os
        import pickle

        from repro_torch.checkpoint import restore_pytree

        lw = self._workers.local_worker()
        lw.set_weights(restore_pytree(path, lw.get_weights()))
        self._workers.sync_weights()
        sidecar = path + ".state.pkl"
        if not os.path.exists(sidecar):
            return
        with open(sidecar, "rb") as f:
            state = pickle.load(f)
        metrics = self._it.metrics
        metrics.counters.clear()
        metrics.counters.update(state.get("counters", {}))
        replay_states = state.get("replay")
        if replay_states and self._replay is not None:
            if len(replay_states) != len(self._replay):
                raise ValueError(
                    f"checkpoint has {len(replay_states)} replay-actor states "
                    f"but this Algorithm has {len(self._replay)} replay actors; "
                    "restore into a matching topology"
                )
            for actor, rstate in zip(self._replay, replay_states):
                actor.sync("set_state", rstate)
        if "local_worker" in state and hasattr(lw, "set_state"):
            lw.set_state(state["local_worker"])
        remote_states = state.get("remote_workers")
        if remote_states and hasattr(self._workers, "remote_workers"):
            # Matched by actor name (rollout-<index>), so restore works into
            # a fresh WorkerSet of the same topology; extra/missing workers
            # are left as-is (weights were already broadcast above).
            for actor in self._workers.remote_workers():
                rstate = remote_states.get(actor.name)
                if rstate is not None:
                    try:
                        actor.sync("set_state", rstate)
                    except AttributeError:
                        pass

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
