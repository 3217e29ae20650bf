"""Lowering: FlowSpec -> LocalIterator/ParallelIterator runtime + passes.

``CompiledFlow`` walks the graph from the output node and maps every node
onto the existing iterator runtime (``repro_torch.core``).  Deferred resources
(learner threads) are instantiated here but *started* only on the first pull
of the compiled iterator, and stopped + joined by ``stop()`` — no side
effects at build or compile time.

Graph-level optimization: ``fuse_for_each`` merges chains of adjacent local
``for_each`` nodes into a single node whose stages compose into one closure
(``compose_stages``).  The composition elides the ``NextValueNotReady``
sentinel check after stages marked pure (``repro_torch.flow.spec.pure`` /
``flow_pure = True``), so an N-stage chain costs one stage dispatch per item
instead of N — ``benchmarks/bench_streaming.py`` measures the win.
"""

from __future__ import annotations

import copy
import logging
import threading
import types
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.concurrency import Concurrently, Dequeue, Enqueue
from repro_torch.core.iterators import (
    LocalIterator,
    NextValueNotReady,
    ParallelIterator,
    from_items,
)
from repro_torch.core.learner_thread import LearnerThread
from repro_torch.core.operators import (
    ParallelRollouts,
    Replay,
    StandardMetricsReporting,
    par_compute_gradients,
)
from repro_torch.flow.analysis.diagnostics import Diagnostic, FlowAnalysisError, Severity
from repro_torch.flow.spec import EdgeRef, FlowSpec, Node, StageSpec, is_pure

__all__ = [
    "CompiledFlow",
    "FlowRuntime",
    "fuse_for_each",
    "compose_stages",
    "partition_flowspec",
]

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Partitioning pass: per-host dataflow fragments
# --------------------------------------------------------------------------
def partition_flowspec(spec: FlowSpec) -> Dict[Optional[str], List[str]]:
    """Split a FlowSpec into per-host dataflow fragments.

    Returns ``{host_name_or_None: [node_id, ...]}``: every node annotated
    ``host=<name>`` lands in that host's fragment; everything else — the
    driver-side remainder, including all learner/report nodes — lands under
    ``None``.  Undeclared host names still get their own fragment here (the
    ``cross-host-placement`` analysis rule flags them; lowering degrades
    them to the driver), so callers can see exactly what the annotations
    asked for.  Node order within a fragment follows the spec's insertion
    order, which is topological for the fluent builder.
    """
    fragments: Dict[Optional[str], List[str]] = {None: []}
    for name in spec.hosts:
        fragments[name] = []
    for nid, node in spec.nodes.items():
        host = node.annotations.get("host")
        fragments.setdefault(host, []).append(nid)
    return fragments


# --------------------------------------------------------------------------
# Optimization pass: stage fusion
# --------------------------------------------------------------------------
def fuse_for_each(spec: FlowSpec) -> FlowSpec:
    """Fuse adjacent local ``for_each`` nodes into single multi-stage nodes.

    Only local stages are fused: parallel ``for_each`` stages keep their
    per-shard clone semantics from ``ParallelIterator.for_each``.
    """
    while True:
        pair = _find_fusable(spec)
        if pair is None:
            return spec
        spec = _merge_pair(spec, *pair)


def _find_fusable(spec: FlowSpec) -> Optional[tuple]:
    for node in spec.nodes.values():
        if node.kind != "for_each" or node.parallel or len(node.inputs) != 1:
            continue
        pred = spec.nodes[node.inputs[0][0]]
        if pred.kind != "for_each" or pred.parallel:
            continue
        if spec.consumers(pred.id) != 1:
            continue
        return (pred.id, node.id)
    return None


def _merge_pair(spec: FlowSpec, pred_id: str, node_id: str) -> FlowSpec:
    nodes = dict(spec.nodes)
    pred, node = nodes.pop(pred_id), nodes[node_id]
    stages = tuple(pred.params["stages"]) + tuple(node.params["stages"])
    nodes[node_id] = Node(
        id=node.id,
        kind="for_each",
        inputs=pred.inputs,
        params={"stages": stages},
        label=" + ".join(s.label for s in stages),
        parallel=False,
        num_outputs=1,
        annotations={**pred.annotations, **node.annotations},
    )
    return spec.replace_nodes(nodes)


def compose_stages(fns: Sequence[Callable]) -> Callable:
    """Whole-stage codegen: compose stage callables into one flat function.

    Generates a single function body with one direct call per stage — no
    dispatch loop, no extra call frames — and a ``NextValueNotReady``
    sentinel check only after stages that may emit it (anything not marked
    pure).  The same trick streaming/SQL engines use for operator fusion.
    """
    if len(fns) == 1:
        return fns[0]
    ns: Dict[str, Any] = {f"_f{i}": fn for i, fn in enumerate(fns)}
    ns["_NotReady"] = NextValueNotReady
    lines = ["def _fused(item):"]
    for i, fn in enumerate(fns):
        lines.append(f"    item = _f{i}(item)")
        if not is_pure(fn) and i < len(fns) - 1:
            lines.append("    if isinstance(item, _NotReady): return item")
    lines.append("    return item")
    exec("\n".join(lines), ns)  # noqa: S102 - compile-time codegen, no user input
    fused = ns["_fused"]
    fused.__name__ = f"fused[{len(fns)}]"
    fused.flow_pure = all(is_pure(f) for f in fns)
    return fused


# --------------------------------------------------------------------------
# Runtime: deferred resources
# --------------------------------------------------------------------------
class FlowRuntime:
    """Owns the compiled flow's deferred resources.

    Resources are built (never started) at construction; ``ensure_started``
    is invoked by the output iterator on its first pull; ``stop`` flags all
    resources and joins their threads so none outlive the flow.
    """

    def __init__(self, spec: FlowSpec):
        self.spec = spec
        self.resources: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._started = False
        self._stopped = False
        for res in spec.resources.values():
            if res.kind == "learner_thread":
                params = dict(res.params)
                workers = params.pop("workers")
                self.resources[res.name] = LearnerThread(workers.local_worker(), **params)
            else:
                raise ValueError(f"unknown resource kind {res.kind!r}")

    def resource(self, name: str) -> Any:
        return self.resources[name]

    @property
    def started(self) -> bool:
        return self._started

    def ensure_started(self, metrics: Any = None) -> None:
        with self._lock:
            if self._started or self._stopped:
                return
            for r in self.resources.values():
                # Hand resources the flow's shared metrics context before
                # they run: the learner thread records sample->learn /
                # queue-wait latencies and queue occupancy into it.
                if metrics is not None and hasattr(r, "metrics"):
                    r.metrics = metrics
                r.start()
            self._started = True

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            for r in self.resources.values():
                r.stop()
            for r in self.resources.values():
                if r.ident is not None:
                    r.join(timeout=5.0)
            # Drain learner in-queues so producers blocked on a full
            # blocking Enqueue wake up and can observe flow teardown.
            for r in self.resources.values():
                q = getattr(r, "inqueue", None)
                while q is not None:
                    try:
                        q.get_nowait()
                    except Exception:
                        break


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------
class CompiledFlow:
    """A FlowSpec lowered onto the iterator runtime, ready to run.

    Lowering fallbacks (annotations that cannot apply, degraded inference)
    surface as structured ``Diagnostic`` objects on ``self.diagnostics`` —
    the same vocabulary ``FlowSpec.check()`` uses statically.  With
    ``strict=True`` the static pass runs first (raising ``FlowAnalysisError``
    before any resource is built) and any error-severity diagnostic emitted
    during lowering also raises, after tearing the partial flow back down.
    """

    def __init__(self, spec: FlowSpec, fuse: bool = True, strict: bool = False):
        spec.validate()
        if strict:
            from repro_torch.flow.analysis.engine import analyze

            static = analyze(spec)
            if any(d.is_error for d in static):
                raise FlowAnalysisError(static, flow=spec.name)
        self.source_spec = spec
        self.spec = fuse_for_each(spec) if fuse else spec
        self.diagnostics: List[Diagnostic] = []
        self._diag_logged: set = set()
        self.runtime = FlowRuntime(self.spec)
        self._cache: Dict[str, Any] = {}
        self._annotated_policies: Dict[int, str] = {}
        self._inference_actors: List[Any] = []
        self._weight_sink_regs: List[Any] = []  # (workers, sink) to undo on stop
        # node id -> {"router": InferenceRouter, "gate": CreditGate} for every
        # served source node: the serving-tier handle explain()/tests reach.
        self._inference_meta: Dict[str, Dict[str, Any]] = {}
        # Multi-host fragments: host name -> owned LocalHostHandle (only for
        # driver-managed hosts this compile launched), host name -> the
        # RemoteBackend its actors were rehomed onto (None = launch failed,
        # don't retry per node), and (actor, original backend) pairs so
        # stop() can return a *shared* WorkerSet's actors to their local
        # backend before the flow tears its hosts down.
        self.fragments = partition_flowspec(self.spec)
        self.host_handles: Dict[str, Any] = {}
        self._host_backends: Dict[str, Any] = {}
        self._placed_actors: Dict[int, str] = {}
        self._rehomed: List[Any] = []  # (actor, original ExecutionBackend)
        assert self.spec.output is not None  # validate() guarantees it
        inner = self._lower_ref(self.spec.output)
        # Serving metrics flow into train() results via MetricsContext
        # probes: each router publishes occupancy / admission latency /
        # credit stalls under inference/<node-id>/ at every save().
        for nid, meta in self._inference_meta.items():
            register = getattr(inner.metrics, "register_probe", None)
            if register is not None:
                register(meta["router"].metrics_probe(nid))
        self._out = self._deferred_start_wrapper(inner)
        if strict and any(d.is_error for d in self.diagnostics):
            self.stop()
            raise FlowAnalysisError(self.diagnostics, flow=spec.name)

    # ------------------------------------------------------------- running
    def iterator(self) -> LocalIterator:
        """The result stream; first pull starts deferred resources."""
        return self._out

    def __iter__(self):
        return iter(self._out)

    def take(self, n: int) -> List[Any]:
        return self._out.take(n)

    def stop(self) -> None:
        """Stop and join all deferred resources, then close the lowered
        iterators so stream teardown (joining Concurrently/union driver
        threads) happens now rather than at GC time (idempotent)."""
        self.runtime.stop()
        # Unhook this flow's weight sinks BEFORE stopping the actors they
        # feed: a shared WorkerSet outlives the flow, and a sink bound to a
        # stopped InferenceActor would fail on every later broadcast.
        for workers, sink in self._weight_sink_regs:
            try:
                workers.remove_weight_sink(sink)
            except Exception:  # pragma: no cover - teardown is best-effort
                pass
        self._weight_sink_regs = []
        for a in self._inference_actors:
            try:
                a.stop()
            except Exception:  # pragma: no cover - teardown is best-effort
                pass
        try:
            self._out.close()
        except Exception:  # pragma: no cover - teardown is best-effort
            pass
        for obj in self._cache.values():
            for it in obj if isinstance(obj, list) else [obj]:
                if isinstance(it, LocalIterator):
                    try:
                        it.close()
                    except Exception:  # pragma: no cover
                        pass
        # Return rehomed actors to their original (local) backend before the
        # flow kills the hosts it launched: a shared WorkerSet outlives the
        # flow, and its actors must not be left pointing at a dead host.
        # Actors already dead (e.g. a chaos machine-loss kill) are skipped —
        # WorkerSet.recover() replaces them on their original backend.
        for actor, backend in self._rehomed:
            try:
                if getattr(actor, "alive", False):
                    actor.rehome(backend, timeout=30.0)
            except Exception:  # pragma: no cover - teardown is best-effort
                pass
        self._rehomed = []
        for handle in self.host_handles.values():
            try:
                handle.stop()
            except Exception:  # pragma: no cover - teardown is best-effort
                pass
        self.host_handles = {}

    def to_dot(self) -> str:
        return self.spec.to_dot()

    # ------------------------------------------------------------ internal
    def _deferred_start_wrapper(self, inner: LocalIterator) -> LocalIterator:
        runtime = self.runtime

        def _base():
            runtime.ensure_started(metrics=inner.metrics)
            yield from iter(inner)

        return LocalIterator(_base, metrics=inner.metrics, name=self.spec.name)

    def _diag(
        self,
        severity: str,
        message: str,
        node: Optional[str] = None,
        hint: Optional[str] = None,
    ) -> Diagnostic:
        """Record a lowering diagnostic (rule ``lowering-fallback``).

        The one dedup path for every fallback site: each distinct
        (node, message) logs once per compile — previously each site
        hand-rolled its own warn-once flag or per-actor dict.
        """
        d = Diagnostic(
            rule="lowering-fallback", severity=severity, message=message,
            node=node, hint=hint,
        )
        self.diagnostics.append(d)
        key = (node, message)
        if key not in self._diag_logged:
            self._diag_logged.add(key)
            log = logger.error if d.is_error else logger.warning
            log("flow %s: %s", self.spec.name, d.format())
        return d

    def _lower_ref(self, ref: EdgeRef) -> Any:
        nid, port = ref
        obj = self._lower(nid)
        return obj[port] if isinstance(obj, list) else obj

    def _lower(self, nid: str) -> Any:
        if nid in self._cache:
            return self._cache[nid]
        node = self.spec.nodes[nid]
        out = self._lower_node(node)
        self._cache[nid] = out
        return out

    def _host_backend(self, host: str, node: Node) -> Any:
        """Resolve (and memoize) the RemoteBackend for a declared host.

        A driver-managed host (``HostSpec.address is None``) is launched
        here via ``start_local_host`` and owned by this flow — ``stop()``
        tears it down.  An external host (``"host:port"``) is only
        connected to; its lifetime is the operator's problem.  A launch or
        connect failure degrades that host's fragment to the driver (one
        error diagnostic, memoized so each host fails at most once).
        """
        if host in self._host_backends:
            return self._host_backends[host]
        from repro_torch.core.remote import RemoteBackend, start_local_host

        hspec = self.spec.hosts[host]
        backend: Any = None
        try:
            if hspec.address is None:
                handle = start_local_host()
                self.host_handles[host] = handle
                address: Any = handle.address
            else:
                address = hspec.address
            backend = RemoteBackend(address=address)
        except Exception as exc:
            self._diag(
                Severity.ERROR,
                f"failed to launch/connect host {host!r}: {exc!r}; its "
                "fragment stays on the driver's local backend",
                node=node.id,
                hint="check the host address, or use a driver-managed host "
                "(declare_host with no address)",
            )
        self._host_backends[host] = backend
        return backend

    def _lower_host(self, node: Node, actors: Any) -> None:
        """Lower a source node's ``host=`` placement annotation.

        This is the cross-host lowering step: the graph says *where* a
        fragment runs declaratively; here each of the node's pool actors is
        rehomed onto the host's ``RemoteBackend``, so its target lives in
        the host process and every edge to the driver crosses the socket
        transport.  Placement is per-actor (like ``failure_policy``): a pool
        shared by nodes annotated with different hosts keeps the first
        placement and warns, rather than bouncing actors between hosts.
        """
        host = node.annotations.get("host")
        if host is None:
            return
        if host not in self.spec.hosts:
            self._diag(
                Severity.ERROR,
                f"host={host!r} is not declared on this spec; the node "
                "stays on the driver's local backend",
                node=node.id,
                hint=f"call spec.declare_host({host!r}) before building the node",
            )
            return
        backend = self._host_backend(host, node)
        if backend is None:
            return
        stranded: List[str] = []
        for a in actors:
            placed = self._placed_actors.get(id(a))
            if placed == host:
                continue
            if placed is not None:
                self._diag(
                    Severity.WARN,
                    f"actor {getattr(a, 'name', repr(a))} is already placed "
                    f"on host {placed!r}; host={host!r} on this node is "
                    "ignored (placement is per-actor, first lowered node "
                    "wins)",
                    node=node.id,
                    hint="annotate the pool's nodes with one host",
                )
                continue
            try:
                original = a._backend  # rehome() swaps this; keep for stop()
                a.rehome(backend, timeout=60.0)
            except Exception as exc:
                stranded.append(f"{getattr(a, 'name', repr(a))} ({exc!r})")
                continue
            self._placed_actors[id(a)] = host
            self._rehomed.append((a, original))
        if stranded:
            self._diag(
                Severity.ERROR,
                f"could not rehome onto host {host!r}: {', '.join(stranded)}; "
                "those shards stay on the driver's local backend",
                node=node.id,
                hint="actors need a picklable factory (WorkerSet.create / "
                "VirtualActor(factory=...)) to cross a host boundary",
            )

    def _lower_annotations(self, node: Node, actors: Any) -> None:
        """Apply a node's failure annotations to its source actors.

        This is the lowering step for fault tolerance: the graph carries the
        policy declaratively; the chosen backend's actors enforce it (gather
        loops read ``actor.failure_policy``).  The policy is a property of
        the *actor*, so two nodes annotating the same pool differently is a
        conflict (last writer wins) — flagged loudly.
        """
        policy = node.annotations.get("failure_policy")
        if policy is None:
            return
        from repro_torch.core.executor import FailurePolicy

        FailurePolicy.validate(policy)
        overridden: List[str] = []
        prior_policy: Optional[str] = None
        for a in actors:
            prior = self._annotated_policies.get(id(a))
            if prior is not None and prior != policy:
                overridden.append(getattr(a, "name", repr(a)))
                prior_policy = prior
            self._annotated_policies[id(a)] = policy
            a.failure_policy = policy
        if overridden:
            self._diag(
                Severity.WARN,
                f"failure_policy={policy!r} overrides {prior_policy!r} set "
                f"by another node of this flow on {', '.join(overridden)}; "
                "the policy is per-actor, and the last lowered node wins "
                "for every stream sharing the pool",
                node=node.id,
                hint="annotate the pool's nodes consistently",
            )

    def _lower_learner_annotations(self, node: Node, fns: Sequence[Callable]) -> None:
        """Lower ``learners(n)``/``microbatch(k)`` onto the node's train stages.

        The graph carries the SPMD execution mapping declaratively (the
        paper's dataflow/numerics split); at lowering time any instantiated
        stage exposing the learner-group knobs — ``TrainOneStep`` — gets
        them set so its update runs on a sharded learner group.  Stage
        fusion merges annotations node-wise, so the knobs survive
        ``fuse_for_each``.
        """
        n = node.annotations.get("num_learners")
        k = node.annotations.get("microbatch")
        if n is None and k is None:
            return
        hit = False
        for fn in fns:
            if hasattr(fn, "num_learners") and hasattr(fn, "microbatch"):
                if n is not None:
                    fn.num_learners = int(n)
                if k is not None:
                    fn.microbatch = int(k)
                hit = True
        if not hit:
            self._diag(
                Severity.ERROR,
                "learners/microbatch annotations but none of the node's "
                "stages accept them (expected a TrainOneStep-like operator); "
                "training stays single-device",
                node=node.id,
                hint="attach the annotation to the TrainOneStep stage's node",
            )

    def _lower_inference(self, node: Node, workers: Any) -> Optional[List[Any]]:
        """Build the decoupled-inference serving tier for a source node.

        ``inference='server'`` lowers to ``inference_replicas`` (default 1)
        ``InferenceActor`` replicas — each a ``VirtualActor`` with a restart
        budget, so the chaos/FailurePolicy path can heal them — behind one
        ``InferenceRouter`` shared by the node's rollout shards (the router
        satisfies the client API; the node's ``failure_policy`` doubles as
        the replica-loss policy).  ``inference_routing`` picks dispatch:
        ``'auto'`` probes the served policy for statefulness, else
        ``'least_loaded'``/``'sticky'`` force it.  The router serves the
        local worker's policy and is registered as a weight sink on the
        WorkerSet, so every ``sync_weights`` broadcast bumps the weight
        version on every replica.  Owned by this CompiledFlow: ``stop()``
        stops the replicas.
        """
        if node.annotations.get("inference") != "server":
            return None
        from repro_torch.core.actor import VirtualActor
        from repro_torch.rl.inference import CreditGate, InferenceActor, InferenceRouter

        lw = workers.local_worker()
        policy = getattr(lw, "policy", None)
        if policy is None:
            self._diag(
                Severity.ERROR,
                "inference='server' but the local worker has no .policy to "
                "serve; falling back to local inference",
                node=node.id,
                hint="use a worker type exposing .policy, or drop "
                "inference='server'",
            )
            return None
        num_shards = max(1, len(workers.remote_workers()))
        credits = node.annotations.get("inference_credits") or 2 * num_shards
        replicas_n = int(node.annotations.get("inference_replicas") or 1)
        routing = node.annotations.get("inference_routing", "auto")
        failure_policy = node.annotations.get("failure_policy")
        if failure_policy not in ("restart", "drop_shard"):
            failure_policy = "restart"
        actors = [
            VirtualActor(
                factory=lambda: InferenceActor(
                    lambda: policy,
                    algo=getattr(lw, "algo", "pg"),
                    epsilon=getattr(lw, "epsilon", 0.0),
                    device=getattr(lw, "device", "cuda"),
                ),
                name=(
                    f"inference-{node.id}"
                    if replicas_n == 1
                    else f"inference-{node.id}-r{i}"
                ),
                max_restarts=1,
                backoff_base=0.0,
            )
            for i in range(replicas_n)
        ]
        gate = CreditGate(int(credits))
        router = InferenceRouter(
            actors,
            credits=gate,
            weights_provider=lw.get_weights,
            sticky=None if routing == "auto" else routing == "sticky",
            failure_policy=failure_policy,
            name=f"inference-router-{node.id}",
        )
        router.sync_weights()  # serve canonical weights from the start
        if hasattr(workers, "add_weight_sink"):
            workers.add_weight_sink(router.sync_weights)
            self._weight_sink_regs.append((workers, router.sync_weights))
        self._inference_actors.extend(actors)
        self._inference_meta[node.id] = {"router": router, "gate": gate}
        # One router shared by every shard: dispatch and health are global.
        return [router] * num_shards

    def _lower_node(self, node: Node) -> Any:
        k, p = node.kind, node.params
        if k == "rollouts":
            self._lower_host(node, p["workers"].remote_workers())
            self._lower_annotations(node, p["workers"].remote_workers())
            return ParallelRollouts(
                p["workers"],
                mode=p["mode"],
                num_async=p["num_async"],
                credits=node.annotations.get("credits", p.get("credits")),
                metrics_key=node.id,
                vector=node.annotations.get("vector"),
                inference=node.annotations.get("inference"),
                inference_clients=self._lower_inference(node, p["workers"]),
                decode=node.annotations.get("decode"),
            )
        if k == "replay":
            self._lower_host(node, p["actors"])
            self._lower_annotations(node, p["actors"])
            return Replay(
                p["actors"],
                num_async=p["num_async"],
                credits=node.annotations.get("credits", p.get("credits")),
                metrics_key=node.id,
            )
        if k == "par_gradients":
            self._lower_host(node, p["workers"].remote_workers())
            self._lower_annotations(node, p["workers"].remote_workers())
            return par_compute_gradients(
                p["workers"],
                vector=node.annotations.get("vector"),
                inference=node.annotations.get("inference"),
                inference_clients=self._lower_inference(node, p["workers"]),
                decode=node.annotations.get("decode"),
            )
        if k == "par_source":
            self._lower_host(node, p["pool"])
            self._lower_annotations(node, p["pool"])
            return ParallelIterator.from_actors(p["pool"], p["pull_fn"], name=node.label)
        if k == "from_items":
            return from_items(p["items"], repeat=p["repeat"])
        if k == "dequeue":
            res = self.runtime.resource(p["resource"])
            return Dequeue(res.outqueue, check=res.is_alive, metrics_key=node.id)

        up = self._lower_ref(node.inputs[0]) if node.inputs else None
        if k == "for_each":
            if isinstance(up, ParallelIterator):
                if "num_learners" in node.annotations or "microbatch" in node.annotations:
                    self._diag(
                        Severity.ERROR,
                        "learners/microbatch annotations on a *parallel* "
                        "for_each; the learner group lowers only onto local "
                        "train stages, so the annotations are ignored",
                        node=node.id,
                        hint="sequence the stream first "
                        "(gather_sync/gather_async/batch_across_shards)",
                    )
                # Parallel stages keep ParallelIterator's own per-shard
                # cloning; apply each stage separately, uninstantiated.
                for stage in p["stages"]:
                    fn = stage.fn(self.runtime) if stage.ctx else stage.fn
                    up = up.for_each(fn)
                return up
            fns = [self._instantiate(s) for s in p["stages"]]
            self._lower_learner_annotations(node, fns)
            return up.for_each(compose_stages(fns))
        if k == "filter":
            return up.filter(p["predicate"])
        if k == "zip_source_actor":
            return up.zip_with_source_actor()
        if k == "gather_async":
            # Backpressure lowering: an explicit credits= param or a
            # credits annotation bounds the in-flight window (ISSUE 3).
            credits = node.annotations.get("credits", p.get("credits"))
            return up.gather_async(
                num_async=p["num_async"], credits=credits, metrics_key=node.id
            )
        if k == "gather_sync":
            return up.gather_sync(metrics_key=node.id)
        if k == "batch_across_shards":
            return up.batch_across_shards(metrics_key=node.id)
        if k == "enqueue":
            res = self.runtime.resource(p["resource"])
            # Overflow-policy lowering: annotation > explicit policy param >
            # legacy block flag.  check=is_alive: a blocking feed must not
            # wedge its driver thread once the learner is gone (teardown/
            # crash) — it raises and the Concurrently driver unwinds instead.
            policy = node.annotations.get("overflow_policy", p.get("policy"))
            if policy is None:
                policy = "block" if p["block"] else "drop_newest"
            return up.for_each(
                Enqueue(
                    res.inqueue,
                    policy=policy,
                    check=res.is_alive,
                    metrics_key=node.id,
                )
            )
        if k == "concurrently":
            ops = [self._lower_ref(r) for r in node.inputs]
            return Concurrently(
                ops,
                mode=p["mode"],
                output_indexes=p["output_indexes"],
                round_robin_weights=p["round_robin_weights"],
            )
        if k == "duplicate":
            return up.duplicate(p["n"])
        if k == "report":
            return StandardMetricsReporting(up, p["workers"], report_interval=p["interval"])
        raise ValueError(f"unknown node kind {k!r}")

    def _instantiate(self, stage: StageSpec) -> Callable:
        """Materialize a stage callable for this compile.

        Context factories see the runtime; stateful operator instances are
        deep-copied when possible so recompiling the same spec yields fresh
        operator state (operators holding live actor handles fall back to
        the shared instance, matching ``ParallelIterator.for_each``).
        """
        if stage.ctx:
            return stage.fn(self.runtime)
        fn = stage.fn
        if not isinstance(fn, types.FunctionType) and not isinstance(fn, type):
            try:
                fn = copy.deepcopy(fn)
            except Exception:
                fn = stage.fn
        # Warn-once latches are per-*compile* state: whether the instance was
        # deep-copied (copies the set latch along) or fell back to the shared
        # original (same latch object across Algorithms), re-arm it so every
        # compiled flow emits its own fallback warnings exactly once.
        reset = getattr(fn, "reset_warnings", None)
        if callable(reset):
            reset()
        return fn

    def __repr__(self) -> str:  # pragma: no cover
        return f"CompiledFlow({self.spec.name!r}, nodes={len(self.spec.nodes)})"
