"""FlowSpec: a declarative dataflow-graph IR for RL execution plans.

The paper argues RL algorithms *are* dataflow graphs (§2), yet the eager
plan functions in ``repro.core.plans`` only materialize that graph implicitly
inside chained iterators: the topology is gone by the time the plan returns,
and side effects (learner-thread start) fire at build time.  ``FlowSpec``
makes the graph a first-class value, following MSRL's split between the
algorithm's *fragmented dataflow graph* and its execution mapping:

  * **build**    — plan builders assemble a ``FlowSpec``: typed operator
    nodes (sources, transformations, sequencing, concurrency) connected by
    stream edges, plus *deferred resources* (learner threads) that are only
    instantiated/started at run time.
  * **optimize** — graph passes rewrite the spec (``repro_torch.flow.compile``
    fuses adjacent ``for_each`` stages into one stage closure).
  * **lower**    — ``spec.compile()`` maps nodes onto the existing
    ``LocalIterator``/``ParallelIterator``/``Concurrently`` runtime.
  * **run**      — pulling from the compiled iterator drives the graph;
    resources start lazily on the first pull and stop with the flow.

``to_dot()`` renders the graph in Graphviz DOT — the paper's Figures 9–12
reproduced from live plans instead of hand-drawn.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["FlowSpec", "Stream", "Node", "StageSpec", "ResourceRef", "HostSpec", "pure"]

# Edge endpoint: (producer node id, output port).  Port > 0 only for
# multi-output nodes (duplicate).
EdgeRef = Tuple[str, int]


def pure(fn: Callable) -> Callable:
    """Mark a callable as never returning ``NextValueNotReady``.

    The stage-fusion pass elides the sentinel check after pure stages when
    composing a fused chain; unmarked callables keep the check (safe default).
    """
    fn.flow_pure = True  # type: ignore[attr-defined]
    return fn


def is_pure(fn: Callable) -> bool:
    return bool(getattr(fn, "flow_pure", False))


@dataclass(frozen=True)
class StageSpec:
    """One transformation inside a ``for_each`` node.

    ``ctx=True`` means ``fn`` is a factory ``fn(runtime) -> callable`` run at
    compile time — the hook for stages that need a deferred resource (e.g.
    IMPALA's broadcast gate reading the learner thread's dirty bit).
    """

    fn: Callable
    label: str
    ctx: bool = False


@dataclass(frozen=True)
class Node:
    id: str
    kind: str
    inputs: Tuple[EdgeRef, ...]
    params: Dict[str, Any]
    label: str
    parallel: bool  # True -> output stream is a ParallelIterator
    num_outputs: int = 1
    # Resource/failure annotations (executor runtime): e.g.
    # {"failure_policy": "drop_shard", "resources": {"num_cpus": 1}}.
    # ``compile()`` lowers failure policies onto the node's source actors.
    annotations: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class HostSpec:
    """A placement target for dataflow fragments (MSRL: one fragment per
    host, same IR, different placement).

    ``address=None`` means *driver-managed*: ``compile()`` launches a local
    ``RemoteHost`` process on this box and owns its lifecycle (the localhost
    two-fragment test topology).  A concrete ``"host:port"`` address points
    at an externally-run host on another machine — the driver only connects.
    """

    name: str
    address: Optional[str] = None


@dataclass(frozen=True)
class ResourceSpec:
    """A deferred side-effectful runtime object (today: learner threads).

    Declared in the graph, instantiated at compile time, *started* only when
    the flow is first pulled, stopped and joined on ``stop()``.
    """

    name: str
    kind: str
    params: Dict[str, Any] = field(default_factory=dict)


class ResourceRef:
    """Builder-side handle to a declared resource."""

    def __init__(self, spec: "FlowSpec", name: str):
        self.spec = spec
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"ResourceRef({self.name})"


def _fn_label(fn: Any) -> str:
    return getattr(fn, "__name__", type(fn).__name__)


class Stream:
    """A builder handle to one output edge of a node (fluent API)."""

    def __init__(self, spec: "FlowSpec", node_id: str, port: int = 0, parallel: bool = False):
        self.spec = spec
        self.node_id = node_id
        self.port = port
        self.parallel = parallel

    @property
    def ref(self) -> EdgeRef:
        return (self.node_id, self.port)

    @property
    def node(self) -> "Node":
        return self.spec.nodes[self.node_id]

    def annotate(self, **annotations: Any) -> "Stream":
        """Attach resource/failure/backpressure annotations to the node.

        Recognized by ``compile()``: ``failure_policy`` ("raise" | "restart"
        | "drop_shard") is applied to the node's source actors at lowering
        time; ``overflow_policy`` ("block" | "drop_newest" | "drop_oldest")
        overrides an enqueue node's queue policy; ``credits`` (int) caps a
        gather_async node's in-flight window; ``num_learners``/``microbatch``
        (ints, see ``learners()``/``microbatch()``) lower a train stage onto
        a sharded SPMD learner group; ``vector``/``inference``/
        ``inference_credits`` (rollouts/par_gradients nodes) configure the
        vectorized rollout engine and decoupled batched inference;
        ``host`` (a name declared via ``declare_host``) places a source
        node's actor pool on a remote dataflow fragment (see ``host()``).
        Other keys (e.g.
        ``resources={"num_cpus": 1}``) are carried as placement metadata for
        schedulers/introspection.
        """
        import dataclasses

        node = self.spec.nodes[self.node_id]
        self.spec.nodes[self.node_id] = dataclasses.replace(
            node, annotations={**node.annotations, **annotations}
        )
        return self

    def learners(self, n: int) -> "Stream":
        """Lower this node's train stage onto ``n`` data-parallel learner
        devices (SPMD learner group).

        Sugar for ``annotate(num_learners=n)``: at lowering time
        ``compile()`` configures any TrainOneStep-like stage of the node to
        run its update on an ``n``-device mesh, with batch columns sharded
        at the transport boundary.  Typically chained directly on the
        TrainOneStep ``for_each`` node::

            rollouts.for_each(ConcatBatches(4096))
                    .for_each(TrainOneStep(workers)).learners(4).microbatch(2)
        """
        if n < 1:
            raise ValueError(f"learners() needs n >= 1 (got {n})")
        return self.annotate(num_learners=int(n))

    def microbatch(self, k: int) -> "Stream":
        """Accumulate gradients over ``k`` microbatch slices per update
        (sugar for ``annotate(microbatch=k)``; see ``learners()``)."""
        if k < 1:
            raise ValueError(f"microbatch() needs k >= 1 (got {k})")
        return self.annotate(microbatch=int(k))

    def host(self, name: str) -> "Stream":
        """Place this source node's actor pool on the named fragment host.

        Sugar for ``annotate(host=name)``.  The host must be declared via
        ``spec.declare_host(name)``; at lowering time the partitioner
        (``flow.compile``) re-homes the node's actors onto that host's
        ``RemoteBackend``, so the node's output stream crosses the host
        boundary over the socket transport while everything unannotated
        stays on the driver fragment::

            spec.declare_host("rollout-box")
            rollouts = spec.rollouts(workers, mode="bulk_sync").host("rollout-box")
        """
        if not isinstance(name, str) or not name:
            raise ValueError(f"host() needs a non-empty host name (got {name!r})")
        return self.annotate(host=name)

    # ----------------------------------------------------- transformations
    def for_each(self, fn: Callable, label: Optional[str] = None) -> "Stream":
        """Transformation stage.  On parallel streams the callable runs on the
        source actor (and is cloned per shard at lowering, as today)."""
        stage = StageSpec(fn=fn, label=label or _fn_label(fn))
        node = self.spec._add(
            "for_each", (self.ref,), {"stages": (stage,)}, stage.label, self.parallel
        )
        return Stream(self.spec, node.id, 0, self.parallel)

    def for_each_ctx(self, factory: Callable, label: str) -> "Stream":
        """Like ``for_each`` but ``factory(runtime)`` builds the callable at
        compile time, with access to deferred resources."""
        stage = StageSpec(fn=factory, label=label, ctx=True)
        node = self.spec._add(
            "for_each", (self.ref,), {"stages": (stage,)}, label, self.parallel
        )
        return Stream(self.spec, node.id, 0, self.parallel)

    def filter(self, predicate: Callable[[Any], bool]) -> "Stream":
        self._require_local("filter")
        node = self.spec._add(
            "filter", (self.ref,), {"predicate": predicate},
            f"Filter({_fn_label(predicate)})", False,
        )
        return Stream(self.spec, node.id)

    def zip_with_source_actor(self) -> "Stream":
        self._require_local("zip_with_source_actor")
        node = self.spec._add("zip_source_actor", (self.ref,), {}, "ZipWithSourceActor", False)
        return Stream(self.spec, node.id)

    # --------------------------------------------------------- sequencing
    def gather_async(self, num_async: int = 1, credits: Optional[int] = None) -> "Stream":
        """Async sequencing; ``credits`` caps total in-flight items across
        shards (credit-based backpressure; default ``num_async * shards``).
        Also settable post-hoc via ``.annotate(credits=N)``."""
        self._require_parallel("gather_async")
        node = self.spec._add(
            "gather_async", (self.ref,), {"num_async": num_async, "credits": credits},
            f"GatherAsync(num_async={num_async})", False,
        )
        return Stream(self.spec, node.id)

    def gather_sync(self) -> "Stream":
        self._require_parallel("gather_sync")
        node = self.spec._add("gather_sync", (self.ref,), {}, "GatherSync", False)
        return Stream(self.spec, node.id)

    def batch_across_shards(self) -> "Stream":
        self._require_parallel("batch_across_shards")
        node = self.spec._add("batch_across_shards", (self.ref,), {}, "BatchAcrossShards", False)
        return Stream(self.spec, node.id)

    # -------------------------------------------------------- concurrency
    def duplicate(self, n: int) -> List["Stream"]:
        """Split the stream into ``n`` buffered copies (paper Fig 8, split)."""
        self._require_local("duplicate")
        node = self.spec._add(
            "duplicate", (self.ref,), {"n": n}, f"Duplicate({n})", False, num_outputs=n
        )
        return [Stream(self.spec, node.id, port=i) for i in range(n)]

    def enqueue(
        self,
        resource: ResourceRef,
        block: bool = True,
        policy: Optional[str] = None,
    ) -> "Stream":
        """Push items into a deferred resource's in-queue (learner feed).

        ``policy`` is the overflow policy at the queue boundary — ``block``
        (lossless, backpressures the producing sub-flow), ``drop_newest``
        (lossy Ape-X feed, drops counted in ``num_samples_dropped``), or
        ``drop_oldest`` (bounded staleness).  ``block=True/False`` remains
        as shorthand for block/drop_newest; an ``overflow_policy``
        annotation set via ``.annotate()`` wins over both at lowering time.
        """
        self._require_local("enqueue")
        if policy is not None:
            from repro_torch.core.transport import OverflowPolicy

            OverflowPolicy.validate(policy)
        node = self.spec._add(
            "enqueue", (self.ref,),
            {"resource": resource.name, "block": block, "policy": policy},
            f"Enqueue({resource.name}.inqueue)", False,
        )
        return Stream(self.spec, node.id)

    # -------------------------------------------------------------- sinks
    def report(self, workers: Any = None, interval: int = 1) -> "Stream":
        """Standard metrics-reporting sink (result-dict stream)."""
        self._require_local("report")
        node = self.spec._add(
            "report", (self.ref,), {"workers": workers, "interval": interval},
            "ReportMetrics", False,
        )
        return Stream(self.spec, node.id)

    # ------------------------------------------------------------ helpers
    def _require_parallel(self, op: str) -> None:
        if not self.parallel:
            raise TypeError(f"{op}() requires a parallel stream (got local)")

    def _require_local(self, op: str) -> None:
        if self.parallel:
            raise TypeError(
                f"{op}() requires a local stream; sequence the parallel stream "
                "first (gather_sync/gather_async/batch_across_shards)"
            )

    def __repr__(self) -> str:  # pragma: no cover
        kind = "ParStream" if self.parallel else "Stream"
        return f"{kind}({self.node_id}:{self.port})"


class FlowSpec:
    """The declarative dataflow graph: nodes + stream edges + resources."""

    def __init__(self, name: str = "flow"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.resources: Dict[str, ResourceSpec] = {}
        self.hosts: Dict[str, HostSpec] = {}
        self.output: Optional[EdgeRef] = None
        self._ids = itertools.count()

    # ------------------------------------------------------- construction
    def _add(
        self,
        kind: str,
        inputs: Tuple[EdgeRef, ...],
        params: Dict[str, Any],
        label: str,
        parallel: bool,
        num_outputs: int = 1,
        annotations: Optional[Dict[str, Any]] = None,
    ) -> Node:
        for nid, port in inputs:
            if nid not in self.nodes:
                raise ValueError(f"unknown input node {nid!r}")
            if not (0 <= port < self.nodes[nid].num_outputs):
                raise ValueError(f"invalid port {port} for node {nid!r}")
        node = Node(
            id=f"n{next(self._ids)}_{kind}",
            kind=kind,
            inputs=tuple(inputs),
            params=dict(params),
            label=label,
            parallel=parallel,
            num_outputs=num_outputs,
            annotations=dict(annotations or {}),
        )
        self.nodes[node.id] = node
        return node

    # ------------------------------------------------------------ hosts
    def declare_host(self, name: str, address: Optional[str] = None) -> HostSpec:
        """Declare a placement host for dataflow fragments.

        ``address=None`` -> driver-managed: ``compile()`` launches a local
        ``RemoteHost`` process and tears it down with the flow.  Pass
        ``"host:port"`` to target an externally-run ``RemoteHost`` (started
        on another machine via ``repro.core.remote.start_local_host`` or an
        equivalent entrypoint).  Source nodes opt in with ``.host(name)``.
        The port has no remote backend yet: lowering a ``host=`` node raises.
        """
        if not isinstance(name, str) or not name:
            raise ValueError(f"declare_host() needs a non-empty name (got {name!r})")
        if name in self.hosts:
            raise ValueError(f"duplicate host {name!r}")
        spec = HostSpec(name, address)
        self.hosts[name] = spec
        return spec

    # ------------------------------------------------------------ sources
    @staticmethod
    def _source_annotations(
        failure_policy: Optional[str],
        resources: Optional[Dict[str, Any]],
        host: Optional[str] = None,
    ) -> Dict[str, Any]:
        ann: Dict[str, Any] = {}
        if failure_policy is not None:
            from repro_torch.core.executor import FailurePolicy

            ann["failure_policy"] = FailurePolicy.validate(failure_policy)
        if resources is not None:
            ann["resources"] = dict(resources)
        if host is not None:
            if not isinstance(host, str) or not host:
                raise ValueError(f"host= needs a non-empty host name (got {host!r})")
            ann["host"] = host
        return ann

    @staticmethod
    def _vector_annotations(
        vector: Optional[int],
        inference: Optional[str],
        inference_credits: Optional[int],
        inference_replicas: Optional[int] = None,
        inference_routing: Optional[str] = None,
        decode: Optional[str] = None,
    ) -> Dict[str, Any]:
        ann: Dict[str, Any] = {}
        if vector is not None:
            if int(vector) < 1:
                raise ValueError(f"vector= needs >= 1 lanes (got {vector})")
            ann["vector"] = int(vector)
        if decode is not None:
            if decode not in ("forward", "cache"):
                raise ValueError(
                    f"unknown decode mode {decode!r} (want 'forward'|'cache')"
                )
            ann["decode"] = decode
        if inference is not None:
            if inference not in ("local", "server"):
                raise ValueError(
                    f"unknown inference mode {inference!r} (want 'local'|'server')"
                )
            ann["inference"] = inference
        if inference_credits is not None:
            if int(inference_credits) < 1:
                raise ValueError(
                    f"inference_credits= must be >= 1 (got {inference_credits})"
                )
            ann["inference_credits"] = int(inference_credits)
        if inference_replicas is not None:
            if int(inference_replicas) < 1:
                raise ValueError(
                    f"inference_replicas= must be >= 1 (got {inference_replicas})"
                )
            ann["inference_replicas"] = int(inference_replicas)
        if inference_routing is not None:
            if inference_routing not in ("auto", "least_loaded", "sticky"):
                raise ValueError(
                    f"unknown inference routing {inference_routing!r} "
                    "(want 'auto'|'least_loaded'|'sticky')"
                )
            ann["inference_routing"] = inference_routing
        return ann

    def rollouts(
        self,
        workers: Any,
        mode: str = "bulk_sync",
        num_async: int = 1,
        credits: Optional[int] = None,
        failure_policy: Optional[str] = None,
        resources: Optional[Dict[str, Any]] = None,
        vector: Optional[int] = None,
        inference: Optional[str] = None,
        inference_credits: Optional[int] = None,
        inference_replicas: Optional[int] = None,
        inference_routing: Optional[str] = None,
        decode: Optional[str] = None,
        host: Optional[str] = None,
    ) -> Stream:
        """Experience stream from the rollout workers (paper Fig 5).

        ``failure_policy`` annotates the node; ``compile()`` lowers it onto
        the rollout actors so gather loops restart/drop/raise per-worker.
        ``credits`` (async mode) caps the total in-flight sample window —
        credit-based backpressure at the source.

        Vectorized rollout engine (carried as node annotations, lowered by
        ``compile()``): ``vector=N`` resizes each worker's ``VectorEnv`` to
        N synchronized lanes with one batched policy dispatch per step;
        ``inference='server'`` additionally decouples acting onto a shared
        ``InferenceActor`` (batched requests over the executor transport,
        ``inference_credits`` bounding requests in flight across shards —
        default ``2 × num_workers``).  ``inference_replicas=N`` serves from
        N replicas behind an ``InferenceRouter`` with per-replica health +
        weight-version tracking; ``inference_routing`` picks the dispatch
        policy (``'auto'`` — sticky iff the policy is stateful —
        ``'least_loaded'``, or ``'sticky'`` lane->replica pinning).  Server
        inference requires thread-backend rollout workers; others fall back
        to local with a warning.  ``decode='cache'`` routes local acting
        through the stateful-policy protocol so per-lane model state (an
        LM's KV cache) rides the rollout scan — one ``decode_step`` per
        token instead of a full forward; policies without the protocol fall
        back to ``'forward'``.
        """
        if mode not in ("raw", "bulk_sync", "async"):
            raise ValueError(f"unknown rollout mode {mode!r}")
        if credits is not None and mode != "async":
            raise ValueError(
                f"credits= requires mode='async' (got mode={mode!r}); other "
                "rollout modes have no in-flight pipeline to bound"
            )
        annotations = self._source_annotations(failure_policy, resources, host)
        annotations.update(
            self._vector_annotations(
                vector, inference, inference_credits,
                inference_replicas, inference_routing, decode,
            )
        )
        node = self._add(
            "rollouts", (),
            {"workers": workers, "mode": mode, "num_async": num_async, "credits": credits},
            f"ParallelRollouts({mode})", parallel=(mode == "raw"),
            annotations=annotations,
        )
        return Stream(self, node.id, parallel=(mode == "raw"))

    def replay(
        self,
        actors: Any,
        num_async: int = 4,
        credits: Optional[int] = None,
        failure_policy: Optional[str] = None,
        resources: Optional[Dict[str, Any]] = None,
        host: Optional[str] = None,
    ) -> Stream:
        """Replayed-batch stream from replay-buffer actors (Ape-X §5.2).

        ``credits`` caps the replay gather's total in-flight window (also
        settable post-hoc via ``.annotate(credits=N)``)."""
        node = self._add(
            "replay", (),
            {"actors": actors, "num_async": num_async, "credits": credits},
            "Replay", False,
            annotations=self._source_annotations(failure_policy, resources, host),
        )
        return Stream(self, node.id)

    def par_gradients(
        self,
        workers: Any,
        failure_policy: Optional[str] = None,
        resources: Optional[Dict[str, Any]] = None,
        vector: Optional[int] = None,
        inference: Optional[str] = None,
        inference_credits: Optional[int] = None,
        inference_replicas: Optional[int] = None,
        inference_routing: Optional[str] = None,
        decode: Optional[str] = None,
        host: Optional[str] = None,
    ) -> Stream:
        """ParIter[(grads, info)]: sample + grad on each worker (A3C/A2C).

        ``vector=``/``inference=``/``decode=`` annotate the vectorized
        rollout engine exactly as on ``rollouts()`` (the gradient workers
        sample through the same engine)."""
        annotations = self._source_annotations(failure_policy, resources, host)
        annotations.update(
            self._vector_annotations(
                vector, inference, inference_credits,
                inference_replicas, inference_routing, decode,
            )
        )
        node = self._add(
            "par_gradients", (), {"workers": workers}, "ComputeGradients", True,
            annotations=annotations,
        )
        return Stream(self, node.id, parallel=True)

    def par_source(
        self,
        pool: Any,
        pull_fn: Callable,
        name: str = "ParSource",
        failure_policy: Optional[str] = None,
        resources: Optional[Dict[str, Any]] = None,
        host: Optional[str] = None,
    ) -> Stream:
        """Generic parallel source over an actor pool (MAML inner loop, LM
        data pipelines)."""
        node = self._add(
            "par_source", (), {"pool": pool, "pull_fn": pull_fn}, name, True,
            annotations=self._source_annotations(failure_policy, resources, host),
        )
        return Stream(self, node.id, parallel=True)

    def from_items(self, items: Sequence[Any], repeat: bool = False) -> Stream:
        """Local stream over in-memory items (tests, micro-benchmarks)."""
        node = self._add("from_items", (), {"items": list(items), "repeat": repeat}, "FromItems", False)
        return Stream(self, node.id)

    def dequeue(self, resource: ResourceRef) -> Stream:
        """Stream popped from a deferred resource's out-queue."""
        node = self._add(
            "dequeue", (), {"resource": resource.name},
            f"Dequeue({resource.name}.outqueue)", False,
        )
        return Stream(self, node.id)

    # ---------------------------------------------------------- resources
    def learner_thread(self, workers: Any, name: str = "learner", **params: Any) -> ResourceRef:
        """Declare a learner thread fed/drained by enqueue/dequeue nodes.

        Nothing is constructed or started here — instantiation happens at
        compile time, ``Thread.start()`` on the first pull of the compiled
        flow, ``stop()`` + join when the flow stops.
        """
        if name in self.resources:
            raise ValueError(f"duplicate resource {name!r}")
        self.resources[name] = ResourceSpec(name, "learner_thread", {"workers": workers, **params})
        return ResourceRef(self, name)

    # -------------------------------------------------------- concurrency
    def concurrently(
        self,
        streams: Sequence[Stream],
        mode: str = "round_robin",
        output_indexes: Optional[Sequence[int]] = None,
        round_robin_weights: Optional[Sequence[Union[int, str]]] = None,
    ) -> Stream:
        """Union concurrent sub-flows (paper Fig 8); emit ``output_indexes``."""
        if mode not in ("round_robin", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if not streams:
            raise ValueError("concurrently() needs at least one stream")
        for s in streams:
            s._require_local("concurrently")
        out_idx = list(output_indexes) if output_indexes is not None else list(range(len(streams)))
        for i in out_idx:
            if not (0 <= i < len(streams)):
                raise ValueError(f"output index {i} out of range")
        if round_robin_weights is not None and len(round_robin_weights) != len(streams):
            raise ValueError("round_robin_weights must match #streams")
        node = self._add(
            "concurrently",
            tuple(s.ref for s in streams),
            {
                "mode": mode,
                "output_indexes": out_idx,
                "round_robin_weights": list(round_robin_weights) if round_robin_weights else None,
            },
            f"Concurrently({mode})",
            False,
        )
        return Stream(self, node.id)

    def set_output(self, stream: Stream) -> None:
        stream._require_local("set_output")
        self.output = stream.ref

    # --------------------------------------------------------- validation
    def validate(self) -> None:
        if self.output is None:
            raise ValueError(f"flow {self.name!r}: no output set (call set_output)")
        consumed: Dict[EdgeRef, int] = {}
        for node in self.nodes.values():
            for ref in node.inputs:
                consumed[ref] = consumed.get(ref, 0) + 1
        consumed[self.output] = consumed.get(self.output, 0) + 1
        for ref, n in consumed.items():
            if n > 1:
                raise ValueError(
                    f"flow {self.name!r}: edge {ref} consumed {n} times; "
                    "use duplicate() to split a stream"
                )
        for name in self._referenced_resources():
            if name not in self.resources:
                raise ValueError(f"flow {self.name!r}: undeclared resource {name!r}")

    def check(self, rules: Any = None) -> List[Any]:
        """Static analysis (flowcheck): run the rule set, return diagnostics.

        Unlike ``validate()`` — which raises on the three structural
        invariants lowering cannot survive — ``check()`` never raises on
        account of the graph: it returns the full ``Diagnostic`` list
        (credit deadlocks, unbounded queues, annotations that cannot lower,
        ... — see ``docs/flowcheck.md``), sorted errors-first.  Gate on it
        with ``compile(strict=True)`` or ``scripts/flowcheck.py``.
        """
        from repro_torch.flow.analysis.engine import analyze

        return analyze(self, rules=rules)

    def _referenced_resources(self) -> List[str]:
        return [
            n.params["resource"] for n in self.nodes.values() if n.kind in ("enqueue", "dequeue")
        ]

    # ------------------------------------------------------ introspection
    def consumers(self, node_id: str) -> int:
        """How many edges read from ``node_id`` (any port), incl. the output."""
        n = sum(1 for node in self.nodes.values() for ref in node.inputs if ref[0] == node_id)
        if self.output is not None and self.output[0] == node_id:
            n += 1
        return n

    def replace_nodes(self, nodes: Dict[str, Node]) -> "FlowSpec":
        """Structural copy with a rewritten node table (optimization passes)."""
        out = FlowSpec(self.name)
        out.nodes = dict(nodes)
        out.resources = dict(self.resources)
        out.hosts = dict(self.hosts)
        out.output = self.output
        out._ids = self._ids
        return out

    def compile(self, fuse: bool = True, strict: bool = False) -> Any:
        """Lower onto the iterator runtime; see ``repro_torch.flow.compile``.

        ``strict=True`` runs ``check()`` first and refuses to build anything
        when the graph carries error-severity diagnostics."""
        from repro_torch.flow.compile import CompiledFlow

        return CompiledFlow(self, fuse=fuse, strict=strict)

    # -------------------------------------------------------------- DOT
    def to_dot(self, metrics: Any = None) -> str:
        """Render the graph as Graphviz DOT (paper Figures 9–12).

        Stream edges are solid; edges into/out of deferred resources are
        dotted; branches merged by an async union are dashed pink (the
        paper's asynchronous-dependency arrows).

        With a ``MetricsContext`` (``Algorithm.to_dot(with_metrics=True)``
        passes the live one), data-plane edges gain labels: bytes moved out
        of each sequencing/enqueue node (``bytes_moved/<node>`` counters,
        keyed by node id at lowering) and current queue occupancy on
        resource edges — the paper's Fig 13 data plane, readable off the
        graph.
        """

        def esc(s: str) -> str:
            return s.replace("\\", "\\\\").replace('"', '\\"')

        counters = metrics.counters if metrics is not None else {}
        gauges = metrics.gauges if metrics is not None else {}

        def _human_bytes(n: float) -> str:
            for unit in ("B", "KB", "MB", "GB", "TB"):
                if n < 1024 or unit == "TB":
                    return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
                n /= 1024.0
            return f"{n:.1f}TB"

        def _edge_metric_label(src_node_id: str) -> Optional[str]:
            moved = counters.get(f"bytes_moved/{src_node_id}")
            if moved:
                return _human_bytes(float(moved))
            return None

        lines = [
            f'digraph "{esc(self.name)}" {{',
            "  rankdir=LR;",
            '  node [shape=box, fontname="Helvetica", fontsize=11];',
        ]
        for res in self.resources.values():
            lines.append(
                f'  "{esc(res.name)}" [shape=ellipse, style=filled, '
                f'fillcolor=lightgrey, label="LearnerThread({esc(res.name)})"];'
            )
        # Nodes grouped by placement fragment: host-annotated nodes render
        # inside a dashed cluster per declared host (MSRL's per-host
        # dataflow-fragment picture); everything else is the driver fragment.
        by_host: Dict[Optional[str], List[str]] = {}
        for node in self.nodes.values():
            if node.kind == "for_each":
                label = "\\n".join(esc(s.label) for s in node.params["stages"])
            else:
                label = esc(node.label)
            if node.annotations:
                ann = ", ".join(f"{k}={v}" for k, v in sorted(node.annotations.items()))
                label = f"{label}\\n[{esc(ann)}]"
            shape = ""
            if node.kind == "concurrently":
                shape = ", shape=hexagon"
            elif node.kind in ("duplicate",):
                shape = ", shape=trapezium"
            elif node.parallel or node.kind in ("rollouts", "replay", "par_gradients", "par_source"):
                shape = ", style=rounded"
            host = node.annotations.get("host") if self.hosts else None
            by_host.setdefault(host if host in self.hosts else None, []).append(
                f'"{node.id}" [label="{label}"{shape}];'
            )
        lines.extend(f"  {line}" for line in by_host.get(None, []))
        for i, host_name in enumerate(sorted(h for h in by_host if h is not None)):
            addr = self.hosts[host_name].address or "driver-managed"
            lines.append(f'  subgraph "cluster_host_{i}" {{')
            lines.append(f'    label="fragment: {esc(host_name)} ({esc(addr)})";')
            lines.append("    style=dashed;")
            lines.extend(f"    {line}" for line in by_host[host_name])
            lines.append("  }")
        for node in self.nodes.values():
            async_union = node.kind == "concurrently" and node.params.get("mode") == "async"
            for i, (src, port) in enumerate(node.inputs):
                attrs = []
                if async_union and i not in node.params["output_indexes"]:
                    attrs.append("style=dashed")
                    attrs.append("color=deeppink")
                elif async_union:
                    attrs.append("color=deeppink")
                if node.kind == "concurrently":
                    label = str(i)
                    moved = _edge_metric_label(src)
                    if moved:
                        label = f"{i}: {moved}"
                    attrs.append(f'label="{esc(label)}"')
                else:
                    moved = _edge_metric_label(src)
                    if moved:
                        attrs.append(f'label="{esc(moved)}"')
                a = f" [{', '.join(attrs)}]" if attrs else ""
                lines.append(f'  "{src}" -> "{node.id}"{a};')
            if node.kind == "enqueue":
                attrs = ["style=dotted"]
                occ = gauges.get(f"queue_occupancy/{node.id}")
                moved = _edge_metric_label(node.id)
                parts = [p for p in (moved, f"q={occ:.0f}" if occ is not None else None) if p]
                if parts:
                    attrs.append(f'label="{esc(" ".join(parts))}"')
                lines.append(
                    f'  "{node.id}" -> "{node.params["resource"]}" [{", ".join(attrs)}];'
                )
            if node.kind == "dequeue":
                attrs = ["style=dotted"]
                occ = gauges.get(f"queue_occupancy/{node.id}")
                if occ is not None:
                    attrs.append(f'label="q={occ:.0f}"')
                lines.append(
                    f'  "{node.params["resource"]}" -> "{node.id}" [{", ".join(attrs)}];'
                )
        if self.output is not None:
            lines.append(f'  "__out" [shape=plaintext, label="results"];')
            lines.append(f'  "{self.output[0]}" -> "__out";')
        lines.append("}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FlowSpec({self.name!r}, nodes={len(self.nodes)}, resources={list(self.resources)})"
