"""The built-in rule set (PyTorch port of ``repro/flow/analysis/rules.py``).

Every rule checks a *graph property* — something knowable before a single
actor spawns, the way MSRL validates fragment partitions statically.  The
catalog, severity policy, and example output per rule live in
``docs/flowcheck.md``; each rule here cites the concrete runtime failure it
front-runs.  Two rules differ from the JAX package's: the visible devices
are CUDA cards (one CPU device without a card, as ``jax.devices()`` counts
it), and the determinism hazard flags torch's global generator, where the
reference exempts ``jax.random``.
"""

from __future__ import annotations

import dis
import os
import pickle
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.executor import FailurePolicy
from repro_torch.core.transport import OverflowPolicy
from repro_torch.flow.analysis.diagnostics import Diagnostic, Severity
from repro_torch.flow.analysis.engine import (
    CREDIT_KINDS,
    SOURCE_KINDS,
    GraphView,
    rule,
)

__all__: List[str] = []  # rules register via the decorator, not by import

# Annotation keys lowered onto TrainOneStep-like stages / source nodes.
_LEARNER_KEYS = ("num_learners", "microbatch")
_VECTOR_KEYS = (
    "vector",
    "inference",
    "inference_credits",
    "inference_replicas",
    "inference_routing",
    "decode",
)


# --------------------------------------------------------------------------
# graph-structure: FlowSpec.validate() as diagnostics + dead-subflow checks
# --------------------------------------------------------------------------
@rule("graph-structure", "output set, single consumption, resource wiring")
def _graph_structure(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    if spec.output is None:
        yield Diagnostic(
            "graph-structure", Severity.ERROR,
            "no output set: nothing will ever be pulled from this flow",
            hint="call spec.set_output(stream) on the result stream",
        )
    consumed: Dict[Tuple[str, int], int] = {}
    for node in spec.nodes.values():
        for ref in node.inputs:
            consumed[ref] = consumed.get(ref, 0) + 1
    if spec.output is not None:
        consumed[spec.output] = consumed.get(spec.output, 0) + 1
    for ref, n in sorted(consumed.items()):
        if n > 1:
            yield Diagnostic(
                "graph-structure", Severity.ERROR,
                f"edge {ref} is consumed {n} times; each stream edge feeds "
                "exactly one consumer",
                node=ref[0], edge=ref,
                hint="split the stream explicitly with duplicate(n)",
            )
    for name in spec._referenced_resources():
        if name not in spec.resources:
            yield Diagnostic(
                "graph-structure", Severity.ERROR,
                f"enqueue/dequeue references undeclared resource {name!r}",
                hint="declare it first (spec.learner_thread(workers, name=...))",
            )
    for name in spec.resources:
        if name not in view.enqueues and name not in view.dequeues:
            yield Diagnostic(
                "graph-structure", Severity.WARN,
                f"resource {name!r} is declared but no enqueue/dequeue node "
                "references it; it will be started and never fed",
                hint="wire it (stream.enqueue(ref) / spec.dequeue(ref)) or "
                "drop the declaration",
            )
    # Dead sub-flows: an output port nobody consumes is work that never runs
    # (or, for duplicate ports, a buffer that grows while its siblings are
    # pulled).
    for node in spec.nodes.values():
        for port in range(node.num_outputs):
            ref = (node.id, port)
            if consumed.get(ref):
                continue
            if spec.output is not None and spec.output == ref:
                continue
            yield Diagnostic(
                "graph-structure", Severity.WARN,
                f"output port {port} of {node.label!r} is never consumed: "
                "this sub-flow is dead (its operators never execute)",
                node=node.id, edge=ref,
                hint="merge the branch into the flow (concurrently/enqueue) "
                "or remove it",
            )


# --------------------------------------------------------------------------
# credit-deadlock: bounded windows that can wedge the pull cycle
# --------------------------------------------------------------------------
@rule("credit-deadlock", "credit/queue cycles whose demand exceeds supply")
def _credit_deadlock(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    for name, res in spec.resources.items():
        if res.kind != "learner_thread":
            continue
        out_policy = res.params.get("out_policy", OverflowPolicy.DROP_NEWEST)
        if out_policy != OverflowPolicy.BLOCK:
            continue
        in_size = res.params.get("in_queue_size", 16)
        out_size = res.params.get("out_queue_size", 64)
        demand = in_size + out_size + 2  # queues + item in learner + in feed
        blocking = [
            n for n in view.enqueues.get(name, ())
            if view.effective_enqueue_policy(n) == OverflowPolicy.BLOCK
        ]
        deqs = view.dequeues.get(name, ())
        if blocking and not deqs:
            for enq in blocking:
                yield Diagnostic(
                    "credit-deadlock", Severity.ERROR,
                    f"blocking enqueue into {name!r} whose out-queue policy "
                    "is 'block' but which no dequeue node drains: after "
                    f"~{demand} items the learner wedges on its out-queue, "
                    "the in-queue fills, and this enqueue (plus any credits "
                    "held upstream) blocks forever",
                    node=enq.id,
                    hint=f"add spec.dequeue({name!r}) to a consuming branch, "
                    "or declare the learner with out_policy='drop_newest'",
                )
            continue
        # Both sides exist: the cycle deadlocks when a single round-robin
        # driver owns both branches — it blocks pulling the enqueue branch
        # and never reaches the dequeue branch that would free the cycle.
        for enq in blocking:
            union = view.union_of(enq.id)
            if union is None or union.params.get("mode") != "round_robin":
                continue
            for deq in deqs:
                deq_union = view.union_of(deq.id)
                if deq_union is not None and deq_union.id == union.id:
                    yield Diagnostic(
                        "credit-deadlock", Severity.ERROR,
                        f"blocking enqueue and dequeue of {name!r} (out-queue "
                        "policy 'block') are merged by a round_robin union: "
                        "one driver thread pulls both branches in turn, so "
                        f"once ~{demand} items are in flight it blocks on "
                        "the full in-queue and never pulls the dequeue "
                        "branch that would drain the cycle",
                        node=union.id,
                        hint="use concurrently(mode='async') so each branch "
                        "gets its own driver, or relax one queue policy",
                    )
                    break
    # Credit starvation: a window smaller than the shard set leaves shards
    # idle every round (FIFO backfill keeps liveness, but parallelism and
    # throughput silently shrink).
    for node in spec.nodes.values():
        if node.kind not in CREDIT_KINDS:
            continue
        credits = view.effective_credits(node)
        if credits is None or not isinstance(credits, int):
            continue
        src = node if node.kind in SOURCE_KINDS else view.source_of(node.id)
        shards = view.shard_count(src) if src is not None else None
        if shards and credits < shards:
            yield Diagnostic(
                "credit-deadlock", Severity.WARN,
                f"credits={credits} is below the {shards}-shard pool: at "
                f"most {credits} shards can have work in flight, so "
                f"{shards - credits} shards sit starved every round",
                node=node.id,
                hint=f"raise credits to >= {shards} (or remove the bound "
                "for the num_async * shards default)",
            )


# --------------------------------------------------------------------------
# unbounded-queue: async windows with no credit bound feeding blocking queues
# --------------------------------------------------------------------------
@rule("unbounded-queue", "blocking queue feeds with an unbounded async window")
def _unbounded_queue(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    for node in spec.nodes.values():
        if node.kind == "enqueue":
            if view.effective_enqueue_policy(node) != OverflowPolicy.BLOCK:
                continue
            window = _async_window(view, node)
            if window is None:
                continue
            win_node, bounded = window
            if bounded:
                continue
            yield Diagnostic(
                "unbounded-queue", Severity.WARN,
                f"blocking enqueue is fed by {win_node.label!r} with no "
                "credit bound: the in-flight window is num_async x shards "
                "and grows under elastic add_workers, so a stalled learner "
                "backs pressure into an ever-larger dispatched backlog",
                node=node.id,
                hint=f"set credits= on {win_node.label!r} (or an overflow "
                "policy on the enqueue) to make the window explicit",
            )
        elif node.kind == "duplicate":
            union = view.union_of(node.id)
            if union is not None and union.params.get("mode") == "async":
                yield Diagnostic(
                    "unbounded-queue", Severity.WARN,
                    f"{node.label!r} branches merge in an async union: "
                    "branches are pulled at independent rates, so the "
                    "slower branch's duplicate buffer grows without bound",
                    node=node.id,
                    hint="merge duplicate branches with a round_robin union "
                    "(rate-coupled pulls) or bound the fast branch",
                )


def _async_window(
    view: GraphView, enq: Any
) -> Optional[Tuple[Any, bool]]:
    """The async dispatch window feeding ``enq``: (node, has_credit_bound).

    Returns None when the feed is synchronous (bulk_sync rollouts,
    gather_sync rounds, from_items) — those are bounded by construction.
    """
    for up in view.upstream(enq.id):
        if up.kind == "gather_async":
            return up, view.effective_credits(up) is not None
        if up.kind == "rollouts" and up.params.get("mode") == "async":
            return up, view.effective_credits(up) is not None
        if up.kind == "replay":
            return up, view.effective_credits(up) is not None
    return None


# --------------------------------------------------------------------------
# annotation-lowering: annotations that can't lower (lowering fallbacks)
# --------------------------------------------------------------------------
@rule("annotation-lowering", "annotations that cannot lower on their node")
def _annotation_lowering(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    policy_by_pool: Dict[int, Tuple[str, str]] = {}  # id(pool) -> (policy, node)
    for node in spec.nodes.values():
        ann = node.annotations
        yield from _check_learner_annotations(node, ann)
        yield from _check_vector_annotations(view, node, ann)
        # overflow_policy: only the enqueue lowering reads it.
        op = ann.get("overflow_policy")
        if op is not None:
            if node.kind != "enqueue":
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"overflow_policy={op!r} annotates a {node.kind!r} node; "
                    "only enqueue nodes lower it — the annotation is "
                    "silently ignored",
                    node=node.id,
                    hint="move the annotation onto the enqueue node",
                )
            elif op not in OverflowPolicy.ALL:
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"unknown overflow_policy {op!r} "
                    f"(want one of {sorted(OverflowPolicy.ALL)})",
                    node=node.id,
                    hint="pick 'block', 'drop_newest', or 'drop_oldest'",
                )
        # credits: only async gathers and async sources lower it.
        credits = ann.get("credits")
        if credits is not None:
            if node.kind not in CREDIT_KINDS:
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"credits={credits!r} annotates a {node.kind!r} node; "
                    "only gather_async/rollouts/replay lower credits — the "
                    "annotation is silently ignored",
                    node=node.id,
                    hint="move the bound onto the async gather or source",
                )
            elif not isinstance(credits, int) or credits < 1:
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"credits={credits!r} is not a positive int",
                    node=node.id, hint="credits must be >= 1 (or unset)",
                )
            elif node.kind == "rollouts" and node.params.get("mode") != "async":
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"credits={credits} on rollouts(mode="
                    f"{node.params.get('mode')!r}): only async rollouts "
                    "have an in-flight pipeline to bound",
                    node=node.id, hint="use mode='async' or drop the bound",
                )
        # failure_policy: applied to source actors only.
        fp = ann.get("failure_policy")
        if fp is not None:
            if fp not in FailurePolicy.ALL:
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"unknown failure_policy {fp!r} "
                    f"(want one of {sorted(FailurePolicy.ALL)})",
                    node=node.id,
                    hint="pick 'raise', 'restart', or 'drop_shard'",
                )
            elif node.kind not in SOURCE_KINDS:
                yield Diagnostic(
                    "annotation-lowering", Severity.ERROR,
                    f"failure_policy={fp!r} annotates a {node.kind!r} node; "
                    "policies lower onto source actors only — the "
                    "annotation is silently ignored",
                    node=node.id,
                    hint="annotate the source node (rollouts/replay/...)",
                )
            else:
                pool = view.node_pool(node)
                prior = policy_by_pool.get(id(pool))
                if prior is not None and prior[0] != fp:
                    yield Diagnostic(
                        "annotation-lowering", Severity.WARN,
                        f"failure_policy={fp!r} conflicts with "
                        f"{prior[0]!r} set by node {prior[1]} on the same "
                        "actor pool; the policy is per-actor and the last "
                        "lowered node wins for every stream sharing it",
                        node=node.id,
                        hint="annotate the pool's nodes consistently",
                    )
                policy_by_pool[id(pool)] = (fp, node.id)


def _check_learner_annotations(node: Any, ann: Dict[str, Any]) -> Iterator[Diagnostic]:
    if not any(k in ann for k in _LEARNER_KEYS):
        return
    carried = {k: ann[k] for k in _LEARNER_KEYS if k in ann}
    for key, val in carried.items():
        if not isinstance(val, int) or val < 1:
            yield Diagnostic(
                "annotation-lowering", Severity.ERROR,
                f"{key}={val!r} is not a positive int",
                node=node.id, hint=f"{key} must be >= 1",
            )
    if node.kind != "for_each":
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"{'/'.join(carried)} annotates a {node.kind!r} node; the "
            "learner group lowers only onto TrainOneStep-like for_each "
            "stages — the annotation is silently ignored",
            node=node.id,
            hint="chain .learners(n)/.microbatch(k) on the train stage",
        )
        return
    if node.parallel:
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"{'/'.join(carried)} annotates a *parallel* for_each; the "
            "learner group lowers only onto local train stages",
            node=node.id,
            hint="sequence the stream first "
            "(gather_sync/gather_async/batch_across_shards)",
        )
        return
    stages = node.params["stages"]
    capable = [
        s for s in stages
        if not s.ctx
        and hasattr(s.fn, "num_learners") and hasattr(s.fn, "microbatch")
    ]
    if capable:
        return
    if any(s.ctx for s in stages):
        yield Diagnostic(
            "annotation-lowering", Severity.INFO,
            f"{'/'.join(carried)} on a context-built stage: the static "
            "pass cannot verify the compiled callable accepts learner "
            "knobs (checked again at lowering)",
            node=node.id,
            hint="prefer annotating a plain TrainOneStep stage",
        )
    else:
        names = ", ".join(s.label for s in stages) or "<none>"
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"{'/'.join(carried)} but no stage of this node accepts "
            f"learner knobs (stages: {names}); the annotation is silently "
            "ignored and training stays single-device",
            node=node.id,
            hint="attach the annotation to the TrainOneStep stage's node",
        )


def _check_vector_annotations(
    view: GraphView, node: Any, ann: Dict[str, Any]
) -> Iterator[Diagnostic]:
    if not any(k in ann for k in _VECTOR_KEYS):
        return
    carried = {k: ann[k] for k in _VECTOR_KEYS if k in ann}
    if node.kind not in ("rollouts", "par_gradients"):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"{'/'.join(carried)} annotates a {node.kind!r} node; the "
            "vectorized rollout engine lowers only onto rollouts/"
            "par_gradients sources — the annotation is silently ignored",
            node=node.id,
            hint="pass vector=/inference= to spec.rollouts()/par_gradients()",
        )
        return
    vec = carried.get("vector")
    if vec is not None and (not isinstance(vec, int) or vec < 1):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"vector={vec!r} is not a positive lane count",
            node=node.id, hint="vector must be >= 1",
        )
    creds = carried.get("inference_credits")
    if creds is not None and (not isinstance(creds, int) or creds < 1):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"inference_credits={creds!r} is not a positive int",
            node=node.id, hint="inference_credits must be >= 1",
        )
    replicas = carried.get("inference_replicas")
    if replicas is not None and (not isinstance(replicas, int) or replicas < 1):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"inference_replicas={replicas!r} is not a positive int",
            node=node.id, hint="inference_replicas must be >= 1",
        )
    dec = carried.get("decode")
    if dec is not None and dec not in ("forward", "cache"):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"unknown decode mode {dec!r} (want 'forward'|'cache')",
            node=node.id, hint="pick 'forward' or 'cache'",
        )
    routing = carried.get("inference_routing")
    if routing is not None and routing not in ("auto", "least_loaded", "sticky"):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"unknown inference routing {routing!r} "
            "(want 'auto'|'least_loaded'|'sticky')",
            node=node.id, hint="pick 'auto', 'least_loaded', or 'sticky'",
        )
    inf = carried.get("inference")
    if inf != "server" and (replicas is not None or routing is not None):
        keys = "/".join(
            k for k in ("inference_replicas", "inference_routing") if k in carried
        )
        yield Diagnostic(
            "annotation-lowering", Severity.WARN,
            f"{keys} without inference='server': the serving tier only "
            "lowers in server mode, so the annotation is silently ignored",
            node=node.id,
            hint="add inference='server' (or drop the serving knobs)",
        )
    if inf is not None and inf not in ("local", "server"):
        yield Diagnostic(
            "annotation-lowering", Severity.ERROR,
            f"unknown inference mode {inf!r} (want 'local'|'server')",
            node=node.id, hint="pick 'local' or 'server'",
        )
    elif inf == "server":
        pool = view.node_pool(node)
        lw = pool.local_worker() if hasattr(pool, "local_worker") else None
        if lw is not None and getattr(lw, "policy", None) is None:
            yield Diagnostic(
                "annotation-lowering", Severity.ERROR,
                "inference='server' but the local worker has no .policy to "
                "serve; lowering falls back to local inference",
                node=node.id,
                hint="use a worker type exposing .policy, or drop "
                "inference='server'",
            )


# --------------------------------------------------------------------------
# cross-host-placement: host annotations that cannot partition cleanly
# --------------------------------------------------------------------------
@rule("cross-host-placement", "host fragments that cannot lower cleanly")
def _cross_host_placement(view: GraphView) -> Iterator[Diagnostic]:
    """Validate the multi-host fragment partition before any host launches.

    ``compile()`` splits a spec into per-host fragments along ``host=``
    annotations, rehoming each annotated source pool onto a
    ``RemoteBackend`` (socket transport).  Everything that would make that
    partition unsound is a graph property: placement on a node lowering
    never reads, an undeclared host, an shm data plane that cannot span
    the host boundary, or a driver-pinned inference server claimed by a
    remote fragment.
    """
    spec = view.spec
    host_by_pool: Dict[int, Tuple[str, str]] = {}  # id(pool) -> (host, node)
    for node in spec.nodes.values():
        host = node.annotations.get("host")
        if host is None:
            continue
        if not isinstance(host, str) or not host:
            yield Diagnostic(
                "cross-host-placement", Severity.ERROR,
                f"host={host!r} is not a host name",
                node=node.id,
                hint="annotate with the name passed to spec.declare_host()",
            )
            continue
        if node.kind not in SOURCE_KINDS:
            yield Diagnostic(
                "cross-host-placement", Severity.ERROR,
                f"host={host!r} annotates a {node.kind!r} node; placement "
                "lowers onto source actor pools only — the annotation is "
                "silently ignored and the node stays on the driver",
                node=node.id,
                hint="annotate the source node (rollouts/replay/"
                "par_gradients/par_source)",
            )
            continue
        if host not in spec.hosts:
            yield Diagnostic(
                "cross-host-placement", Severity.ERROR,
                f"host={host!r} is not declared on this spec; lowering "
                "degrades the fragment to the driver's local backend",
                node=node.id,
                hint=f"call spec.declare_host({host!r}) before compiling",
            )
            continue
        # shm edges may not span fragments: a SharedMemoryTransport ref
        # names a segment in the *driver's* /dev/shm, which does not exist
        # on the remote host — rehoming a process(shm)-backed actor would
        # swap its data plane out from under the pool mid-flow.
        procs = view.process_backed(node)
        if procs:
            yield Diagnostic(
                "cross-host-placement", Severity.ERROR,
                f"host={host!r} on a source pool with process-backed "
                f"actors ({', '.join(procs)}): their shm/pipe data plane "
                "is local to the driver machine and cannot span the host "
                "boundary",
                node=node.id,
                hint="build the pool on the thread backend and let host= "
                "move it onto the socket transport, or drop the annotation",
            )
        # The decoupled inference server is a driver-side VirtualActor
        # shared by all shards; a remote fragment's shards would call back
        # across the host boundary on every action, defeating the split.
        if node.annotations.get("inference") == "server":
            yield Diagnostic(
                "cross-host-placement", Severity.ERROR,
                f"inference='server' on a node placed on host {host!r}: "
                "the inference server is pinned to the driver fragment, so "
                "every action round-trips the socket and the fragment "
                "split buys nothing",
                node=node.id,
                hint="use inference='local' on remote fragments, or keep "
                "the served pool on the driver",
            )
        pool = view.node_pool(node)
        prior = host_by_pool.get(id(pool))
        if prior is not None and prior[0] != host:
            yield Diagnostic(
                "cross-host-placement", Severity.WARN,
                f"host={host!r} conflicts with {prior[0]!r} set by node "
                f"{prior[1]} on the same actor pool; placement is "
                "per-actor and the first lowered node wins",
                node=node.id,
                hint="annotate the pool's nodes with one host",
            )
        host_by_pool[id(pool)] = (host, node.id)
    for name in spec.hosts:
        if not any(
            n.annotations.get("host") == name for n in spec.nodes.values()
        ):
            yield Diagnostic(
                "cross-host-placement", Severity.WARN,
                f"host {name!r} is declared but no node is placed on it; "
                "the declaration is dead (hosts launch lazily, so nothing "
                "runs there)",
                hint=f"place a source on it (.host({name!r})) or drop the "
                "declaration",
            )


# --------------------------------------------------------------------------
# pickle-safety: process-backend boundaries that silently change semantics
# --------------------------------------------------------------------------
@rule("pickle-safety", "state that cannot cross a ProcessBackend boundary")
def _pickle_safety(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    for node in spec.nodes.values():
        if (
            node.kind in ("rollouts", "par_gradients")
            and node.annotations.get("inference") == "server"
        ):
            procs = view.process_backed(node)
            if procs:
                yield Diagnostic(
                    "pickle-safety", Severity.WARN,
                    "inference='server' with process-backed workers "
                    f"({', '.join(procs)}): InferenceClient handles do not "
                    "pickle, so these workers silently fall back to local "
                    "inference (vectorization still applies)",
                    node=node.id,
                    hint="use thread-backend rollout workers for decoupled "
                    "inference, or accept local inference explicitly",
                )
        if node.kind == "for_each" and node.parallel:
            src = view.source_of(node.id)
            if src is None or not view.process_backed(src):
                continue
            for stage in node.params["stages"]:
                if stage.ctx:
                    continue
                exc = _unpicklable(stage.fn)
                if exc is not None:
                    yield Diagnostic(
                        "pickle-safety", Severity.WARN,
                        f"parallel stage {stage.label!r} over a "
                        "process-backed pool is not picklable "
                        f"({exc}): it cannot be cloned per shard, so all "
                        "shards share one driver-side instance (per-shard "
                        "state becomes global state)",
                        node=node.id,
                        hint="make the stage a module-level callable "
                        "without live handles, or mark it "
                        "share_across_shards=True to document the sharing",
                    )
        if node.kind == "par_source" and view.process_backed(node):
            exc = _unpicklable(node.params["pull_fn"])
            if exc is not None:
                yield Diagnostic(
                    "pickle-safety", Severity.INFO,
                    f"par_source pull_fn is not picklable ({exc}); it runs "
                    "driver-side against RPC proxies, so every pulled item "
                    "round-trips the process boundary",
                    node=node.id,
                    hint="keep pull_fn free of live handles where possible",
                )


def _unpicklable(fn: Any) -> Optional[str]:
    try:
        pickle.dumps(fn)
        return None
    except Exception as exc:
        return f"{type(exc).__name__}: {exc}"


# --------------------------------------------------------------------------
# resource-oversubscription: declared demand vs visible hardware
# --------------------------------------------------------------------------
@rule("resource-oversubscription", "declared demand beyond visible hardware")
def _resource_oversubscription(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    ndev = _visible_devices()
    for node in spec.nodes.values():
        nl = node.annotations.get("num_learners")
        if isinstance(nl, int) and nl > ndev:
            yield Diagnostic(
                "resource-oversubscription", Severity.ERROR,
                f"num_learners={nl} exceeds the {ndev} visible "
                "device(s); the learner group will clamp the mesh and "
                "train on fewer shards than declared",
                node=node.id,
                hint=f"lower num_learners to <= {ndev}, or expose more "
                "cards with CUDA_VISIBLE_DEVICES",
            )
    for res in spec.resources.values():
        nl = res.params.get("num_learners") or 0
        if isinstance(nl, int) and nl > ndev:
            yield Diagnostic(
                "resource-oversubscription", Severity.ERROR,
                f"resource {res.name!r} declares num_learners={nl} but "
                f"only {ndev} device(s) are visible; the learner group "
                "will clamp the mesh",
                hint=f"lower num_learners to <= {ndev}, or expose more "
                "cards with CUDA_VISIBLE_DEVICES",
            )
    ncpu = os.cpu_count()
    if ncpu:
        demand = 0
        anchors: List[str] = []
        for node in spec.nodes.values():
            if node.kind not in SOURCE_KINDS:
                continue
            res = node.annotations.get("resources") or {}
            per_shard = res.get("num_cpus")
            if not per_shard:
                continue
            shards = view.shard_count(node) or 1
            demand += per_shard * shards
            anchors.append(node.id)
        if anchors and demand > ncpu:
            yield Diagnostic(
                "resource-oversubscription", Severity.WARN,
                f"declared CPU demand totals {demand} across "
                f"{len(anchors)} source node(s) but only {ncpu} CPUs are "
                "visible; shards will contend instead of running in "
                "parallel",
                node=anchors[0],
                details={"declared": demand, "available": ncpu},
                hint="shrink num_cpus/shard counts or run on a bigger host",
            )


def _visible_devices() -> int:
    """The learner group's devices: the visible CUDA cards, or the one CPU
    device when there is no card (``jax.devices()`` counts the CPU the same
    way in the reference)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# --------------------------------------------------------------------------
# determinism-hazard: ambient RNG reaching a plan
# --------------------------------------------------------------------------
@rule("determinism-hazard", "stages drawing from ambient (unseeded) RNG")
def _determinism_hazard(view: GraphView) -> Iterator[Diagnostic]:
    spec = view.spec
    for node in spec.nodes.values():
        for fn in view.stage_fns(node):
            reason = _ambient_rng_use(fn)
            if reason is not None:
                label = getattr(fn, "__name__", type(fn).__name__)
                yield Diagnostic(
                    "determinism-hazard", Severity.WARN,
                    f"stage {label!r} references {reason}: replayed runs "
                    "diverge and the bit-determinism guarantees do "
                    "not cover this plan",
                    node=node.id,
                    hint="thread an explicit seeded generator (torch.Generator / "
                    "np.random.Generator) through the stage instead",
                )


# torch's sampling functions that draw from the global generator unless a
# ``generator=`` is passed, and its global seeding.
_TORCH_GLOBAL_RNG = frozenset(
    ("rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial")
)


def _ambient_rng_use(fn: Any) -> Optional[str]:
    """Best-effort code-object scan for global-RNG use inside a stage.

    Flags the stdlib ``random`` module (resolved through the function's
    globals, so a local variable named ``random`` never trips it), the
    ``np.random``/``numpy.random`` global generator, and torch's global
    generator: ``torch.manual_seed`` and any of ``_TORCH_GLOBAL_RNG`` called
    through the ``torch`` module more often than the code passes a
    ``generator=`` keyword.  A stage that threads a ``torch.Generator`` into
    its draws stays quiet.
    """
    import random as _stdlib_random

    target = fn if hasattr(fn, "__code__") else getattr(type(fn), "__call__", None)
    code = getattr(target, "__code__", None)
    if code is None:
        return None
    codes = []
    stack = [code]
    while stack:
        c = stack.pop()
        codes.append(c)
        stack.extend(const for const in c.co_consts if hasattr(const, "co_names"))
    names = set().union(*(c.co_names for c in codes))
    fn_globals = getattr(target, "__globals__", {})
    if "random" in names:
        if fn_globals.get("random") is _stdlib_random:
            return "the stdlib `random` module (process-global state)"
        if "np" in names or "numpy" in names:
            return "the `np.random` global generator (process-global state)"
    if "torch" in names and fn_globals.get("torch", torch) is torch:
        reason = _torch_global_rng(codes)
        if reason is not None:
            return reason
    return None


def _torch_global_rng(codes: List[Any]) -> Optional[str]:
    """``torch.<draw>`` attribute loads against ``generator=`` keywords."""
    draws = generators = 0
    for c in codes:
        prev = None
        for ins in dis.get_instructions(c):
            if (
                prev is not None
                and prev.opname in ("LOAD_GLOBAL", "LOAD_NAME", "LOAD_FAST", "LOAD_DEREF")
                and prev.argval == "torch"
                and ins.opname in ("LOAD_ATTR", "LOAD_METHOD")
            ):
                if ins.argval == "manual_seed":
                    return "`torch.manual_seed` (the global generator's state)"
                if ins.argval in _TORCH_GLOBAL_RNG:
                    draws += 1
            if isinstance(ins.argval, tuple) and "generator" in ins.argval:
                generators += 1
            prev = ins
    if draws > generators:
        return "torch's global generator (process-global state)"
    return None
