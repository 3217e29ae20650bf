"""The analysis engine: a read-only graph view, a rule registry, ``analyze``
(PyTorch port of ``repro/flow/analysis/engine.py``, the same code).

``analyze(spec)`` builds one ``GraphView`` (forward adjacency, resource
links, pool introspection — everything rules keep re-deriving) and runs every
registered ``Rule`` over it.  Rules are pure functions ``view -> iterable of
Diagnostic``; a rule that crashes is itself reported as an ``error``
diagnostic (``analyzer-internal``) instead of taking the pass down — the
analyzer must never be the thing that breaks a build.

Registering a rule (see ``docs/flowcheck.md`` for the full how-to)::

    from repro_torch.flow.analysis.engine import rule
    from repro_torch.flow.analysis.diagnostics import Diagnostic, Severity

    @rule("my-rule", "one-line description")
    def _my_rule(view):
        for node in view.spec.nodes.values():
            if looks_wrong(node):
                yield Diagnostic("my-rule", Severity.WARN, "...", node=node.id,
                                 hint="do this instead")
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set

from repro_torch.flow.analysis.diagnostics import Diagnostic, Severity, sort_diagnostics
from repro_torch.flow.spec import FlowSpec, Node

__all__ = ["GraphView", "Rule", "RULES", "rule", "analyze"]

# Node kinds that own an actor pool (sources; ``compile()`` lowers failure
# annotations onto exactly these).
SOURCE_KINDS = frozenset(("rollouts", "replay", "par_gradients", "par_source"))

# Node kinds whose lowering consumes a ``credits`` bound.
CREDIT_KINDS = frozenset(("gather_async", "rollouts", "replay"))


class GraphView:
    """Read-only derived state over one ``FlowSpec`` shared by all rules."""

    def __init__(self, spec: FlowSpec):
        self.spec = spec
        # Forward stream adjacency: producer node id -> consumer node ids.
        self.consumers: Dict[str, List[str]] = {nid: [] for nid in spec.nodes}
        for node in spec.nodes.values():
            for src, _port in node.inputs:
                if src in self.consumers:
                    self.consumers[src].append(node.id)
        # Resource links (the dotted edges in ``to_dot``).
        self.enqueues: Dict[str, List[Node]] = {}
        self.dequeues: Dict[str, List[Node]] = {}
        for node in spec.nodes.values():
            if node.kind == "enqueue":
                self.enqueues.setdefault(node.params["resource"], []).append(node)
            elif node.kind == "dequeue":
                self.dequeues.setdefault(node.params["resource"], []).append(node)

    # ------------------------------------------------------------ traversal
    def downstream(self, node_id: str) -> Iterator[Node]:
        """Transitive stream-edge successors of ``node_id`` (excl. itself)."""
        seen: Set[str] = set()
        stack = list(self.consumers.get(node_id, ()))
        while stack:
            nid = stack.pop()
            if nid in seen:
                continue
            seen.add(nid)
            yield self.spec.nodes[nid]
            stack.extend(self.consumers.get(nid, ()))

    def upstream(self, node_id: str) -> Iterator[Node]:
        """Transitive stream-edge predecessors of ``node_id`` (excl. itself)."""
        seen: Set[str] = set()
        stack = [src for src, _ in self.spec.nodes[node_id].inputs]
        while stack:
            nid = stack.pop()
            if nid in seen or nid not in self.spec.nodes:
                continue
            seen.add(nid)
            yield self.spec.nodes[nid]
            stack.extend(src for src, _ in self.spec.nodes[nid].inputs)

    def union_of(self, node_id: str) -> Optional[Node]:
        """The first ``concurrently`` node the branch of ``node_id`` feeds."""
        for node in self.downstream(node_id):
            if node.kind == "concurrently":
                return node
        return None

    # -------------------------------------------------------- introspection
    @staticmethod
    def node_pool(node: Node) -> Any:
        """The worker group / actor pool a source node is built over."""
        p = node.params
        return p.get("workers") or p.get("actors") or p.get("pool")

    @classmethod
    def pool_actors(cls, node: Node) -> List[Any]:
        """Remote actors behind a source node ([] when not introspectable)."""
        pool = cls.node_pool(node)
        if pool is None:
            return []
        try:
            if hasattr(pool, "remote_workers"):
                return list(pool.remote_workers())
            return list(pool)
        except Exception:
            return []

    @classmethod
    def shard_count(cls, node: Node) -> Optional[int]:
        actors = cls.pool_actors(node)
        return len(actors) if actors else None

    @classmethod
    def process_backed(cls, node: Node) -> List[str]:
        """Names of the node's actors living on a process backend."""
        return [
            getattr(a, "name", repr(a))
            for a in cls.pool_actors(node)
            if getattr(a, "backend_name", None) == "process"
        ]

    def source_of(self, node_id: str) -> Optional[Node]:
        """The (first) source node feeding ``node_id``'s stream, if any."""
        node = self.spec.nodes[node_id]
        if node.kind in SOURCE_KINDS:
            return node
        for up in self.upstream(node_id):
            if up.kind in SOURCE_KINDS:
                return up
        return None

    def effective_enqueue_policy(self, node: Node) -> str:
        """Mirror of the lowering precedence: annotation > policy > block."""
        policy = node.annotations.get("overflow_policy", node.params.get("policy"))
        if policy is None:
            policy = "block" if node.params.get("block", True) else "drop_newest"
        return policy

    def effective_credits(self, node: Node) -> Optional[int]:
        """Mirror of the lowering precedence: annotation > credits param."""
        return node.annotations.get("credits", node.params.get("credits"))

    def stage_fns(self, node: Node) -> List[Any]:
        """Statically visible callables of a node (ctx factories excluded)."""
        if node.kind == "for_each":
            return [s.fn for s in node.params["stages"] if not s.ctx]
        if node.kind == "filter":
            return [node.params["predicate"]]
        if node.kind == "par_source":
            return [node.params["pull_fn"]]
        return []


@dataclass(frozen=True)
class Rule:
    """One registered analysis: a name, a description, and a check."""

    name: str
    description: str
    fn: Callable[[GraphView], Iterable[Diagnostic]]


RULES: Dict[str, Rule] = {}


def rule(name: str, description: str) -> Callable:
    """Register an analysis rule under ``name`` (kebab-case)."""

    def deco(fn: Callable[[GraphView], Iterable[Diagnostic]]) -> Callable:
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name, description, fn)
        return fn

    return deco


def analyze(
    spec: FlowSpec, rules: Optional[Sequence[str]] = None
) -> List[Diagnostic]:
    """Run the rule set over ``spec`` and return sorted diagnostics.

    ``rules`` restricts the pass to a subset of rule names (default: all
    registered).  Never raises on account of the spec: structural breakage
    surfaces as ``graph-structure`` errors, and a crashing rule surfaces as
    an ``analyzer-internal`` error naming the rule.
    """
    # Importing for side effect: the built-in rules register on first use.
    from repro_torch.flow.analysis import rules as _builtin  # noqa: F401

    view = GraphView(spec)
    selected = (
        [RULES[r] for r in rules] if rules is not None else list(RULES.values())
    )
    out: List[Diagnostic] = []
    for r in selected:
        try:
            out.extend(r.fn(view))
        except Exception as exc:
            out.append(
                Diagnostic(
                    rule="analyzer-internal",
                    severity=Severity.ERROR,
                    message=f"rule {r.name!r} crashed: {exc!r}",
                    hint="this is an analyzer bug; file it with the spec that "
                    "triggered it",
                )
            )
    return sort_diagnostics(out)
