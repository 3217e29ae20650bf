"""The diagnostics vocabulary shared by static analysis and lowering.

A ``Diagnostic`` is one finding about a ``FlowSpec``: which rule fired, how
bad it is, which node/edge it anchors to, and — always — a fix hint.  The
same vocabulary is used by

  * the static pass (``repro_torch.flow.analysis.analyze`` / ``FlowSpec.check()``),
    which inspects the graph before anything is constructed, and
  * the lowering fallbacks in ``repro_torch.flow.compile`` (``CompiledFlow
    .diagnostics``), which previously degraded semantics behind warn-once
    ``logger.warning`` calls.

Severity policy (documented in ``docs/flowcheck.md``):

  ERROR — the graph property makes the plan wrong: it cannot lower, will
          wedge, or will silently train something other than what was
          declared.  ``scripts/flowcheck.py`` and ``compile(strict=True)``
          gate on these.
  WARN  — the plan runs but with degraded or surprising behaviour
          (fallbacks, unbounded buffering, nondeterminism hazards).
  INFO  — observations that need runtime context to resolve (e.g. a
          context-built stage the static pass cannot see inside).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Severity", "Diagnostic", "FlowAnalysisError", "format_report"]


class Severity:
    """Diagnostic severity ladder (mirrors ``FailurePolicy``-style enums)."""

    ERROR = "error"
    WARN = "warn"
    INFO = "info"
    ALL = frozenset((ERROR, WARN, INFO))
    _ORDER = {ERROR: 0, WARN: 1, INFO: 2}

    @classmethod
    def validate(cls, severity: str) -> str:
        if severity not in cls.ALL:
            raise ValueError(
                f"unknown severity {severity!r}; expected one of {sorted(cls.ALL)}"
            )
        return severity

    @classmethod
    def rank(cls, severity: str) -> int:
        """Sort key: errors first."""
        return cls._ORDER[severity]

    @classmethod
    def at_least(cls, severity: str, floor: str) -> bool:
        """True if ``severity`` is as bad as ``floor`` or worse."""
        return cls._ORDER[severity] <= cls._ORDER[floor]


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, anchored to a node (and optionally an edge).

    ``rule`` is the kebab-case rule name (``credit-deadlock``); ``node`` is
    the offending node id (``n3_enqueue``) or None for whole-graph findings;
    ``edge`` is a ``(producer_node_id, port)`` ref when the finding is about
    a specific stream edge; ``hint`` says how to fix it.
    """

    rule: str
    severity: str
    message: str
    node: Optional[str] = None
    edge: Optional[Tuple[str, int]] = None
    hint: Optional[str] = None
    details: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        Severity.validate(self.severity)

    @property
    def is_error(self) -> bool:
        return self.severity == Severity.ERROR

    def format(self) -> str:
        """One human-readable block: ``severity[rule] anchor: message``."""
        anchor = self.node or "<flow>"
        if self.edge is not None:
            anchor += f" (edge {self.edge[0]}:{self.edge[1]})"
        out = f"{self.severity}[{self.rule}] {anchor}: {self.message}"
        if self.hint:
            out += f"\n  hint: {self.hint}"
        return out

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "node": self.node,
            "hint": self.hint,
        }
        if self.edge is not None:
            out["edge"] = list(self.edge)
        if self.details:
            out["details"] = dict(self.details)
        return out


class FlowAnalysisError(ValueError):
    """Raised by strict compilation when a plan carries error diagnostics.

    Carries the full diagnostic list so callers (tests, CLIs) can inspect
    which rules fired instead of parsing the message.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic], flow: str = "flow"):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        errors = [d for d in self.diagnostics if d.is_error]
        body = "\n".join(d.format() for d in self.diagnostics)
        super().__init__(
            f"flow {flow!r} failed static analysis with "
            f"{len(errors)} error(s) ({len(self.diagnostics)} total):\n{body}"
        )


def sort_diagnostics(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    """Stable order: severity first, then rule name, then node anchor."""
    return sorted(
        diags, key=lambda d: (Severity.rank(d.severity), d.rule, d.node or "")
    )


def format_report(diags: Sequence[Diagnostic], name: str = "flow") -> str:
    """The text report ``scripts/flowcheck.py`` prints per plan."""
    diags = sort_diagnostics(diags)
    if not diags:
        return f"{name}: clean (0 diagnostics)"
    counts: Dict[str, int] = {}
    for d in diags:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    summary = ", ".join(
        f"{counts[s]} {s}" for s in (Severity.ERROR, Severity.WARN, Severity.INFO)
        if s in counts
    )
    body = "\n".join("  " + d.format().replace("\n", "\n  ") for d in diags)
    return f"{name}: {summary}\n{body}"
