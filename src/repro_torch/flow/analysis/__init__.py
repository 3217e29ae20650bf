"""repro_torch.flow.analysis: static analysis over the FlowSpec IR
(flowcheck; PyTorch port of ``repro/flow/analysis``).

Misconfigurations (credit deadlocks, unbounded queues, annotations that
cannot lower) are graph properties, detectable before a single actor
spawns.  This package is the rule-based pass that detects them:

    from repro_torch.flow.analysis import analyze
    diags = analyze(spec)              # or spec.check()
    spec.compile(strict=True)          # raise FlowAnalysisError on errors

Layout: ``diagnostics`` (the Diagnostic/Severity vocabulary, shared with
the lowering fallbacks in ``flow/compile.py``), ``engine`` (GraphView +
rule registry + ``analyze``), ``rules`` (the built-in rule set), ``audit``
(the all-committed-plans sweep).
"""

from repro_torch.flow.analysis.audit import audit_plans, build_plan_specs
from repro_torch.flow.analysis.diagnostics import (
    Diagnostic,
    FlowAnalysisError,
    Severity,
    format_report,
    sort_diagnostics,
)
from repro_torch.flow.analysis.engine import RULES, GraphView, Rule, analyze, rule

__all__ = [
    "Diagnostic",
    "FlowAnalysisError",
    "GraphView",
    "RULES",
    "Rule",
    "Severity",
    "analyze",
    "audit_plans",
    "build_plan_specs",
    "format_report",
    "rule",
    "sort_diagnostics",
]
