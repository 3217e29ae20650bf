"""Diagnostics vocabulary of the FlowSpec IR (PyTorch port).

The lowering fallbacks in ``flow/compile.py`` report through it.  The
flowcheck rule engine of ``repro/flow/analysis`` (``engine``, ``rules``,
``audit``) is not ported yet.
"""

from repro_torch.flow.analysis.diagnostics import (
    Diagnostic,
    FlowAnalysisError,
    Severity,
    format_report,
    sort_diagnostics,
)

__all__ = [
    "Diagnostic",
    "FlowAnalysisError",
    "Severity",
    "format_report",
    "sort_diagnostics",
]
