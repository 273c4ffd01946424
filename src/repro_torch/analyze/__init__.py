"""Compile-time dataflow analyzer.

A rule-registry diagnostics engine over the three IR levels the
compiler already produces — the DFG, the :class:`StreamingPlan`, and
the :class:`CompiledDesign` schedule — with four analysis families:

* **stream skew / deadlock** (``SK*``, :mod:`~repro_torch.analyze.stream_skew`)
  — reconvergent-branch FIFO depths vs the row-rate skew derived from
  the line-buffer geometry;
* **integer ranges** (``R*``, :mod:`~repro_torch.analyze.ranges`) — interval
  propagation inferring the minimum accumulator width per
  conv/epilogue reduction (the int8 wrap, statically);
* **schedule hazards** (``SH*``, :mod:`~repro_torch.analyze.hazards`) —
  per-group budget over-commit and spill/fill read-before-write across
  overlapped DMA transitions;
* **model hygiene** (``H*``, :mod:`~repro_torch.analyze.hygiene`) — unused
  params, dtype-inconsistent epilogue operands, dead outputs,
  narrowing streams.

Entry points: :func:`analyze_dfg` / :func:`analyze_plan` /
:func:`analyze_design`; threaded into ``compile_design`` via
``CompileOptions(lint="warn"|"error"|"off")`` and exposed as
``python -m repro lint``.  Rule catalog + JSON schema: DESIGN.md §8.
"""
from .diagnostics import (
    Diagnostic,
    LintError,
    Severity,
    at_or_above,
    diagnostics_to_json,
    max_severity,
    severity_counts,
)
from .engine import RULES, Rule, analyze_design, analyze_dfg, analyze_plan
from .hazards import analyze_schedule
from .hygiene import analyze_hygiene
from .ranges import (
    ACC_INPUT_DTYPE,
    DEFAULT_ACC_BITS,
    Interval,
    analyze_ranges,
    dtype_interval,
    overflow_safe,
    value_intervals,
)
from .stream_skew import analyze_stream_skew

__all__ = [
    "ACC_INPUT_DTYPE",
    "DEFAULT_ACC_BITS",
    "Diagnostic",
    "Interval",
    "LintError",
    "RULES",
    "Rule",
    "Severity",
    "analyze_design",
    "analyze_dfg",
    "analyze_hygiene",
    "analyze_plan",
    "analyze_ranges",
    "analyze_schedule",
    "analyze_stream_skew",
    "at_or_above",
    "diagnostics_to_json",
    "dtype_interval",
    "max_severity",
    "overflow_safe",
    "severity_counts",
    "value_intervals",
]
