"""The analyzer engine: rule catalog + the three entry points.

* :func:`analyze_dfg` — graph-scoped families (hygiene + ranges), no
  schedule needed; what the verifier-adjacent callers use.
* :func:`analyze_plan` — plan-scoped family (stream skew) for one
  :class:`StreamingPlan`.
* :func:`analyze_design` — everything, over a ``CompiledDesign``:
  hygiene + ranges on the lowered source graph, stream skew per group
  plan, schedule hazards on the group/spill schedule.  This is what
  ``compile_design`` runs under ``CompileOptions(lint=...)``.

Each family runs under an ``analyze:<family>`` span on the ambient
tracer (``cat="analyze"``), so lint cost shows up in the same
Chrome trace as passes, DP, and DSE.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from repro_torch import instrument
from repro_torch.core.ir import DFG
from repro_torch.core.streaming import StreamingPlan

from .diagnostics import Diagnostic, Severity
from .hazards import analyze_schedule
from .hygiene import analyze_hygiene
from .ranges import DEFAULT_ACC_BITS, analyze_ranges
from .stream_skew import analyze_stream_skew


@dataclass(frozen=True)
class Rule:
    """Catalog entry: stable id, default severity, scope, one-liner."""

    id: str
    severity: Severity
    scope: str  # "dfg" | "plan" | "design"
    summary: str


#: the rule catalog — ids are stable and documented in DESIGN.md §8
RULES: dict[str, Rule] = {r.id: r for r in (
    Rule("SK1", Severity.ERROR, "plan",
         "reconvergent-branch FIFO depth cannot absorb the row-rate "
         "skew (stream deadlock)"),
    Rule("SK2", Severity.INFO, "plan",
         "reconvergent join observability: skew absorbed per skip FIFO"),
    Rule("R1", Severity.ERROR, "dfg",
         "reduction accumulator narrower than the worst-case sum "
         "(integer overflow / wrap)"),
    Rule("R2", Severity.INFO, "dfg",
         "exact result range exceeds the output stream width "
         "(requantization assumed)"),
    Rule("SH1", Severity.ERROR, "design",
         "group BRAM/DSP over-commit vs the target budget"),
    Rule("SH2", Severity.ERROR, "design",
         "spill/fill read-before-write across overlapped transitions"),
    Rule("SH3", Severity.WARNING, "design",
         "transition overlap window smaller than one DRAM burst "
         "(degenerates to serial DMA)"),
    Rule("H1", Severity.WARNING, "dfg", "unused imported constant"),
    Rule("H2", Severity.WARNING, "dfg",
         "dtype-inconsistent fused epilogue operand"),
    Rule("H3", Severity.WARNING, "dfg",
         "dead output (unconsumed, not a graph output)"),
    Rule("H4", Severity.WARNING, "dfg",
         "narrowing stream edge without explicit requantization"),
)}


def analyze_dfg(
    dfg: DFG, *, acc_bits: Union[int, str] = DEFAULT_ACC_BITS
) -> list[Diagnostic]:
    """Graph-scoped diagnostics: hygiene lints + integer range analysis."""
    tracer = instrument.current()
    diags: list[Diagnostic] = []
    with tracer.span(f"analyze:hygiene:{dfg.name}", cat="analyze"):
        diags += analyze_hygiene(dfg)
    with tracer.span(f"analyze:ranges:{dfg.name}", cat="analyze"):
        diags += analyze_ranges(dfg, acc_bits=acc_bits)
    return diags


def analyze_plan(
    plan: StreamingPlan, *, group: Optional[str] = None
) -> list[Diagnostic]:
    """Plan-scoped diagnostics: stream-skew / deadlock analysis."""
    tracer = instrument.current()
    with tracer.span(f"analyze:skew:{plan.dfg.name}", cat="analyze"):
        return analyze_stream_skew(plan, group=group)


def analyze_design(
    design, *, acc_bits: Union[int, str] = DEFAULT_ACC_BITS
) -> list[Diagnostic]:
    """All four families over a ``CompiledDesign``."""
    tracer = instrument.current()
    with tracer.span(f"analyze:{design.source.name}", cat="analyze") as args:
        diags = analyze_dfg(design.source, acc_bits=acc_bits)
        for g in design.groups:
            diags += analyze_plan(g.plan, group=g.name)
        with tracer.span(
            f"analyze:hazards:{design.source.name}", cat="analyze"
        ):
            diags += analyze_schedule(design)
        args["diagnostics"] = len(diags)
        args["errors"] = sum(
            1 for d in diags if d.severity is Severity.ERROR
        )
    return diags
