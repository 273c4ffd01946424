"""Schedule hazard checks over the :class:`CompiledDesign` schedule IR.

The host schedule (``emit_host_schedule``) runs groups back-to-back,
overlapping group *k*'s spill write DMA with group *k+1*'s fill read
(the read trails the write by one DRAM burst).  That overlap is only
legal when every filled buffer was written at the same or an earlier
transition — and the whole schedule is only realizable when every
group fits the target budget.  Three rules:

* **SH1 (ERROR)** — per-group BRAM/DSP over-commit: a group's resources
  exceed the target budget (or its DSE solution is marked infeasible).
  The emitted design cannot place and route.
* **SH2 (ERROR)** — read-before-write across spill/fill transitions: a
  group fills a value that no earlier (or same-transition) group
  spilled and that is not a graph input.  The overlapped DMA would
  read garbage from an unwritten DRAM buffer.
* **SH3 (WARNING)** — a transition whose overlap window is smaller
  than one DRAM burst: ``transition_cycles`` degenerates to the serial
  write-then-read sum, so the boundary pays full price — worth knowing
  when a partition cut was chosen for overlap it cannot get.
"""
from __future__ import annotations

from repro_torch.core.resource_model import DRAM_BURST_BYTES

from .diagnostics import Diagnostic, Severity


def analyze_schedule(design) -> list[Diagnostic]:
    """Hazard diagnostics for a ``CompiledDesign``."""
    diags: list[Diagnostic] = []
    graph = design.source.name

    # SH1 — per-group budget over-commit
    for g in design.groups:
        over = []
        if g.bram > design.b_total:
            over.append(f"BRAM {g.bram}/{design.b_total}")
        if g.dsp > design.d_total:
            over.append(f"DSP {g.dsp}/{design.d_total}")
        if over or not g.dse.feasible:
            what = ", ".join(over) if over else "DSE marked infeasible"
            diags.append(Diagnostic(
                rule="SH1",
                severity=Severity.ERROR,
                graph=graph,
                group=g.name,
                message=f"group over target budget: {what}",
                hint=(
                    "partition further, enable weight_streaming, or "
                    "compile for a larger target"
                ),
            ))

    # SH2 — read-before-write across overlapped spill/fill transitions.
    # A fill at transition t may consume values spilled at transitions
    # <= t (same-transition is the designed trailing read: the emitter
    # issues dma_write_async before dma_read_async).  Graph inputs live
    # in DRAM from the start and are always readable.
    written: set[str] = set(design.source.graph_inputs)
    for t, (g, nxt) in enumerate(zip(design.groups, design.groups[1:])):
        written |= set(g.spill_out)
        for v in nxt.spill_in:
            if v not in written:
                diags.append(Diagnostic(
                    rule="SH2",
                    severity=Severity.ERROR,
                    graph=graph,
                    group=nxt.name,
                    node=v,
                    message=(
                        f"fill of {v!r} at transition {t} precedes its "
                        "spill — the overlapped DMA reads an unwritten "
                        "DRAM buffer"
                    ),
                    hint=(
                        "the producing group must run (and spill) no "
                        "later than the transition that fills the value"
                    ),
                ))

    # SH3 — degenerate overlap window at a transition
    for t, (w, r) in enumerate(design.boundary_traffic()):
        if w > 0 and r > 0 and min(w, r) < DRAM_BURST_BYTES:
            g, nxt = design.groups[t], design.groups[t + 1]
            diags.append(Diagnostic(
                rule="SH3",
                severity=Severity.WARNING,
                graph=graph,
                group=g.name,
                message=(
                    f"transition {g.name} -> {nxt.name} moves "
                    f"{min(w, r)} bytes on its smaller side — less than "
                    f"one DRAM burst ({DRAM_BURST_BYTES} B), so the "
                    "spill/fill overlap degenerates to the serial sum"
                ),
                hint=(
                    "a different cut point (or keeping the slice whole "
                    "with streamed weights) avoids the exposed boundary"
                ),
            ))
    return diags
