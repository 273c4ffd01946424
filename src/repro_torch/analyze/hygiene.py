"""Model hygiene lints over the DFG.

Cheap structural smells that are legal (the verifier accepts them) but
almost always indicate an importer or rewrite bug:

* **H1 (WARNING)** — an imported constant (weights/bias) no node
  references: dead weight in the artifact, usually a mis-wired import.
* **H2 (WARNING)** — a fused epilogue operand whose dtype differs from
  the node's compute dtype: the bias/scale silently widens or
  truncates on the fused datapath.
* **H3 (WARNING)** — a dead output: a node's result is neither
  consumed nor a graph output.  DCE removes these; seeing one after
  the pipeline means a pass left garbage behind.
* **H4 (WARNING)** — a narrowing stream edge: a consumer computes at
  fewer bits than the stream it reads carries, truncating without an
  explicit requantization step.
"""
from __future__ import annotations

from repro_torch.core.ir import DFG

from .diagnostics import Diagnostic, Severity


def analyze_hygiene(dfg: DFG) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    graph = dfg.name
    referenced = dfg.referenced_values()

    # H1 — unused imported params
    for name, v in sorted(dfg.values.items()):
        if v.is_constant and name not in referenced:
            diags.append(Diagnostic(
                rule="H1",
                severity=Severity.WARNING,
                graph=graph,
                node=name,
                message=(
                    f"constant {name!r} ({v.num_elements} elements) is "
                    "referenced by no node"
                ),
                hint="drop it from the model, or fix the importer wiring",
            ))

    for n in dfg.nodes:
        # H2 — dtype-inconsistent epilogue operands
        for e in n.epilogue:
            if e.operand is None or e.operand not in dfg.values:
                continue
            ob = dfg.values[e.operand].elem_bits
            if ob != n.elem_bits:
                diags.append(Diagnostic(
                    rule="H2",
                    severity=Severity.WARNING,
                    graph=graph,
                    node=n.name,
                    message=(
                        f"{e.kind.value} epilogue operand {e.operand!r} "
                        f"is {ob}-bit but the node computes at "
                        f"{n.elem_bits} bits"
                    ),
                    hint=(
                        "match the operand dtype to the node or fold an "
                        "explicit cast into the epilogue"
                    ),
                ))

        # H3 — dead outputs
        if (not dfg.consumers_of(n.output)
                and n.output not in dfg.graph_outputs):
            diags.append(Diagnostic(
                rule="H3",
                severity=Severity.WARNING,
                graph=graph,
                node=n.name,
                message=(
                    f"output {n.output!r} is neither consumed nor a "
                    "graph output (dead code)"
                ),
                hint="run DCE, or mark the value as a graph output",
            ))

        # H4 — narrowing stream reads
        for vname in n.inputs:
            v = dfg.values[vname]
            if not v.is_constant and n.elem_bits < v.elem_bits:
                diags.append(Diagnostic(
                    rule="H4",
                    severity=Severity.WARNING,
                    graph=graph,
                    node=n.name,
                    message=(
                        f"consumes {v.elem_bits}-bit stream {vname!r} "
                        f"but computes at {n.elem_bits} bits — implicit "
                        "truncation"
                    ),
                    hint=(
                        "insert an explicit requantization or widen the "
                        "consumer's elem_bits"
                    ),
                ))
    return diags
