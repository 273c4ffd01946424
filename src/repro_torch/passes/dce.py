"""Dead-node / dead-value elimination.

A node is dead when its output transitively feeds no graph output; a
value is dead when nothing references it (no node input/output/epilogue
operand, not a graph input/output).  On the FPGA a dead node is a whole
process function plus its FIFOs; eliminating it before the streaming
transform keeps them out of the BRAM/DSP ledger entirely.
"""
from __future__ import annotations

from repro_torch.core.ir import DFG

from .base import Pass


class DeadCodeElimination(Pass):
    name = "dce"

    def run_on(self, dfg: DFG) -> dict[str, int]:
        nodes_removed = 0
        # liveness: fixpoint over "output feeds a live consumer or exit"
        live_values = set(dfg.graph_outputs)
        changed = True
        live_nodes: set[str] = set()
        while changed:
            changed = False
            for n in dfg.nodes:
                if n.name in live_nodes:
                    continue
                if n.output in live_values:
                    live_nodes.add(n.name)
                    live_values.update(n.inputs)
                    changed = True
        for n in [n for n in dfg.nodes if n.name not in live_nodes]:
            dfg.remove_node(n.name)
            nodes_removed += 1

        values_removed = 0
        refs = dfg.referenced_values()
        for v in [v for v in dfg.values if v not in refs]:
            del dfg.values[v]
            values_removed += 1
        return {"nodes_removed": nodes_removed, "values_removed": values_removed}
