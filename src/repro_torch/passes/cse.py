"""Common-subexpression elimination across branches.

Two nodes compute the same value when they agree on *everything but
their names*: operand ids (inputs in order), indexing maps, iterator
types, dim sizes, payload, element width, and epilogue chain.  All of
those are hashable by construction (frozen dataclasses / tuples), so the
pass is a single dictionary sweep in topological order: the first node
with a given key is kept, later duplicates are removed and their uses
rewired to the keeper's output.

Sweeps repeat to a fixpoint so chains of duplicates collapse (deduping
two convs makes their downstream ReLUs textually identical, which the
next sweep catches).  A duplicate whose output is a graph output is left
alone — rewiring it would alias two external buffers to one value.

Semantics are verified bit-exactly through ``repro_torch.passes.interp``
(tests/test_passes.py): the deduped graph must compute what the original
did.
"""
from __future__ import annotations

from repro_torch.core.ir import DFG, GenericOp

from .base import Pass


def _node_key(node: GenericOp):
    """Everything that determines the node's value, minus its identity."""
    return (
        node.inputs,
        node.indexing_maps,
        node.iterator_types,
        node.dim_sizes,
        node.payload,
        node.elem_bits,
        node.epilogue,
    )


class CommonSubexprElimination(Pass):
    name = "cse"

    def run_on(self, dfg: DFG) -> dict[str, int]:
        removed = 0
        changed = True
        while changed:
            changed = False
            seen: dict[tuple, GenericOp] = {}
            for node in dfg.topo_order():
                key = _node_key(node)
                keep = seen.get(key)
                if keep is None:
                    seen[key] = node
                    continue
                if node.output in dfg.graph_outputs:
                    continue
                dfg.remove_node(node.name)
                dfg.replace_value_uses(node.output, keep.output)
                if node.output not in dfg.referenced_values():
                    del dfg.values[node.output]
                removed += 1
                changed = True
        return {"subexprs_eliminated": removed}
