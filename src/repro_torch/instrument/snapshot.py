"""Structural DFG snapshots + diffs — our ``-print-ir-after-all``.

A snapshot is a plain-dict summary of a DFG's structure: nodes (payload,
operands, epilogue, dims) and values (shape, bits, constness).  It is
deliberately *structural*, not textual: two snapshots diff in O(nodes)
and the diff names exactly what a pass did — nodes added/removed/rewritten,
values added/removed — which is what you want attached to a per-pass
trace event (the full textual IR is available via :func:`format_dfg`
when a tracer asks for ``ir_snapshots``).
"""
from __future__ import annotations

from typing import Mapping


def snapshot_dfg(dfg) -> dict:
    """Structural summary of a :class:`repro_torch.core.ir.DFG` (plain data,
    JSON-serializable, cheap to diff)."""
    return {
        "name": dfg.name,
        "inputs": list(dfg.graph_inputs),
        "outputs": list(dfg.graph_outputs),
        "nodes": {
            op.name: {
                "payload": op.payload.value,
                "inputs": list(op.inputs),
                "output": op.output,
                "dims": list(op.dim_sizes),
                "epilogue": [e.kind.value for e in op.epilogue],
            }
            for op in dfg.nodes
        },
        "values": {
            name: {
                "shape": list(v.shape),
                "bits": v.elem_bits,
                "const": bool(v.is_constant),
            }
            for name, v in dfg.values.items()
        },
    }


def diff_snapshots(before: Mapping, after: Mapping) -> dict:
    """What changed between two snapshots, by name.

    ``changed`` means a node kept its name but its structure (operands,
    payload, epilogue, dims) was rewritten — fusion folding an
    activation into a conv shows up here."""
    b_nodes, a_nodes = before["nodes"], after["nodes"]
    b_vals, a_vals = before["values"], after["values"]
    return {
        "nodes_added": sorted(set(a_nodes) - set(b_nodes)),
        "nodes_removed": sorted(set(b_nodes) - set(a_nodes)),
        "nodes_changed": sorted(
            n for n in set(a_nodes) & set(b_nodes)
            if a_nodes[n] != b_nodes[n]
        ),
        "values_added": sorted(set(a_vals) - set(b_vals)),
        "values_removed": sorted(set(b_vals) - set(a_vals)),
    }


def diff_is_empty(diff: Mapping) -> bool:
    return not any(diff.values())


def format_dfg(dfg) -> str:
    """Human-readable IR dump (one line per node, topological order) —
    the payload of an ``ir_after`` event when full snapshots are on."""
    lines = [f"dfg @{dfg.name} "
             f"inputs={list(dfg.graph_inputs)} "
             f"outputs={list(dfg.graph_outputs)}"]
    for op in dfg.topo_order():
        epi = "".join(
            f" +{e.kind.value}" for e in op.epilogue
        )
        shape = tuple(dfg.values[op.output].shape)
        lines.append(
            f"  {op.output}:{shape} = {op.payload.value}"
            f"({', '.join(op.inputs)}) dims={list(op.dim_sizes)}{epi}"
        )
    return "\n".join(lines)
