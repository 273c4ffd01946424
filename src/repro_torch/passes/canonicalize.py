"""Canonicalization: identity removal, shape propagation, ordering.

Three rewrites that keep every later pass simple:

* **identity elimination** — ``IDENTITY``-payload pure-parallel ops with
  an empty epilogue are wires; uses of their output are rewired to their
  input and the node is dropped.
* **constant-shape propagation** — each produced Value's shape is
  recomputed from its producer's output map (loop extents are the
  static source of truth); stale shapes from hand-built or rewritten
  graphs are overwritten so the verifier's V8 invariant holds.
* **deterministic node ordering** — ``dfg.nodes`` is rewritten into
  topological order with lexicographic tie-break, so pass pipelines,
  emission, and golden files are reproducible regardless of builder
  insertion order.
"""
from __future__ import annotations

from repro_torch.core.analysis import KernelClass, classify_kernel
from repro_torch.core.ir import DFG, GenericOp

from .base import Pass


def _inferred_output_shape(op: GenericOp) -> tuple[int, ...] | None:
    """Output extents when every output-map result is a single dim
    (shrunk by any fused pooling epilogue — the value the op produces)."""
    omap = op.output_map
    if not all(e.is_single_dim() for e in omap.results):
        return None
    extents = tuple(op.dim_extent(e.terms[0][0]) for e in omap.results)
    return op.epilogue_shape(extents)


class Canonicalize(Pass):
    name = "canonicalize"

    def run_on(self, dfg: DFG) -> dict[str, int]:
        identities_removed = self._remove_identities(dfg)
        shapes_fixed = self._propagate_shapes(dfg)
        reordered = self._sort_nodes(dfg)
        return {
            "identities_removed": identities_removed,
            "shapes_fixed": shapes_fixed,
            "nodes_reordered": reordered,
        }

    # -- identity elimination ------------------------------------------------

    def _remove_identities(self, dfg: DFG) -> int:
        removed = 0
        for node in list(dfg.nodes):
            if node.payload.value != "identity" or node.epilogue:
                continue
            if len(node.inputs) != 1:
                continue
            info = classify_kernel(node)
            if info.kernel_class != KernelClass.PURE_PARALLEL:
                continue
            # a transpose/flatten is IDENTITY-payload but *moves* data —
            # only a true wire (identity maps end to end) is removable
            if not all(m.is_identity() for m in node.indexing_maps):
                continue
            src, out = node.inputs[0], node.output
            # pure pass-through from a graph input to a graph output has
            # nothing to rewire into — keep the node as the sole producer.
            if src in dfg.graph_inputs and out in dfg.graph_outputs:
                continue
            dfg.remove_node(node.name)
            dfg.replace_value_uses(out, src)
            if out in dfg.values and out not in dfg.referenced_values():
                del dfg.values[out]
            removed += 1
        return removed

    # -- constant-shape propagation ------------------------------------------

    def _propagate_shapes(self, dfg: DFG) -> int:
        fixed = 0
        for node in dfg.topo_order():
            shape = _inferred_output_shape(node)
            if shape is None:
                continue
            val = dfg.values[node.output]
            if val.shape != shape:
                val.shape = shape
                fixed += 1
        return fixed

    # -- deterministic ordering ----------------------------------------------

    def _sort_nodes(self, dfg: DFG) -> int:
        """Stable topological sort with name tie-break (Kahn's, sorted
        ready set).  Returns 1 when the order actually changed."""
        produced = set(dfg.graph_inputs) | {
            v for v, val in dfg.values.items() if val.is_constant
        }
        pending = {n.name: n for n in dfg.nodes}
        order: list[GenericOp] = []
        while pending:
            ready = sorted(
                name for name, n in pending.items()
                if all(i in produced for i in n.inputs)
            )
            if not ready:
                raise ValueError(f"{dfg.name}: cycle during canonicalization")
            for name in ready:
                node = pending.pop(name)
                order.append(node)
                produced.add(node.output)
        changed = [n.name for n in order] != [n.name for n in dfg.nodes]
        dfg.nodes = order
        return int(changed)
