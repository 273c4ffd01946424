"""Layout canonicalization: NCHW↔NHWC transpose motion and cancellation.

ONNX models arrive in NCHW; the streaming conv/pool kernels (and every
builder graph) are NHWC.  The importer (``repro_torch.frontends.onnx_reader``)
keeps each imported op *faithful* to its ONNX semantics by sandwiching
every layout-sensitive node between explicit transposes::

    x(NCHW) → T(→NHWC) → conv → T(→NCHW) → relu → T(→NHWC) → conv → …

which is correct but buffers a full feature map at every arrow.  This
pass cancels the interior pairs so only the graph-boundary transposes
(the external NCHW contract) survive:

* **compose/cancel** — a transpose fed by a transpose composes into one
  (identity compositions rewire the consumer straight through);
* **sink elementwise** — a unary elementwise op fed by a transpose is
  layout-agnostic: it commutes below the transpose so the transpose can
  meet (and cancel against) the next layer's inverse.  Binary
  elementwise ops (residual adds) sink when *both* operands come off
  transposes with the same permutation;
* **fold into flatten** — a transpose feeding a flatten disappears into
  the flatten's linearization order (the mixed-radix output map absorbs
  the permutation), so NCHW classifier heads cost no reorder buffer.

Every rewrite preserves per-element semantics exactly (the verifier's
V10 invariant is checked after each pass application by PassManager);
``tests/test_layout.py`` pins bit-exactness against the unrewritten
graph on random inputs.  Ops with epilogues are never touched — this
pass runs *before* fusion in the default pipeline, so that never fires
in practice.
"""
from __future__ import annotations

from repro_torch.core.analysis import reorder_spec
from repro_torch.core.ir import (
    DFG,
    GenericOp,
    Value,
    make_flatten_op,
    make_transpose_op,
)

from .base import Pass


def _as_transpose(dfg: DFG, value_name: str) -> tuple[GenericOp, tuple[int, ...]] | None:
    """(producer node, perm) when ``value_name`` is a transpose output."""
    prod = dfg.producer_of(value_name)
    if prod is None or prod.epilogue:
        return None
    spec = reorder_spec(prod)
    if spec is None or spec[0] != "transpose":
        return None
    return prod, spec[1]


def _sole_interior_consumer(dfg: DFG, value_name: str, consumer: GenericOp) -> bool:
    """True when ``consumer`` is the only reader and the value never
    escapes through the graph boundary — the condition for repurposing
    its producer in place."""
    if value_name in dfg.graph_outputs or value_name in dfg.graph_inputs:
        return False
    cons = dfg.consumers_of(value_name)
    if len(cons) != 1 or cons[0] is not consumer:
        return False
    if any(
        any(e.operand == value_name for e in n.epilogue) for n in dfg.nodes
    ):
        return False
    return True


class LayoutCanonicalize(Pass):
    """Cancel interior layout transposes (see module docstring)."""

    name = "layout"

    def run_on(self, dfg: DFG) -> dict[str, int]:
        stats = {
            "transposes_composed": 0,
            "transposes_cancelled": 0,
            "elementwise_sunk": 0,
            "flatten_folds": 0,
        }
        # one rewrite per iteration; every rewrite either removes a
        # node or moves a transpose strictly downward, so a generous
        # size-proportional cap is only a runaway backstop — hitting it
        # would leave interior transposes (full-tensor reorder buffers)
        # behind, so it warns instead of failing silently
        limit = 50 * max(len(dfg.nodes), 1)
        for i in range(limit + 1):
            changed = (
                self._compose_or_cancel(dfg, stats)
                or self._sink_elementwise(dfg, stats)
                or self._fold_into_flatten(dfg, stats)
            )
            if not changed:
                break
            self._drop_dead_reorders(dfg)
        else:  # pragma: no cover - backstop, not a reachable rewrite path
            import warnings

            warnings.warn(
                f"{dfg.name}: layout canonicalization stopped after "
                f"{limit} rewrites without reaching a fixpoint — "
                "interior transposes may remain (full-tensor reorder "
                "buffers)",
                RuntimeWarning,
                stacklevel=2,
            )
        return stats

    @staticmethod
    def _drop_dead_reorders(dfg: DFG) -> None:
        """Remove reorder nodes whose output nothing reads (rewrites
        strand them); full DCE is a separate pass, but leaving a chain
        of dead transposes here would block further composition."""
        changed = True
        while changed:
            changed = False
            for node in list(dfg.nodes):
                if reorder_spec(node) is None:
                    continue
                out = node.output
                if out in dfg.graph_outputs or dfg.consumers_of(out):
                    continue
                if any(
                    any(e.operand == out for e in n.epilogue)
                    for n in dfg.nodes
                ):
                    continue
                dfg.remove_node(node.name)
                if out in dfg.values and out not in dfg.referenced_values():
                    del dfg.values[out]
                changed = True

    # -- rule 1: transpose(transpose(x)) -------------------------------------

    def _compose_or_cancel(self, dfg: DFG, stats: dict[str, int]) -> bool:
        for node in list(dfg.nodes):
            spec = reorder_spec(node)
            if spec is None or spec[0] != "transpose" or node.epilogue:
                continue
            upstream = _as_transpose(dfg, node.inputs[0])
            if upstream is None:
                continue
            t1, p1 = upstream
            p2 = spec[1]
            composed = tuple(p1[i] for i in p2)
            src = t1.inputs[0]
            if composed == tuple(range(len(composed))):
                # a graph-input → graph-output round trip has nothing to
                # rewire into: cancelling would alias the output to the
                # input (and can empty the graph entirely, which the
                # emitter rejects) — same passthrough rule as
                # canonicalize's identity removal
                if (node.output in dfg.graph_outputs
                        and src in dfg.graph_inputs):
                    continue
                # identity round trip: consumers of node.output read the
                # pre-transpose value directly
                out = node.output
                dfg.remove_node(node.name)
                dfg.replace_value_uses(out, src)
                if out in dfg.values and out not in dfg.referenced_values():
                    del dfg.values[out]
                stats["transposes_cancelled"] += 1
            else:
                replacement = make_transpose_op(
                    node.name, src, node.output,
                    in_shape=dfg.values[src].shape, perm=composed,
                    elem_bits=node.elem_bits,
                )
                dfg.nodes[dfg.nodes.index(node)] = replacement
                stats["transposes_composed"] += 1
            return True
        return False

    # -- rule 2/3: elementwise ops commute below transposes ------------------

    def _sink_elementwise(self, dfg: DFG, stats: dict[str, int]) -> bool:
        for node in list(dfg.nodes):
            if node.epilogue or reorder_spec(node) is not None:
                continue
            if not all(m.is_identity() for m in node.indexing_maps):
                continue
            if len(node.inputs) == 1:
                hit = self._sink_unary(dfg, node)
            elif len(node.inputs) == 2:
                hit = self._sink_binary(dfg, node)
            else:
                hit = False
            if hit:
                stats["elementwise_sunk"] += 1
                return True
        return False

    def _retarget(self, dfg: DFG, node: GenericOp, new_inputs: tuple[str, ...],
                  transpose: GenericOp) -> None:
        """Move ``node`` above ``transpose``: the elementwise op now
        computes on the pre-transpose layout into a fresh ``mid`` value,
        and the transpose maps ``mid`` onto the op's original output."""
        src_shape = dfg.values[new_inputs[0]].shape
        mid = f"{node.name}_pre_{transpose.name}"
        if mid in dfg.values:  # paranoid: keep names unique
            i = 0
            while f"{mid}_{i}" in dfg.values:
                i += 1
            mid = f"{mid}_{i}"
        dfg.add_value(Value(mid, src_shape, node.elem_bits))
        old_outs = [transpose.output] + list(node.inputs)
        node.inputs = new_inputs
        node.dim_sizes = src_shape
        out = node.output
        node.output = mid
        transpose.inputs = (mid,)
        transpose.output = out
        for v in old_outs:
            if v in dfg.values and v not in dfg.referenced_values():
                del dfg.values[v]

    def _sink_unary(self, dfg: DFG, node: GenericOp) -> bool:
        upstream = _as_transpose(dfg, node.inputs[0])
        if upstream is None:
            return False
        t, _ = upstream
        if not _sole_interior_consumer(dfg, t.output, node):
            return False
        self._retarget(dfg, node, (t.inputs[0],), t)
        return True

    def _sink_binary(self, dfg: DFG, node: GenericOp) -> bool:
        a, b = node.inputs
        ta = _as_transpose(dfg, a)
        tb = _as_transpose(dfg, b)
        if ta is None or tb is None or ta[1] != tb[1]:
            return False
        (t1, _), (t2, _) = ta, tb
        if t1 is t2:
            # add(t_out, t_out): one transpose feeds both operands
            if not _sole_interior_consumer(dfg, t1.output, node):
                return False
            self._retarget(dfg, node, (t1.inputs[0], t1.inputs[0]), t1)
            return True
        if not (
            _sole_interior_consumer(dfg, t1.output, node)
            and _sole_interior_consumer(dfg, t2.output, node)
        ):
            return False
        self._retarget(dfg, node, (t1.inputs[0], t2.inputs[0]), t1)
        # t2 is now dead: nothing reads its output
        dfg.remove_node(t2.name)
        if t2.output in dfg.values and t2.output not in dfg.referenced_values():
            del dfg.values[t2.output]
        return True

    # -- rule 4: transpose → flatten folds into the linearization ------------

    def _fold_into_flatten(self, dfg: DFG, stats: dict[str, int]) -> bool:
        for node in list(dfg.nodes):
            spec = reorder_spec(node)
            if spec is None or spec[0] != "flatten" or node.epilogue:
                continue
            upstream = _as_transpose(dfg, node.inputs[0])
            if upstream is None:
                continue
            t, perm = upstream
            if perm[0] != 0:
                continue  # batch axis must survive the fold
            if not _sole_interior_consumer(dfg, t.output, node):
                continue
            order = spec[1]
            # flatten axis j of transpose(x, perm) is axis perm[j] of x
            new_order = tuple(perm[j] for j in order)
            src = t.inputs[0]
            replacement = make_flatten_op(
                node.name, src, node.output,
                in_shape=dfg.values[src].shape, order=new_order,
                elem_bits=node.elem_bits,
            )
            dfg.nodes[dfg.nodes.index(node)] = replacement
            if t.output in dfg.values and t.output not in dfg.referenced_values():
                dfg.remove_node(t.name)
                del dfg.values[t.output]
            stats["flatten_folds"] += 1
            return True
        return False
