"""Structural DFG verifier — the pass pipeline's safety net.

MLIR runs its verifier between passes so a broken rewrite is caught at
the pass that produced it, not three passes later in a backend crash.
We mirror that: :class:`~repro_torch.passes.base.PassManager` calls
:func:`verify_dfg` after every pass and raises
:class:`VerificationError` naming the offending pass.

Checks (all structural — payload semantics are the interpreter's job):

  V1. unique node names; every node input/output/epilogue operand is a
      registered value;
  V2. single static assignment: at most one producer per value;
  V3. graph inputs are not produced by nodes; graph outputs are produced
      by a node or are graph inputs (pass-through);
  V4. the graph is acyclic (Kahn's algorithm completes);
  V5. op arity: |indexing_maps| == |inputs|+1, every map matches n_dims,
      |dim_sizes| == |iterator_types|;
  V6. epilogue operands are constant values (fusion may only fold
      on-chip constants, never streams);
  V7. every non-constant node input is a graph input or has a producer;
  V8. output shape agreement: when every output-map result is a single
      dim, the produced Value's shape equals the mapped extents — shrunk
      by any fused pooling epilogue (the canonicalizer's shape
      propagation maintains this invariant);
  V9. pooling epilogues are well-formed: window rank matches the output
      rank and every factor tiles its axis exactly.
  V10. data-movement (reorder) ops preserve elements: an IDENTITY
      pure-parallel op with non-identity maps must be a recognizable
      transpose/flatten (``repro_torch.core.analysis.reorder_spec``), carry no
      epilogue, and produce a value with exactly the input's element
      count and the shape its maps imply — the layout pass's rewrites
      are checked against this after every application.

Two reporting modes.  The default (the PassManager's mode) is
fail-fast: the first violated invariant raises, naming the rule —
``lenet5: [V2] value x produced by both a and b``.  With
``collect_all=True`` every rule still runs after a violation and the
single raised :class:`VerificationError` lists them all (one ``[Vk]``
line each, also on ``.violations``) — the mode ``python -m repro lint``
and hand-written graph debugging want, where the second and third
breakages are usually more informative than the first.
"""
from __future__ import annotations

from repro_torch.core.analysis import reorder_spec
from repro_torch.core.ir import DFG, IteratorType, PayloadKind


class VerificationError(ValueError):
    """A rewrite left the DFG structurally malformed.

    ``violations`` holds one ``[Vk] message`` string per violated
    invariant — a single entry in fail-fast mode, every violation found
    when ``verify_dfg(..., collect_all=True)`` raised.
    """

    def __init__(self, message: str, violations: tuple = ()):
        super().__init__(message)
        self.violations = tuple(violations)


def _check_names(dfg: DFG, fail) -> None:
    # V1 — names and registration
    seen_nodes: set[str] = set()
    for n in dfg.nodes:
        if n.name in seen_nodes:
            fail("V1", f"duplicate node name {n.name}")
        seen_nodes.add(n.name)
        for v in n.inputs + (n.output,):
            if v not in dfg.values:
                fail("V1", f"{n.name}: unregistered value {v}")
        for e in n.epilogue:
            if e.operand is not None and e.operand not in dfg.values:
                fail("V1", f"{n.name}: unregistered epilogue operand {e.operand}")


def _check_ssa(dfg: DFG, fail) -> None:
    # V2 — single producer per value
    producers: dict[str, str] = {}
    for n in dfg.nodes:
        if n.output in producers:
            fail("V2", f"value {n.output} produced by both "
                       f"{producers[n.output]} and {n.name}")
        producers[n.output] = n.name


def _check_boundary(dfg: DFG, fail) -> None:
    # V3 — graph boundary
    producers = {n.output: n.name for n in dfg.nodes}
    for gi in dfg.graph_inputs:
        if gi not in dfg.values:
            fail("V3", f"graph input {gi} not registered")
        if gi in producers:
            fail("V3", f"graph input {gi} is produced by {producers[gi]}")
    for go in dfg.graph_outputs:
        if go not in dfg.values:
            fail("V3", f"graph output {go} not registered")
        if go not in producers and go not in dfg.graph_inputs:
            fail("V3", f"graph output {go} has no producer")


def _check_acyclic(dfg: DFG, fail) -> None:
    # V4 — acyclicity
    try:
        dfg.topo_order()
    except ValueError as e:
        fail("V4", str(e))


def _check_arity(dfg: DFG, fail) -> None:
    # V5 — op arity (rewrites mutate past __post_init__)
    for n in dfg.nodes:
        if len(n.indexing_maps) != len(n.inputs) + 1:
            fail("V5", f"{n.name}: {len(n.indexing_maps)} maps for "
                       f"{len(n.inputs)} inputs")
        if len(n.dim_sizes) != len(n.iterator_types):
            fail("V5", f"{n.name}: dim_sizes/iterator_types mismatch")
        for m in n.indexing_maps:
            if m.n_dims != n.n_dims:
                fail("V5", f"{n.name}: map arity {m.n_dims} != {n.n_dims}")


def _check_epilogue_consts(dfg: DFG, fail) -> None:
    # V6 — epilogue operands are constants
    for n in dfg.nodes:
        for e in n.epilogue:
            if e.operand is not None and not dfg.values[e.operand].is_constant:
                fail("V6", f"{n.name}: epilogue operand {e.operand} "
                           "is not a constant")


def _check_fed(dfg: DFG, fail) -> None:
    # V7 — every non-constant input is fed
    feedable = set(dfg.graph_inputs) | {n.output for n in dfg.nodes}
    for n in dfg.nodes:
        for v in n.inputs:
            if not dfg.values[v].is_constant and v not in feedable:
                fail("V7", f"{n.name}: input {v} has no producer and "
                           "is not a graph input")


def _check_shapes(dfg: DFG, fail) -> None:
    # V8 — output shape agreement (single-dim output maps only); a fused
    # pooling epilogue shrinks the mapped extents before the comparison
    for n in dfg.nodes:
        omap = n.output_map
        if not all(e.is_single_dim() for e in omap.results):
            continue
        extents = tuple(n.dim_extent(e.terms[0][0]) for e in omap.results)
        extents = n.epilogue_shape(extents)
        shape = dfg.values[n.output].shape
        if shape != extents:
            fail("V8", f"{n.name}: output {n.output} shape {shape} != "
                       f"mapped extents {extents}")


def _check_pool_windows(dfg: DFG, fail) -> None:
    # V9 — pooling epilogues divide their axes exactly (window factors
    # must tile the pre-pool extents; checked against the mapped shape)
    for n in dfg.nodes:
        omap = n.output_map
        if not all(e.is_single_dim() for e in omap.results):
            continue
        shape = tuple(n.dim_extent(e.terms[0][0]) for e in omap.results)
        for e in n.epilogue:
            if not e.window:
                continue
            if len(e.window) != len(shape):
                fail("V9", f"{n.name}: pool window rank {len(e.window)} "
                           f"!= output rank {len(shape)}")
                continue
            if any(s % f for s, f in zip(shape, e.window)):
                fail("V9", f"{n.name}: pool window {e.window} does not "
                           f"tile output extents {shape}")
            shape = tuple(s // f for s, f in zip(shape, e.window))


def _check_reorders(dfg: DFG, fail) -> None:
    # V10 — reorder ops are well-formed element-preserving moves
    for n in dfg.nodes:
        if (
            n.payload != PayloadKind.IDENTITY
            or len(n.inputs) != 1
            or any(t != IteratorType.PARALLEL for t in n.iterator_types)
        ):
            continue
        imap, omap = n.indexing_maps
        if imap.is_identity() and omap.is_identity():
            continue  # plain wire — canonicalize removes it
        spec = reorder_spec(n)
        if spec is None:
            fail("V10", f"{n.name}: IDENTITY op with non-identity "
                        "maps is not a recognizable transpose/flatten")
            continue
        if n.epilogue:
            fail("V10", f"{n.name}: reorder ops cannot carry epilogues")
        in_v, out_v = dfg.values[n.inputs[0]], dfg.values[n.output]
        if in_v.num_elements != out_v.num_elements:
            fail("V10", f"{n.name}: reorder changes element count "
                        f"({in_v.shape} -> {out_v.shape})")
        kind, arg = spec
        if kind == "transpose":
            want = tuple(in_v.shape[p] for p in arg)
        else:
            feat = 1
            for s in in_v.shape[1:]:
                feat *= s
            want = (in_v.shape[0], feat)
        if out_v.shape != want:
            fail("V10", f"{n.name}: {kind} output shape "
                        f"{out_v.shape} != expected {want}")


_CHECKS = (
    _check_names,
    _check_ssa,
    _check_boundary,
    _check_acyclic,
    _check_arity,
    _check_epilogue_consts,
    _check_fed,
    _check_shapes,
    _check_pool_windows,
    _check_reorders,
)


def verify_dfg(dfg: DFG, *, collect_all: bool = False) -> None:
    """Check every structural invariant V1–V10.

    Fail-fast by default: the first violation raises
    :class:`VerificationError` (the PassManager's mode — the offending
    pass is what matters, not an exhaustive damage report).  With
    ``collect_all=True`` all rules run, every violation is gathered,
    and one error is raised at the end listing each as a ``[Vk]`` line
    (also machine-readable on ``VerificationError.violations``).
    """
    violations: list[str] = []

    def fail(rule: str, msg: str) -> None:
        text = f"[{rule}] {msg}"
        if not collect_all:
            raise VerificationError(f"{dfg.name}: {text}", (text,))
        violations.append(text)

    for check in _CHECKS:
        try:
            check(dfg, fail)
        except VerificationError:
            raise
        except Exception:
            # A later rule crashed (KeyError on an unregistered value,
            # …) on damage an earlier rule already reported — the
            # collected violations explain it.  A crash with NO prior
            # violation is a verifier bug: surface it.
            if not violations:
                raise
    if violations:
        body = "\n  ".join(violations)
        raise VerificationError(
            f"{dfg.name}: {len(violations)} structural violation(s)\n  {body}",
            tuple(violations),
        )
