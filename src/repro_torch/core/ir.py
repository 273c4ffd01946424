"""MING core IR: a linalg.generic-like dataflow representation in Python.

The paper (Sec. IV-A) operates on ``linalg.generic`` operations: each op
carries *indexing maps* (affine maps from loop iterators to operand
subscripts) and *iterator types* (``parallel`` | ``reduction``).  MING's
analyses — sliding-window detection (Alg. 1) and iterator classification
(Alg. 2) — read only this structure, never the payload.  We mirror that
here: :class:`GenericOp` is the unit of analysis, :class:`DFG` is the
dataflow graph whose edges are tensors ("streams" after the transform).

This IR is deliberately tiny and dependency-free: it is the contract
between the model-graph frontends (``repro_torch.core.cnn_graphs`` for the
paper's CNN suite, ``repro_torch.graph`` for LM layers) and the analysis /
streaming / DSE passes.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Optional, Sequence


# ---------------------------------------------------------------------------
# Affine expressions / maps (the subset MLIR's affine maps need here:
# integer-linear combinations of loop dims plus a constant).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AffineExpr:
    """``sum(coeff_i * d_i) + const`` over loop dimensions ``d_i``.

    ``terms`` is a sorted tuple of ``(dim_index, coefficient)`` with all
    coefficients nonzero.  A *single-dim* expression (``IS_SINGLE_DIM`` in
    Alg. 2) is one term with coefficient 1 and zero constant.
    """

    terms: tuple[tuple[int, int], ...] = ()
    const: int = 0

    @staticmethod
    def dim(d: int, coeff: int = 1) -> "AffineExpr":
        if coeff == 0:
            return AffineExpr((), 0)
        return AffineExpr(((d, coeff),), 0)

    @staticmethod
    def constant(c: int) -> "AffineExpr":
        return AffineExpr((), c)

    def __add__(self, other: "AffineExpr") -> "AffineExpr":
        acc: dict[int, int] = {}
        for d, c in self.terms + other.terms:
            acc[d] = acc.get(d, 0) + c
        terms = tuple(sorted((d, c) for d, c in acc.items() if c != 0))
        return AffineExpr(terms, self.const + other.const)

    def __mul__(self, k: int) -> "AffineExpr":
        if k == 0:
            return AffineExpr((), 0)
        return AffineExpr(tuple((d, c * k) for d, c in self.terms), self.const * k)

    # -- predicates used by the paper's algorithms --------------------------

    def is_single_dim(self) -> bool:
        """One iterator, unit coefficient, no offset (Alg. 2 IS_SINGLE_DIM)."""
        return len(self.terms) == 1 and self.terms[0][1] == 1 and self.const == 0

    def dims(self) -> tuple[int, ...]:
        return tuple(d for d, _ in self.terms)

    def coeff(self, d: int) -> int:
        for dd, c in self.terms:
            if dd == d:
                return c
        return 0

    def evaluate(self, point: Sequence[int]) -> int:
        return self.const + sum(c * point[d] for d, c in self.terms)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [
            (f"d{d}" if c == 1 else f"{c}*d{d}") for d, c in self.terms
        ]
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)


@dataclass(frozen=True)
class AffineMap:
    """An affine map ``(d0, ..., d{n-1}) -> (E_0, ..., E_{m-1})``."""

    n_dims: int
    results: tuple[AffineExpr, ...]

    @staticmethod
    def identity(n: int) -> "AffineMap":
        return AffineMap(n, tuple(AffineExpr.dim(i) for i in range(n)))

    @staticmethod
    def of(n_dims: int, exprs: Iterable[AffineExpr]) -> "AffineMap":
        return AffineMap(n_dims, tuple(exprs))

    def is_identity(self) -> bool:
        return self.results == tuple(
            AffineExpr.dim(i) for i in range(self.n_dims)
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        ds = ", ".join(f"d{i}" for i in range(self.n_dims))
        rs = ", ".join(repr(e) for e in self.results)
        return f"({ds}) -> ({rs})"


class IteratorType(str, enum.Enum):
    PARALLEL = "parallel"
    REDUCTION = "reduction"


# ---------------------------------------------------------------------------
# Values (tensors / streams) and GenericOp
# ---------------------------------------------------------------------------


@dataclass
class Value:
    """A tensor edge in the DFG.  After the streaming transform these are
    realized as streams (FIFO channels in the FPGA path, VMEM-resident
    producer→consumer handoffs in the TPU path) instead of materialized
    arrays — the core of MING contribution C1."""

    name: str
    shape: tuple[int, ...]
    elem_bits: int = 8  # paper evaluates int8 post-training quantization
    is_constant: bool = False  # weights/biases: not streamed, held on-chip

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def total_bits(self) -> int:
        return self.num_elements * self.elem_bits


class PayloadKind(str, enum.Enum):
    """Semantic tag for the scalar payload region of a GenericOp.

    MING never inspects the payload for *classification* (that is purely
    structural, from indexing maps + iterator types); the payload kind is
    only used by the resource model to count multiplies/adds per iteration
    point (DSP/MXU cost) and by the emitters.
    """

    MAC = "mac"               # out += in0 * in1   (conv / matmul)
    ADD = "add"               # out = in0 + in1
    MAX = "max"               # out = max(in0, in1) (pooling)
    AVG = "avg"               # out = mean over window (avg pooling):
    #                           accumulate ADDs, divide once on the
    #                           stream-exit datapath (the DIV exit path)
    RELU = "relu"             # out = max(in0, 0)
    SQUARED_RELU = "squared_relu"
    IDENTITY = "identity"
    EXP = "exp"
    MUL = "mul"


#: multiplies, adds per iteration point, keyed by payload kind
PAYLOAD_COSTS: dict[PayloadKind, tuple[int, int]] = {
    PayloadKind.MAC: (1, 1),
    PayloadKind.ADD: (0, 1),
    PayloadKind.MAX: (0, 1),
    # avg pool: one add per window point plus the exit divide, realized
    # as a constant-reciprocal multiply (Vitis lowers /const to mul+shift)
    PayloadKind.AVG: (1, 1),
    PayloadKind.RELU: (0, 1),
    PayloadKind.SQUARED_RELU: (1, 1),
    PayloadKind.IDENTITY: (0, 0),
    PayloadKind.EXP: (4, 4),  # poly approx budget
    PayloadKind.MUL: (1, 0),
}


@dataclass(frozen=True)
class FusedEpilogue:
    """One op folded into a producer's payload by the fusion passes
    (``repro_torch.passes.fusion``).

    Elementwise form (``window == ()``): applies ``kind`` to the
    producer's output element once per output point, *after* the main
    payload.  Binary kinds (ADD/MUL/MAX) read their second operand from
    ``operand`` — a *constant* value (bias, scale) held on-chip next to
    the weights; unary kinds leave it None.

    Pooling form (``window != ()``): a non-overlapping window reduction
    folded in by conv+pool fusion.  ``window`` has one factor per output
    axis (e.g. ``(1, 2, 2, 1)`` for an NHWC 2×2 stride-2 max pool) and
    ``kind`` is the combining op (MAX for max pool).  Unlike elementwise
    entries it *shrinks* the output: axis ``i`` divides by ``window[i]``
    — shape bookkeeping goes through :meth:`GenericOp.epilogue_shape`.
    """

    kind: PayloadKind
    operand: Optional[str] = None
    window: tuple[int, ...] = ()


@dataclass
class GenericOp:
    """A ``linalg.generic``-like op.

    ``indexing_maps`` has one entry per input followed by one for the
    output (same convention as MLIR).  ``dim_sizes`` gives the extent of
    every loop dimension (trip counts), known statically for inference
    workloads — the property MING's lightweight DSE relies on.

    ``epilogue`` is the chain of fused elementwise ops applied to each
    output element before it enters the output stream; it never changes
    the loop structure, so every analysis (Alg. 1/2) ignores it.
    """

    name: str
    inputs: tuple[str, ...]
    output: str
    indexing_maps: tuple[AffineMap, ...]
    iterator_types: tuple[IteratorType, ...]
    dim_sizes: tuple[int, ...]
    payload: PayloadKind = PayloadKind.MAC
    elem_bits: int = 8
    epilogue: tuple[FusedEpilogue, ...] = ()

    def __post_init__(self) -> None:
        if len(self.indexing_maps) != len(self.inputs) + 1:
            raise ValueError(
                f"{self.name}: need {len(self.inputs) + 1} indexing maps "
                f"(inputs + output), got {len(self.indexing_maps)}"
            )
        n = len(self.iterator_types)
        if len(self.dim_sizes) != n:
            raise ValueError(f"{self.name}: dim_sizes/iterator_types length mismatch")
        for m in self.indexing_maps:
            if m.n_dims != n:
                raise ValueError(f"{self.name}: map arity {m.n_dims} != {n}")

    # -- convenience ---------------------------------------------------------

    @property
    def input_maps(self) -> tuple[AffineMap, ...]:
        return self.indexing_maps[: len(self.inputs)]

    @property
    def output_map(self) -> AffineMap:
        return self.indexing_maps[-1]

    @property
    def n_dims(self) -> int:
        return len(self.iterator_types)

    def is_parallel_dim(self, d: int) -> bool:
        return self.iterator_types[d] == IteratorType.PARALLEL

    def is_reduction_dim(self, d: int) -> bool:
        return self.iterator_types[d] == IteratorType.REDUCTION

    @property
    def parallel_dims(self) -> tuple[int, ...]:
        return tuple(
            d for d, t in enumerate(self.iterator_types) if t == IteratorType.PARALLEL
        )

    @property
    def reduction_dims(self) -> tuple[int, ...]:
        return tuple(
            d for d, t in enumerate(self.iterator_types) if t == IteratorType.REDUCTION
        )

    @property
    def total_trip_count(self) -> int:
        return math.prod(self.dim_sizes) if self.dim_sizes else 1

    @property
    def output_elements(self) -> int:
        """Number of output points = product of output-map dim extents
        (pre-pooling: a fused pool epilogue consumes these points)."""
        dims = set()
        for expr in self.output_map.results:
            dims.update(expr.dims())
        return math.prod(self.dim_sizes[d] for d in dims) if dims else 1

    def epilogue_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """Shape of the value actually produced, after any fused pooling
        epilogues shrink the mapped output extents (verifier V8 and the
        canonicalizer's shape propagation both route through this)."""
        for e in self.epilogue:
            if e.window:
                shape = tuple(
                    s // f for s, f in zip(shape, e.window)
                )
        return shape

    def macs(self) -> int:
        """Multiply-accumulate-equivalents for the whole op (epilogue
        included: one application per output element)."""
        mults, adds = PAYLOAD_COSTS[self.payload]
        total = self.total_trip_count * max(mults, adds, 1) if (mults or adds) else 0
        for ep in self.epilogue:
            m, a = PAYLOAD_COSTS[ep.kind]
            total += self.output_elements * max(m, a, 1) if (m or a) else 0
        return total

    def dim_extent(self, d: int) -> int:
        return self.dim_sizes[d]


# ---------------------------------------------------------------------------
# Dataflow graph
# ---------------------------------------------------------------------------


@dataclass
class DFG:
    """Dataflow graph over :class:`GenericOp` nodes.

    Mirrors the paper's dfg-mlir abstraction (Sec. III-B): nodes are KPN
    processes, values are FIFO channels.  ``graph_inputs`` are tensors
    arriving from host memory; ``graph_outputs`` leave the fabric.
    """

    name: str
    values: dict[str, Value] = field(default_factory=dict)
    nodes: list[GenericOp] = field(default_factory=list)
    graph_inputs: list[str] = field(default_factory=list)
    graph_outputs: list[str] = field(default_factory=list)

    # -- construction --------------------------------------------------------

    def add_value(self, value: Value) -> Value:
        if value.name in self.values:
            raise ValueError(f"duplicate value {value.name}")
        self.values[value.name] = value
        return value

    def add_node(self, node: GenericOp) -> GenericOp:
        for v in node.inputs + (node.output,):
            if v not in self.values:
                raise ValueError(f"{node.name}: unknown value {v}")
        self.nodes.append(node)
        return node

    # -- topology ------------------------------------------------------------

    def producer_of(self, value_name: str) -> Optional[GenericOp]:
        for n in self.nodes:
            if n.output == value_name:
                return n
        return None

    def consumers_of(self, value_name: str) -> list[GenericOp]:
        return [n for n in self.nodes if value_name in n.inputs]

    def node(self, name: str) -> GenericOp:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def topo_order(self) -> list[GenericOp]:
        """Kahn's algorithm over the tensor-mediated edges."""
        ready: list[GenericOp] = []
        produced = set(self.graph_inputs) | {
            v for v, val in self.values.items() if val.is_constant
        }
        pending = list(self.nodes)
        order: list[GenericOp] = []
        while pending:
            ready = [n for n in pending if all(i in produced for i in n.inputs)]
            if not ready:
                raise ValueError(f"{self.name}: cycle or missing producer in DFG")
            for n in ready:
                order.append(n)
                produced.add(n.output)
                pending.remove(n)
        return order

    def edges(self) -> list[tuple[GenericOp, GenericOp, str]]:
        """(producer, consumer, value) triples for non-constant edges."""
        out = []
        for n in self.nodes:
            for c in self.consumers_of(n.output):
                out.append((n, c, n.output))
        return out

    def intermediate_values(self) -> list[Value]:
        """Values produced and consumed inside the graph — exactly the
        tensors MING refuses to materialize (Fig. 2b)."""
        names = {n.output for n in self.nodes} - set(self.graph_outputs)
        return [self.values[v] for v in names]

    # -- rewrite hooks (used by repro_torch.passes) --------------------------------

    def referenced_values(self) -> set[str]:
        """Every value name reachable from a node, input, or output —
        including epilogue operands (constants folded in by fusion)."""
        refs = set(self.graph_inputs) | set(self.graph_outputs)
        for n in self.nodes:
            refs.update(n.inputs)
            refs.add(n.output)
            refs.update(e.operand for e in n.epilogue if e.operand)
        return refs

    def remove_node(self, name: str) -> GenericOp:
        node = self.node(name)
        self.nodes.remove(node)
        return node

    def remove_value(self, name: str) -> Value:
        """Remove an *unreferenced* value (rewrites must detach it first)."""
        if name in self.referenced_values():
            raise ValueError(f"cannot remove {name}: still referenced")
        return self.values.pop(name)

    def replace_value_uses(self, old: str, new: str) -> int:
        """Rewire every *use* of ``old`` (node inputs, epilogue operands,
        graph outputs) to ``new``.  The producer of ``old`` is untouched."""
        if new not in self.values:
            raise ValueError(f"unknown replacement value {new}")
        n_replaced = 0
        for node in self.nodes:
            if old in node.inputs:
                node.inputs = tuple(new if i == old else i for i in node.inputs)
                n_replaced += 1
            if any(e.operand == old for e in node.epilogue):
                node.epilogue = tuple(
                    dataclasses.replace(e, operand=new) if e.operand == old else e
                    for e in node.epilogue
                )
                n_replaced += 1
        self.graph_outputs = [new if v == old else v for v in self.graph_outputs]
        self.graph_inputs = [new if v == old else v for v in self.graph_inputs]
        return n_replaced

    def clone(self, name: Optional[str] = None) -> "DFG":
        """Deep-enough copy for destructive rewrites: Value and GenericOp
        instances are duplicated; their (immutable) fields are shared."""
        out = DFG(name or self.name)
        out.values = {k: dataclasses.replace(v) for k, v in self.values.items()}
        out.nodes = [dataclasses.replace(n) for n in self.nodes]
        out.graph_inputs = list(self.graph_inputs)
        out.graph_outputs = list(self.graph_outputs)
        return out

    def subgraph(self, node_names: Sequence[str], name: Optional[str] = None) -> "DFG":
        """Extract the induced subgraph over ``node_names`` as a standalone
        DFG — the layer-group partitioner's cut primitive.

        Values consumed but not produced inside the subgraph become graph
        inputs (unless constant); values produced inside and consumed
        outside (or listed in the parent's graph_outputs) become graph
        outputs.
        """
        members = set(node_names)
        sub = DFG(name or f"{self.name}_sub")
        picked = [n for n in self.nodes if n.name in members]
        if len(picked) != len(members):
            missing = members - {n.name for n in picked}
            raise KeyError(f"unknown nodes in subgraph: {sorted(missing)}")
        produced = {n.output for n in picked}
        for n in picked:
            refs = list(n.inputs) + [n.output] + [
                e.operand for e in n.epilogue if e.operand
            ]
            for v in refs:
                if v not in sub.values:
                    sub.values[v] = dataclasses.replace(self.values[v])
        for n in picked:
            for v in n.inputs:
                if (
                    v not in produced
                    and not self.values[v].is_constant
                    and v not in sub.graph_inputs
                ):
                    sub.graph_inputs.append(v)
        for n in picked:
            v = n.output
            consumed_outside = any(
                v in c.inputs for c in self.nodes if c.name not in members
            )
            if (v in self.graph_outputs or consumed_outside) and (
                v not in sub.graph_outputs
            ):
                sub.graph_outputs.append(v)
        sub.nodes = [dataclasses.replace(n) for n in picked]
        return sub


# ---------------------------------------------------------------------------
# Builders for common NN GenericOps (used by cnn_graphs and the LM frontend)
# ---------------------------------------------------------------------------


def make_conv2d_op(
    name: str,
    input_name: str,
    weight_name: str,
    output_name: str,
    *,
    n: int,
    h_out: int,
    w_out: int,
    c_out: int,
    kh: int,
    kw: int,
    c_in: int,
    stride: int = 1,
    dilation: int = 1,
    elem_bits: int = 8,
) -> GenericOp:
    """NHWC conv2d as linalg.generic (paper Fig. 5 maps 1-3).

    dims: (d0=n, d1=h, d2=w, d3=c_out, d4=r, d5=s, d6=c_in);
    input map:  (d0, d1*stride + d4*dilation, d2*stride + d5*dilation, d6)
    weight map: (d4, d5, d6, d3)
    output map: (d0, d1, d2, d3)
    """
    d = AffineExpr.dim
    imap = AffineMap.of(
        7,
        [
            d(0),
            d(1, stride) + d(4, dilation),
            d(2, stride) + d(5, dilation),
            d(6),
        ],
    )
    wmap = AffineMap.of(7, [d(4), d(5), d(6), d(3)])
    omap = AffineMap.of(7, [d(0), d(1), d(2), d(3)])
    P, R = IteratorType.PARALLEL, IteratorType.REDUCTION
    return GenericOp(
        name=name,
        inputs=(input_name, weight_name),
        output=output_name,
        indexing_maps=(imap, wmap, omap),
        iterator_types=(P, P, P, P, R, R, R),
        dim_sizes=(n, h_out, w_out, c_out, kh, kw, c_in),
        payload=PayloadKind.MAC,
        elem_bits=elem_bits,
    )


def make_matmul_op(
    name: str,
    lhs: str,
    rhs: str,
    output: str,
    *,
    m: int,
    k: int,
    n_out: int,
    elem_bits: int = 8,
) -> GenericOp:
    """(m,k) x (k,n) -> (m,n): dims (d0=m, d1=n, d2=k)."""
    d = AffineExpr.dim
    P, R = IteratorType.PARALLEL, IteratorType.REDUCTION
    return GenericOp(
        name=name,
        inputs=(lhs, rhs),
        output=output,
        indexing_maps=(
            AffineMap.of(3, [d(0), d(2)]),
            AffineMap.of(3, [d(2), d(1)]),
            AffineMap.of(3, [d(0), d(1)]),
        ),
        iterator_types=(P, P, R),
        dim_sizes=(m, n_out, k),
        payload=PayloadKind.MAC,
        elem_bits=elem_bits,
    )


def make_elementwise_op(
    name: str,
    inputs: Sequence[str],
    output: str,
    shape: tuple[int, ...],
    payload: PayloadKind,
    elem_bits: int = 8,
) -> GenericOp:
    """Pure-parallel op: identity maps on every operand (paper map0)."""
    n = len(shape)
    ident = AffineMap.identity(n)
    return GenericOp(
        name=name,
        inputs=tuple(inputs),
        output=output,
        indexing_maps=tuple(ident for _ in range(len(inputs) + 1)),
        iterator_types=tuple(IteratorType.PARALLEL for _ in range(n)),
        dim_sizes=shape,
        payload=payload,
        elem_bits=elem_bits,
    )


def make_broadcast_binary_op(
    name: str,
    stream_input: str,
    const_input: str,
    output: str,
    shape: tuple[int, ...],
    payload: PayloadKind,
    elem_bits: int = 8,
) -> GenericOp:
    """Binary pure-parallel op whose second operand is a rank-1 constant
    broadcast along the output's *last* axis (the per-channel bias of an
    imported conv/dense).  The broadcast lives in the indexing map — the
    constant's map reads only ``d_{n-1}`` — so downstream consumers (the
    streaming planner's const-buffer charge, the HLS emitter's epilogue
    operand indexing) see a C-element buffer instead of the H·W·C
    materialization a full-tensor constant would cost.
    """
    n = len(shape)
    ident = AffineMap.identity(n)
    bcast = AffineMap.of(n, [AffineExpr.dim(n - 1)])
    return GenericOp(
        name=name,
        inputs=(stream_input, const_input),
        output=output,
        indexing_maps=(ident, bcast, ident),
        iterator_types=tuple(IteratorType.PARALLEL for _ in range(n)),
        dim_sizes=shape,
        payload=payload,
        elem_bits=elem_bits,
    )


def make_transpose_op(
    name: str,
    input_name: str,
    output_name: str,
    *,
    in_shape: Sequence[int],
    perm: Sequence[int],
    elem_bits: int = 8,
) -> GenericOp:
    """Axis permutation as a pure-parallel data-movement op.

    ``out[i0, …] = in[i_{inv[0]}, …]`` with ``out.shape[p] =
    in_shape[perm[p]]``.  Loop dims index the *output* tensor (output
    map is the identity); the input map carries the permutation, which
    is how the analyses (:func:`repro_torch.core.analysis.reorder_spec`)
    recover it without a payload flag.  The layout-canonicalization
    pass (``repro_torch.passes.layout``) exists to cancel these; the ones
    that survive sit at the graph boundary (ONNX's NCHW contract).
    """
    rank = len(in_shape)
    p = tuple(int(x) for x in perm)
    if sorted(p) != list(range(rank)):
        raise ValueError(f"{name}: perm {p} is not a permutation of "
                         f"0..{rank - 1}")
    inv = [0] * rank
    for pos, ax in enumerate(p):
        inv[ax] = pos
    imap = AffineMap.of(rank, [AffineExpr.dim(inv[k]) for k in range(rank)])
    omap = AffineMap.identity(rank)
    out_shape = tuple(int(in_shape[ax]) for ax in p)
    return GenericOp(
        name=name,
        inputs=(input_name,),
        output=output_name,
        indexing_maps=(imap, omap),
        iterator_types=tuple(IteratorType.PARALLEL for _ in range(rank)),
        dim_sizes=out_shape,
        payload=PayloadKind.IDENTITY,
        elem_bits=elem_bits,
    )


def make_flatten_op(
    name: str,
    input_name: str,
    output_name: str,
    *,
    in_shape: Sequence[int],
    order: Optional[Sequence[int]] = None,
    elem_bits: int = 8,
) -> GenericOp:
    """Linearize axes ``1..r-1`` into one feature axis (rank-2 output).

    ``order`` is the linearization order of the non-batch axes
    (default: ascending — row-major over the input layout).  The output
    map's second result is the affine mixed-radix expression
    ``Σ stride_ax · d_ax``.  An in-order linearization (ascending
    ``order``) is a pure wire on the stream; an out-of-order one
    buffers the tensor (``streaming.plan_node`` charges it) — the
    layout pass's transpose→flatten fold merges two data movements
    into this one node, trading a node and a stream, not the buffer.
    """
    rank = len(in_shape)
    if rank < 2:
        raise ValueError(f"{name}: flatten needs rank >= 2, got {rank}")
    o = tuple(int(x) for x in order) if order is not None \
        else tuple(range(1, rank))
    if sorted(o) != list(range(1, rank)):
        raise ValueError(f"{name}: order {o} is not a permutation of "
                         f"1..{rank - 1}")
    stride = 1
    coeffs: dict[int, int] = {}
    for ax in reversed(o):
        coeffs[ax] = stride
        stride *= int(in_shape[ax])
    expr = AffineExpr((), 0)
    for ax in o:
        expr = expr + AffineExpr.dim(ax, coeffs[ax])
    imap = AffineMap.identity(rank)
    omap = AffineMap.of(rank, [AffineExpr.dim(0), expr])
    return GenericOp(
        name=name,
        inputs=(input_name,),
        output=output_name,
        indexing_maps=(imap, omap),
        iterator_types=tuple(IteratorType.PARALLEL for _ in range(rank)),
        dim_sizes=tuple(int(s) for s in in_shape),
        payload=PayloadKind.IDENTITY,
        elem_bits=elem_bits,
    )


def make_pool2d_op(
    name: str,
    input_name: str,
    output_name: str,
    *,
    n: int,
    h_out: int,
    w_out: int,
    c: int,
    kh: int,
    kw: int,
    stride: int,
    payload: PayloadKind = PayloadKind.MAX,
    elem_bits: int = 8,
) -> GenericOp:
    """Max/avg pool: sliding window with a single (streamed) input."""
    d = AffineExpr.dim
    P, R = IteratorType.PARALLEL, IteratorType.REDUCTION
    imap = AffineMap.of(
        6, [d(0), d(1, stride) + d(4), d(2, stride) + d(5), d(3)]
    )
    omap = AffineMap.of(6, [d(0), d(1), d(2), d(3)])
    return GenericOp(
        name=name,
        inputs=(input_name,),
        output=output_name,
        indexing_maps=(imap, omap),
        iterator_types=(P, P, P, P, R, R),
        dim_sizes=(n, h_out, w_out, c, kh, kw),
        payload=payload,
        elem_bits=elem_bits,
    )
