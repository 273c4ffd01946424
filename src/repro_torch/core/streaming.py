"""MING streaming transform (paper Sec. IV-B): stream & buffer creation.

Turns a :class:`~repro_torch.core.ir.DFG` into a :class:`StreamingPlan`:

* every inter-node tensor becomes a **stream** (FIFO channel) — the
  intermediate array is *never materialized* (contribution C1);
* sliding-window nodes get a **line buffer** of ``(K-1) lines`` plus a
  ``K×…×K`` window buffer (Sec. IV-B);
* regular-reduction nodes get a single **data-line buffer** (the current
  reduction line), no window buffer;
* pure-parallel nodes get a consume-compute-produce structure with no
  buffer at all.

The plan is consumed by three back-ends:
  1. ``resource_model`` — BRAM/DSP (FPGA) and VMEM/MXU (TPU) estimation,
  2. ``dse``            — the ILP of Eq. (1),
  3. ``emit_hls``       — Vitis-style C++ with pragmas, and
     ``kernels/ops.py`` — Pallas block-shape selection (TPU path).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .analysis import (
    IteratorClasses,
    KernelClass,
    KernelInfo,
    classify_kernel,
    reorder_spec,
    window_geometry,
)
from .ir import DFG, GenericOp, IteratorType, Value


# ---------------------------------------------------------------------------
# Plan datatypes
# ---------------------------------------------------------------------------


@dataclass
class StreamEdge:
    """A FIFO channel between two dataflow nodes (or the host boundary).

    ``width`` (number of parallel lanes) is a *DSE variable*: the stream
    constraint of Eq. (1) forces producer and consumer widths equal.  The
    default depth of 2 realizes a double buffer; diamond-shaped graphs
    (residual blocks) get deeper skip-edge FIFOs sized from the
    first-output-cycle estimate (Sec. IV-C, last paragraph).
    """

    name: str
    producer: Optional[str]   # node name, None == host/memory boundary
    consumer: Optional[str]
    elem_bits: int
    width: int = 1
    depth: int = 2

    @property
    def buffer_bits(self) -> int:
        return self.width * self.depth * self.elem_bits


@dataclass
class LoopNest:
    """The loop structure the DSE reasons about for one node.

    ``unrollable`` marks loops eligible for an UNROLL pragma.  The paper's
    cycle estimate is ``II * ceil(total_trip / unroll) + pipeline_depth``
    with II=1 for MING's hazard-free streaming pipelines.
    """

    trip_counts: tuple[int, ...]
    unrollable: tuple[bool, ...]
    pipeline_depth: int = 4

    @property
    def total_trip(self) -> int:
        return math.prod(self.trip_counts) if self.trip_counts else 1


@dataclass
class NodePlan:
    """Streaming realization of one GenericOp."""

    op: GenericOp
    info: KernelInfo
    # -- on-chip buffers (bits) --------------------------------------------
    line_buffer_bits: int = 0       # (K-1) lines of the streamed input
    window_buffer_bits: int = 0     # current compute window (K × … × K)
    const_buffer_bits: int = 0      # weights/biases resident on-chip
    # -- streams -------------------------------------------------------------
    input_streams: list[str] = field(default_factory=list)
    output_streams: list[str] = field(default_factory=list)
    # -- loop nest for the DSE ------------------------------------------------
    loops: LoopNest = field(default_factory=lambda: LoopNest((), ()))
    # loop index whose unroll factor sets the stream width (stream constr.)
    stream_loop: int = 0
    #: loop dims in nest order (``loops.trip_counts[i]`` is the extent of
    #: dim ``loop_dims[i]``) — lets back-ends locate a specific dim
    loop_dims: tuple[int, ...] = ()
    #: parallel non-window dims that index a *constant* input (e.g. c_out
    #: for an NHWC conv's weights) — the axes partial weight streaming
    #: may tile along (``repro_torch.core.dse`` weight_tiles knob)
    weight_tile_dims: tuple[int, ...] = ()

    @property
    def name(self) -> str:
        return self.op.name

    @property
    def kernel_class(self) -> KernelClass:
        return self.info.kernel_class

    @property
    def weight_tileable_extent(self) -> int:
        """Extent of the *leading* weight-tile dim — the one axis every
        backend splits (the emitter's ``WT`` loop divides exactly this
        dim's trip; ``kernels/ops`` slices the const tensor along it),
        so tile counts must divide it, not the product of all tileable
        dims."""
        if not self.weight_tile_dims:
            return 1
        return self.op.dim_extent(self.weight_tile_dims[0])

    def buffer_bits(self) -> int:
        return self.line_buffer_bits + self.window_buffer_bits


@dataclass
class FusionRegion:
    """A maximal producer→consumer chain executed as one pipelined unit.

    FPGA path: one DATAFLOW region (all nodes run as concurrent processes
    connected by hls::stream).  TPU path: one fused Pallas kernel / XLA
    fusion — the intermediates live in VMEM, never HBM.
    """

    name: str
    node_names: list[str]
    internal_streams: list[str]
    boundary_inputs: list[str]
    boundary_outputs: list[str]


@dataclass
class StreamingPlan:
    dfg: DFG
    nodes: dict[str, NodePlan]
    streams: dict[str, StreamEdge]
    regions: list[FusionRegion]

    def node_order(self) -> list[NodePlan]:
        return [self.nodes[n.name] for n in self.dfg.topo_order()]

    def total_buffer_bits(self) -> int:
        return sum(p.buffer_bits() for p in self.nodes.values()) + sum(
            s.buffer_bits for s in self.streams.values()
        )


# ---------------------------------------------------------------------------
# Per-node planning (Sec. IV-B)
# ---------------------------------------------------------------------------


def _streamed_input(op: GenericOp, dfg: DFG) -> tuple[int, Value] | tuple[None, None]:
    """The non-constant input that arrives as a stream (conv activations);
    constants (weights) are held in on-chip ROM/BRAM instead."""
    for i, name in enumerate(op.inputs):
        v = dfg.values[name]
        if not v.is_constant:
            return i, v
    return None, None


def plan_node(op: GenericOp, dfg: DFG) -> NodePlan:
    info = classify_kernel(op)
    plan = NodePlan(op=op, info=info)

    # constants (weights / biases) are kept on-chip for streaming reuse;
    # fused-epilogue operands (bias/scale folded in by repro_torch.passes) live
    # alongside them
    plan.const_buffer_bits = sum(
        dfg.values[i].total_bits for i in op.inputs if dfg.values[i].is_constant
    ) + sum(
        dfg.values[e.operand].total_bits for e in op.epilogue if e.operand
    )

    if info.kernel_class == KernelClass.SLIDING_WINDOW:
        geo = window_geometry(op, info)
        idx, streamed = _streamed_input(op, dfg)
        assert streamed is not None, f"{op.name}: sliding window with no stream input"
        # channel-like reduction dims of the *streamed* input: single-dim
        # reduction subscripts in its map (e.g. c_in for NHWC conv).
        smap = op.input_maps[idx]
        chan = 1
        for expr in smap.results:
            if expr.is_single_dim():
                (d, _), = expr.terms
                if op.is_reduction_dim(d):
                    chan *= op.dim_extent(d)
        # line buffer: (K_outer - 1) lines; a line spans the *input* extent
        # of the innermost window axis times the channel depth.
        if len(geo.window_dims) >= 2:
            k_outer = geo.window_extents[0]
            line_len = geo.input_extents[-1]
            plan.line_buffer_bits = (
                max(k_outer - 1, 0) * line_len * chan * op.elem_bits
            )
        elif len(geo.window_dims) == 1:
            # 1-D sliding window: the "line" degenerates to K-1 elements
            plan.line_buffer_bits = (
                max(geo.window_extents[0] - 1, 0) * chan * op.elem_bits
            )
        # window buffer: K × … × K × chan  (the current dot-product window)
        win_elems = math.prod(geo.window_extents) * chan
        plan.window_buffer_bits = win_elems * op.elem_bits
        # loop nest: parallel dims outermost, window/reduction innermost.
        order = list(info.classes.parallel) + list(info.classes.window) + list(
            info.classes.reduction
        )
        trips = tuple(op.dim_extent(d) for d in order)
        # unrollable: everything but the sliding spatial loops (reordering
        # those breaks the streaming order — the property Sec. IV-B notes
        # polyhedral frameworks cannot preserve).
        unrollable = tuple(
            d not in info.classes.window and op.dim_extent(d) > 1 for d in order
        )
        plan.loops = LoopNest(trips, unrollable)
        plan.stream_loop = _first_unrollable(plan.loops)

    elif info.kernel_class == KernelClass.REGULAR_REDUCTION:
        # "the current data line" buffer: extent of the reduction dims of
        # the streamed input (e.g. the k-vector of a matvec row).
        idx, streamed = _streamed_input(op, dfg)
        line = 1
        if idx is not None:
            for expr in op.input_maps[idx].results:
                for d in expr.dims():
                    if op.is_reduction_dim(d):
                        line *= op.dim_extent(d)
        plan.line_buffer_bits = line * op.elem_bits
        order = list(info.classes.parallel) + list(info.classes.reduction)
        trips = tuple(op.dim_extent(d) for d in order)
        unrollable = tuple(op.dim_extent(d) > 1 for d in order)
        plan.loops = LoopNest(trips, unrollable)
        plan.stream_loop = _first_unrollable(plan.loops)

    else:  # PURE_PARALLEL: consume-compute-produce, no storage at all
        order = list(range(op.n_dims))
        trips = tuple(op.dim_extent(d) for d in order)
        plan.loops = LoopNest(trips, tuple(t > 1 for t in trips), pipeline_depth=2)
        plan.stream_loop = _first_unrollable(plan.loops)
        # a reorder op that changes the stream order (transpose, or a
        # flatten whose linearization is not the arrival order) must
        # buffer the whole tensor before the first out-of-order element
        # can leave — charge it; an in-order flatten is a pure wire.
        spec = reorder_spec(op)
        if spec is not None:
            kind, arg = spec
            in_order = (
                kind == "flatten" and arg == tuple(range(1, op.n_dims))
            )
            if not in_order:
                plan.line_buffer_bits = (
                    dfg.values[op.inputs[0]].total_bits
                )

    plan.loop_dims = tuple(order)

    # dims eligible for partial weight streaming: parallel non-window
    # subscripts of a constant input (c_out for conv weights, n_out for
    # matmul weights) — tiling them splits the const buffer cleanly.
    window = set(info.classes.window)
    tile_dims: set[int] = set()
    for i, name in enumerate(op.inputs):
        if not dfg.values[name].is_constant:
            continue
        for expr in op.input_maps[i].results:
            if expr.is_single_dim():
                (d, _), = expr.terms
                if op.is_parallel_dim(d) and d not in window:
                    tile_dims.add(d)
    plan.weight_tile_dims = tuple(sorted(tile_dims))

    # fused pooling epilogue: one partial line of pooled outputs is kept
    # while the window's leading axis fills (the 2×2 pool's row buffer)
    out_shape = dfg.values[op.output].shape
    for e in op.epilogue:
        if not e.window or not any(f > 1 for f in e.window):
            continue
        first = next(i for i, f in enumerate(e.window) if f > 1)
        line_elems = math.prod(
            out_shape[a] for a in range(first + 1, len(out_shape))
        )
        plan.line_buffer_bits += (e.window[first] - 1) * line_elems * op.elem_bits

    return plan


def _first_unrollable(loops: LoopNest) -> int:
    for i, u in enumerate(loops.unrollable):
        if u:
            return i
    return 0


# ---------------------------------------------------------------------------
# Graph-level planning: streams + fusion regions
# ---------------------------------------------------------------------------


def plan_streams(dfg: DFG) -> StreamingPlan:
    """Build the full streaming plan for a DFG (paper Fig. 4, stages
    "Stream/Buffer creation" + dfg construction)."""
    nodes = {op.name: plan_node(op, dfg) for op in dfg.nodes}
    streams: dict[str, StreamEdge] = {}

    # host boundary streams
    for gi in dfg.graph_inputs:
        v = dfg.values[gi]
        for consumer in dfg.consumers_of(gi):
            s = StreamEdge(
                name=f"s_{gi}_to_{consumer.name}",
                producer=None,
                consumer=consumer.name,
                elem_bits=v.elem_bits,
            )
            streams[s.name] = s
            nodes[consumer.name].input_streams.append(s.name)
    for go in dfg.graph_outputs:
        prod = dfg.producer_of(go)
        if prod is not None:
            v = dfg.values[go]
            s = StreamEdge(
                name=f"s_{prod.name}_to_out",
                producer=prod.name,
                consumer=None,
                elem_bits=v.elem_bits,
            )
            streams[s.name] = s
            nodes[prod.name].output_streams.append(s.name)

    # inter-node streams: one per (producer, consumer) pair — the
    # intermediate tensor itself is never allocated.
    for prod, cons, vname in dfg.edges():
        v = dfg.values[vname]
        s = StreamEdge(
            name=f"s_{prod.name}_to_{cons.name}",
            producer=prod.name,
            consumer=cons.name,
            elem_bits=v.elem_bits,
        )
        streams[s.name] = s
        nodes[prod.name].output_streams.append(s.name)
        nodes[cons.name].input_streams.append(s.name)

    regions = _form_regions(dfg, nodes, streams)
    plan = StreamingPlan(dfg=dfg, nodes=nodes, streams=streams, regions=regions)
    _size_diamond_fifos(plan)
    return plan


def _form_regions(
    dfg: DFG, nodes: dict[str, NodePlan], streams: dict[str, StreamEdge]
) -> list[FusionRegion]:
    """Connected components of the node graph = DATAFLOW regions.

    On the FPGA every component becomes one top-level DATAFLOW pipeline;
    on TPU it is the fusion unit handed to Pallas.
    """
    parent: dict[str, str] = {n: n for n in nodes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: str, b: str) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for s in streams.values():
        if s.producer and s.consumer:
            union(s.producer, s.consumer)

    comps: dict[str, list[str]] = {}
    order = [op.name for op in dfg.topo_order()]
    for n in order:
        comps.setdefault(find(n), []).append(n)

    regions = []
    for i, (_, members) in enumerate(sorted(comps.items(), key=lambda kv: order.index(kv[1][0]))):
        member_set = set(members)
        internal, b_in, b_out = [], [], []
        for s in streams.values():
            pin = s.producer in member_set
            cin = s.consumer in member_set
            if pin and cin:
                internal.append(s.name)
            elif cin and s.producer is None:
                b_in.append(s.name)
            elif pin and s.consumer is None:
                b_out.append(s.name)
        regions.append(
            FusionRegion(
                name=f"region{i}",
                node_names=members,
                internal_streams=internal,
                boundary_inputs=b_in,
                boundary_outputs=b_out,
            )
        )
    return regions


def fifo_slack(plan: StreamingPlan) -> dict[str, int]:
    """Required skew absorption per internal stream (positive entries
    only): how many cycles earlier this edge's data is ready than the
    consumer's slowest *other* input — the depth a reconvergent skip
    FIFO must provide or the pipeline deadlocks (Sec. IV-C, final
    paragraph).  Derived from the line-buffer geometry via
    :func:`first_output_cycles`.  The one definition shared by the
    sizing pass (:func:`_size_diamond_fifos`) and the stream-skew
    analyzer (``repro_torch.analyze.stream_skew``)."""
    dfg = plan.dfg
    order = [op.name for op in dfg.topo_order()]
    # longest path (in first-output cycles) from any graph input to node n
    dist: dict[str, int] = {n: 0 for n in order}
    for name in order:
        node = plan.nodes[name]
        preds = [
            plan.streams[s].producer
            for s in node.input_streams
            if plan.streams[s].producer is not None
        ]
        base = max((dist[p] for p in preds), default=0)
        dist[name] = base + _first_output_cycles(node)

    slack: dict[str, int] = {}
    for s in plan.streams.values():
        if s.producer is None or s.consumer is None:
            continue
        # slack between when this edge's data is ready and when the
        # consumer's *other* inputs are ready
        consumer = plan.nodes[s.consumer]
        other_ready = 0
        for other in consumer.input_streams:
            o = plan.streams[other]
            if o.name != s.name and o.producer is not None:
                other_ready = max(other_ready, dist[o.producer])
        need = other_ready - dist[s.producer]
        if need > 0:
            slack[s.name] = need
    return slack


def _size_diamond_fifos(plan: StreamingPlan) -> None:
    """FIFO sizing for diamond structures (Sec. IV-C, final paragraph).

    When two paths from a fork re-join (residual blocks), the short path's
    FIFO must absorb the long path's latency-to-first-output, or the
    pipeline deadlocks.  We size the skip FIFO to the sum of
    first-output-cycle estimates along the long path (conservative, as the
    paper notes; FIFOAdvisor-style refinement is future work there too).
    """
    for name, need in fifo_slack(plan).items():
        s = plan.streams[name]
        s.depth = max(s.depth, need)


def first_output_cycles(plan: NodePlan) -> int:
    """Cycles until the node's first output element appears (unroll=1):
    a sliding-window node must fill K−1 line buffers plus one window, a
    regular reduction its reduction trip, a buffering reorder the whole
    tensor.  Public because the stream-skew analyzer reasons about the
    same geometry."""
    return _first_output_cycles(plan)


def _first_output_cycles(plan: NodePlan) -> int:
    op = plan.op
    if plan.kernel_class == KernelClass.SLIDING_WINDOW:
        geo = window_geometry(op, plan.info)
        if len(geo.window_dims) >= 2:
            # must fill K-1 lines plus one window before first output
            fill = (geo.window_extents[0] - 1) * geo.input_extents[-1]
            return fill + math.prod(geo.window_extents)
        return geo.window_extents[0]
    if plan.kernel_class == KernelClass.REGULAR_REDUCTION:
        red = 1
        for d in plan.info.classes.reduction:
            red *= op.dim_extent(d)
        return red
    if plan.line_buffer_bits:
        # a buffering reorder (transpose) emits nothing until the whole
        # tensor has arrived
        return plan.loops.total_trip
    return 1
