"""Vitis-HLS C++ emission from the schedule IR (the paper's emithls stage).

MING's final stage translates its ``emithls`` dialect to Vitis HLS C++.
We reproduce that artifact: :func:`emit_design` consumes a
:class:`~repro_torch.core.compile_driver.CompiledDesign` and emits one
complete DATAFLOW kernel per :class:`GroupSchedule` plus the host-side
group schedule, with the five pragma families the paper highlights
(Sec. III-C):

  STREAM, UNROLL, PIPELINE (II=1), ARRAY_PARTITION, BIND_STORAGE,
  plus the top-level DATAFLOW region.

Weight-streamed nodes (``DseResult.weight_tiles``) emit the
double-buffered ``wtile[2][…]`` ping/pong array, a ``WT`` tile loop
with prefetch, and ``m_axi`` DRAM weight pointers; windowed (pooling)
epilogues emit their partial-row buffer; the host schedule overlaps
each group's spill write with the next group's fill through an async
DMA queue (matching ``transition_cycles``).  ``emit_cpp`` remains the
per-plan workhorse underneath.

The emitter is golden-file tested; it cannot be synthesized in this
container (no Vitis), but it is the faithful end of the reproduction
pipeline and demonstrates that the schedule IR carries every datum the
HLS backend needs.
"""
from __future__ import annotations

import math
from typing import Iterable

from .analysis import KernelClass, window_geometry
from .dse import DseResult
from .ir import PayloadKind
from .streaming import NodePlan, StreamingPlan

_CTYPE = {8: "ap_int<8>", 16: "ap_int<16>", 32: "ap_int<32>"}

_PAYLOAD_EXPR = {
    PayloadKind.MAC: "acc += (accum_t)win[i] * (accum_t)wgt[i];",
    PayloadKind.ADD: "out_v = a_v + b_v;",
    PayloadKind.MAX: "out_v = (a_v > b_v) ? a_v : b_v;",
    PayloadKind.AVG: "acc += (accum_t)win[i];  // avg-pool accumulate",
    PayloadKind.RELU: "out_v = (in_v > 0) ? in_v : (elem_t)0;",
    PayloadKind.SQUARED_RELU: "out_v = (in_v > 0) ? (elem_t)(in_v * in_v) : (elem_t)0;",
    PayloadKind.IDENTITY: "out_v = in_v;",
    PayloadKind.MUL: "out_v = a_v * b_v;",
    PayloadKind.EXP: "out_v = hls::exp(in_v);",
}

#: fused-epilogue templates: {v} is the node's result variable (``acc``
#: for MAC nodes, ``out_v`` otherwise), {k} the on-chip constant operand.
_EPILOGUE_EXPR = {
    PayloadKind.RELU: "{v} = ({v} > 0) ? {v} : 0;",
    PayloadKind.SQUARED_RELU: "{v} = ({v} > 0) ? {v} * {v} : 0;",
    PayloadKind.IDENTITY: "",
    PayloadKind.EXP: "{v} = hls::exp({v});",
    PayloadKind.ADD: "{v} += {k};",
    PayloadKind.MUL: "{v} *= {k};",
    PayloadKind.MAX: "{v} = ({v} > {k}) ? {v} : {k};",
}


def _floor_div_stmt(var: str, pts: int) -> str:
    """The DIV exit path as *floor* division — C's `/` truncates toward
    zero, which would diverge from ``ref.pool_reduce`` by 1 LSB on
    negative sums.  Power-of-two windows (the common 2×2/4×4 pools) are
    an arithmetic right shift, which floors exactly; other factors get
    the explicit remainder adjustment."""
    if pts & (pts - 1) == 0:
        return f"{var} >>= {pts.bit_length() - 1};"
    return f"{var} = ({var} - ((({var} % {pts}) + {pts}) % {pts})) / {pts};"


def _emit_epilogue(op, indent: str, values: dict | None = None) -> list[str]:
    """Fused-epilogue lines applied to the result before stream write.

    ``values`` (when provided) sizes constant operands: an operand with
    fewer elements than the output is a broadcast (per-channel bias) and
    indexes modulo its own length — full-size operands keep the plain
    ``[o]`` subscript."""
    var = "acc" if op.payload in (PayloadKind.MAC, PayloadKind.AVG) else "out_v"
    lines = []
    if op.payload == PayloadKind.AVG:
        # standalone avg pool: the divide rides the stream-exit datapath
        # once per output point, after the window accumulation completes
        pts = math.prod(op.dim_sizes[d] for d in op.reduction_dims)
        lines.append(
            f"{indent}{_floor_div_stmt(var, pts)}  "
            f"// avg-pool DIV exit path (/{pts}, floor)"
        )
    for e in op.epilogue:
        if e.window:
            # windowed (pooling) entry: the row buffer holds partial
            # reductions until the window's leading axis fills
            f = "x".join(str(x) for x in e.window if x > 1)
            if e.kind == PayloadKind.MAX:
                lines.append(
                    f"{indent}pool_line[o % POOL_LINE] = "
                    f"({var} > pool_line[o % POOL_LINE]) ? {var} : "
                    f"pool_line[o % POOL_LINE];  // fused {e.kind.value}-pool /{f}"
                )
            else:  # ADD / AVG: accumulate into the partial row
                lines.append(
                    f"{indent}pool_line[o % POOL_LINE] += {var};  "
                    f"// fused {e.kind.value}-pool /{f}"
                )
                if e.kind == PayloadKind.AVG:
                    # divide exactly once per pooled output — on the
                    # window's last row, when the slot has received all
                    # prod(window) contributions (dividing every step
                    # would divide partial sums repeatedly)
                    pts = math.prod(e.window)
                    lead = next(x for x in e.window if x > 1)
                    div = _floor_div_stmt(f"pool_line[o % POOL_LINE]", pts)
                    lines.append(
                        f"{indent}if ((o / POOL_LINE) % {lead} == {lead - 1}) "
                        f"{div}  "
                        f"// avg-pool DIV exit path (/{pts}, floor, window full)"
                    )
            continue
        # `o` is the flat output-point index, same schematic convention
        # as the payload's `win[i]`/`wgt[i]` accesses
        k = ""
        if e.operand:
            idx = "o"
            if values is not None:
                n = values[e.operand].num_elements
                if n < values[op.output].num_elements:
                    idx = f"o % {n}"  # broadcast (per-channel) operand
            k = f"k_{e.operand}[{idx}]"
        expr = _EPILOGUE_EXPR[e.kind].format(v=var, k=k)
        if expr:
            lines.append(f"{indent}{expr}  // fused {e.kind.value}")
    return lines


def _pool_line_elems(op, values) -> int:
    """Partial-row buffer length for the first fused pooling epilogue."""
    for e in op.epilogue:
        if e.window and any(f > 1 for f in e.window):
            shape = values[op.output].shape
            first = next(i for i, f in enumerate(e.window) if f > 1)
            n = 1
            for a in range(first + 1, len(shape)):
                n *= shape[a]
            return max(n, 1)
    return 0


def _ctype(bits: int) -> str:
    return _CTYPE.get(bits, f"ap_int<{bits}>")


def dram_weight_values(plan: StreamingPlan, dse: DseResult) -> list[str]:
    """Constant values whose node streams them from DRAM (weight_tiles>1):
    these become m_axi pointer ports instead of on-chip ROMs."""
    out: list[str] = []
    for np_ in plan.node_order():
        if dse.weight_tiles.get(np_.name, 1) > 1:
            for i in np_.op.inputs:
                if plan.dfg.values[i].is_constant and i not in out:
                    out.append(i)
    return out


def emit_node(plan: NodePlan, unroll: int, width: int,
              values: dict | None = None, weight_tiles: int = 1) -> str:
    """One dataflow process function for a node.

    ``weight_tiles > 1`` emits the partial-weight-streaming realization:
    a double-buffered (ping/pong) tile array fed from DRAM and a tile
    loop wrapping the nest, with the tiled output-channel trip divided.
    """
    op = plan.op
    lines: list[str] = []
    ins = ", ".join(
        f"hls::stream<elem_t> &{s}" for s in plan.input_streams
    )
    outs = ", ".join(
        f"hls::stream<elem_t> &{s}" for s in plan.output_streams
    )
    args = ", ".join(x for x in (ins, outs) if x)
    if weight_tiles > 1:
        wnames = [i for i in op.inputs if values and values[i].is_constant]
        wargs = ", ".join(f"const elem_t *dram_{v}" for v in wnames)
        args = ", ".join(x for x in (args, wargs) if x)
    lines.append(f"void {op.name}({args}) {{")

    # fused-epilogue constants (bias/scale) live on-chip next to the
    # weights, one element per output point (identity-map fusion)
    for e in op.epilogue:
        if e.operand:
            n = values[e.operand].num_elements if values else 1
            lines.append(f"  static elem_t k_{e.operand}[{n}];  // fused-const")

    # fused-pool partial row (windowed epilogue)
    pool_elems = _pool_line_elems(op, values) if values else 0
    if pool_elems:
        lines.append(f"  #define POOL_LINE {pool_elems}")
        lines.append(f"  static elem_t pool_line[{pool_elems}];  // fused-pool row")
        lines.append(
            "#pragma HLS BIND_STORAGE variable=pool_line type=ram_2p impl=bram"
        )

    if weight_tiles > 1:
        tile_elems = max(
            plan.const_buffer_bits // max(op.elem_bits, 1) // weight_tiles, 1
        )
        lines.append(
            f"  elem_t wtile[2][{tile_elems}];  "
            f"// double-buffered DRAM weight tile (1/{weight_tiles} of the set)"
        )
        lines.append("#pragma HLS ARRAY_PARTITION variable=wtile dim=1 complete")
        lines.append(
            "#pragma HLS BIND_STORAGE variable=wtile type=ram_2p impl=bram"
        )

    if plan.kernel_class == KernelClass.SLIDING_WINDOW:
        geo = window_geometry(op, plan.info)
        if len(geo.window_dims) >= 2:
            k_outer = geo.window_extents[0]
            line_len = geo.input_extents[-1]
            stride_note = ""
            if op.payload == PayloadKind.MAC and geo.stride > 1:
                # strided conv: the line shifter still holds K-1 input
                # rows, but only every stride-th window row is emitted
                stride_note = (
                    f"  // stride {geo.stride}: ingest {geo.stride} input "
                    "rows per output row"
                )
            lines.append(
                f"  elem_t line_buf[{max(k_outer - 1, 1)}][{line_len}];"
                f"{stride_note}"
            )
            lines.append(
                "#pragma HLS BIND_STORAGE variable=line_buf type=ram_2p impl=bram"
            )
            lines.append(
                f"#pragma HLS ARRAY_PARTITION variable=line_buf dim=1 complete"
            )
        win = math.prod(geo.window_extents)
        lines.append(f"  elem_t win[{win}];")
        lines.append("#pragma HLS ARRAY_PARTITION variable=win complete")
        lines.append(f"  elem_t wgt[{win}];")
        lines.append("#pragma HLS ARRAY_PARTITION variable=wgt complete")
    elif plan.kernel_class == KernelClass.REGULAR_REDUCTION:
        red = max(plan.line_buffer_bits // max(op.elem_bits, 1), 1)
        lines.append(f"  elem_t line[{red}];")
        part = min(unroll, red)
        lines.append(
            f"#pragma HLS ARRAY_PARTITION variable=line cyclic factor={part}"
        )

    # loop nest.  The epilogue applies once per *output point*: for MAC
    # nodes that is after the trailing window/reduction loops complete
    # (the accumulator is final there); pure-parallel nodes produce one
    # output per innermost iteration, so it stays next to the payload.
    inner_acc = 0
    if plan.kernel_class != KernelClass.PURE_PARALLEL:
        # trailing loops of the nest (plan_node puts reductions innermost)
        inner_acc = len(plan.info.classes.reduction)

    trips = list(plan.loops.trip_counts)
    depth = 0
    if weight_tiles > 1:
        # tile loop wraps the nest; the tiled output-channel dim runs
        # 1/weight_tiles of its extent per pass
        if plan.weight_tile_dims and plan.loop_dims:
            tpos = plan.loop_dims.index(plan.weight_tile_dims[0])
            trips[tpos] = max(trips[tpos] // weight_tiles, 1)
        wname = next(
            (i for i in op.inputs if values and values[i].is_constant), "w"
        )
        lines.append(f"  load_tile(wtile[0], dram_{wname}, 0);  // preload tile 0")
        lines.append(
            f"  WT: for (int wt = 0; wt < {weight_tiles}; ++wt) {{"
        )
        lines.append(
            f"    if (wt + 1 < {weight_tiles}) "
            f"load_tile(wtile[(wt + 1) & 1], dram_{wname}, wt + 1);  "
            "// prefetch next tile while computing from wtile[wt & 1]"
        )
        depth = 1
    for i, trip in enumerate(trips):
        indent = "  " * (depth + 1)
        lines.append(f"{indent}L{i}: for (int i{i} = 0; i{i} < {trip}; ++i{i}) {{")
        depth += 1
        if i == len(trips) - 1:
            indent = "  " * (depth + 1)
            lines.append(f"{indent}#pragma HLS PIPELINE II=1")
            if unroll > 1:
                lines.append(f"{indent}#pragma HLS UNROLL factor={unroll}")
            body = _PAYLOAD_EXPR[op.payload]
            lines.append(f"{indent}{body}")
            if inner_acc == 0:
                lines.extend(_emit_epilogue(op, indent, values))
    inner_acc = min(inner_acc, max(depth - 1, 0))
    has_exit = bool(op.epilogue) or op.payload == PayloadKind.AVG
    for j, i in enumerate(range(depth, 0, -1)):
        lines.append("  " * i + "}")
        if has_exit and inner_acc and j + 1 == inner_acc:
            # just closed the accumulation loops: acc is final here
            lines.extend(_emit_epilogue(op, "  " * i, values))
    lines.append("}")
    return "\n".join(lines)


def emit_cpp(
    plan: StreamingPlan,
    dse: DseResult,
    top_name: str | None = None,
    *,
    m_axi_wrapper: bool = False,
) -> str:
    """Emit the full Vitis-style C++ translation unit.

    ``m_axi_wrapper=True`` additionally emits an ``extern "C"``
    ``<top>_m_axi(elem_t *...)`` entry whose pointer arguments are the
    graph's input/output *values* (DDR buffers) — the symbol the
    host-side layer-group schedule links against.
    """
    top = top_name or plan.dfg.name
    parts: list[str] = [
        "// Generated by MING-repro emithls backend",
        "#include <hls_stream.h>",
        "#include <ap_int.h>",
        "",
        f"typedef {_ctype(8)} elem_t;",
        f"typedef {_ctype(32)} accum_t;",
        "",
    ]
    order = plan.node_order()
    for np_ in order:
        u = dse.unrolls.get(np_.name, 1)
        w = dse.stream_widths.get(np_.name, 1)
        t = dse.weight_tiles.get(np_.name, 1)
        parts.append(emit_node(np_, u, w, values=plan.dfg.values,
                               weight_tiles=t))
        parts.append("")

    # top-level DATAFLOW region
    gi = [s for s in plan.streams.values() if s.producer is None]
    go = [s for s in plan.streams.values() if s.consumer is None]
    dram_w = dram_weight_values(plan, dse)
    args = ", ".join(
        [f"hls::stream<elem_t> &{s.name}" for s in gi]
        + [f"hls::stream<elem_t> &{s.name}" for s in go]
        + [f"const elem_t *dram_{v}" for v in dram_w]
    )
    parts.append(f"void {top}({args}) {{")
    parts.append("#pragma HLS DATAFLOW")
    for s in plan.streams.values():
        if s.producer is not None and s.consumer is not None:
            parts.append(f"  hls::stream<elem_t> {s.name};")
            parts.append(
                f"#pragma HLS STREAM variable={s.name} depth={s.depth}"
            )
    for np_ in order:
        call_args = list(np_.input_streams + np_.output_streams)
        if dse.weight_tiles.get(np_.name, 1) > 1:
            call_args += [
                f"dram_{v}" for v in np_.op.inputs
                if plan.dfg.values[v].is_constant
            ]
        parts.append(f"  {np_.op.name}({', '.join(call_args)});")
    parts.append("}")
    parts.append("")

    if m_axi_wrapper:
        io_values = list(plan.dfg.graph_inputs) + list(plan.dfg.graph_outputs)
        wargs = ", ".join(
            [f"elem_t *{v}" for v in io_values]
            + [f"const elem_t *{v}" for v in dram_w]
        )
        parts.append(f'extern "C" void {top}_m_axi({wargs}) {{')
        for v in io_values + dram_w:
            parts.append(f"#pragma HLS INTERFACE m_axi port={v} offset=slave")
        for s in gi + go:
            parts.append(f"  hls::stream<elem_t> {s.name};")
        parts.append("  // DMA: DDR -> input streams, run, output streams -> DDR")
        parts.append(
            f"  {top}("
            + ", ".join([s.name for s in gi + go] + [v for v in dram_w])
            + ");"
        )
        parts.append("}")
        parts.append("")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Whole-design emission off the schedule IR (repro_torch.core.compile_driver)
# ---------------------------------------------------------------------------


def emit_design(design) -> dict[str, str]:
    """Emit a :class:`repro_torch.core.compile_driver.CompiledDesign`: one
    translation unit per group schedule plus the host-side schedule that
    runs them sequentially (single-group designs get one kernel and a
    trivial host schedule).

    Returns ``{filename: contents}``: ``<group>.cpp`` per group (each a
    complete DATAFLOW kernel, top function named after the group) and
    ``host_schedule.cpp`` declaring the DRAM spill buffers (and any
    streamed-weight buffers) and invoking the group kernels in order.
    Every datum comes from the design's :class:`GroupSchedule`s — no
    plan state is re-derived here.
    """
    import repro_torch.instrument as instrument

    tracer = instrument.current()
    files: dict[str, str] = {}
    with tracer.span(f"emit:{design.source.name}", cat="emit") as eargs:
        for g in design.groups:
            with tracer.span(f"emit:{g.name}.cpp", cat="emit") as gargs:
                files[f"{g.name}.cpp"] = emit_cpp(
                    g.plan, g.dse, top_name=g.name, m_axi_wrapper=True
                )
                gargs.update({"bytes": len(files[f"{g.name}.cpp"]),
                              "nodes": len(g.dfg.nodes)})
        with tracer.span("emit:host_schedule.cpp", cat="emit") as hargs:
            files["host_schedule.cpp"] = emit_host_schedule(design)
            hargs["bytes"] = len(files["host_schedule.cpp"])
        eargs["files"] = len(files)
    return files


#: historical name: the partitioned and monolithic paths are
#: now the same single entry point over the schedule IR
emit_partitioned = emit_design


def emit_host_schedule(pp) -> str:
    """The host-side group schedule (the artifact a partitioned design
    adds over a monolithic one).

    Group transitions issue *overlapped* DMA: the spill write of group
    *k* is queued asynchronously and the fill of group *k+1* streams one
    burst behind it (``dma_write_async`` / ``dma_read_async`` /
    ``dma_join``), matching the
    :func:`repro_torch.core.resource_model.transition_cycles` cost model —
    ``max(spill, fill)`` plus the exposed burst tail, not a serial
    round trip.
    """
    from .resource_model import transition_cycles

    src = pp.source
    lines = [
        "// Generated by MING-repro emithls backend — layer-group schedule",
        f"// source graph: {src.name} | groups: {len(pp.groups)} | "
        f"peak BRAM {pp.max_bram}/{pp.b_total} | peak DSP {pp.max_dsp}/{pp.d_total}",
        "#include <cstddef>",
        "",
        "typedef signed char elem_t;",
        "",
    ]
    if pp.partitioned:
        lines += [
            "// async DMA queue: spill writes of group k overlap the fill of",
            "// group k+1 (the read trails the write by one DRAM burst)",
            "void dma_write_async(const elem_t *buf, size_t bytes);",
            "void dma_read_async(elem_t *buf, size_t bytes);",
            "void dma_join();  // barrier: all queued transfers retired",
            "",
        ]
    group_weights = {g.name: dram_weight_values(g.plan, g.dse) for g in pp.groups}
    for g in pp.groups:
        args = ["elem_t *" + v for v in g.dfg.graph_inputs]
        args += ["elem_t *" + v for v in g.dfg.graph_outputs]
        args += ["const elem_t *" + v for v in group_weights[g.name]]
        lines.append(
            f'extern "C" void {g.name}_m_axi({", ".join(args)});  // kernel'
        )
    lines.append("")
    for s in pp.spills():
        lines.append(
            f"static elem_t spill_{s.value}[{s.bytes}];  "
            f"// DRAM boundary buffer ({s.bytes / 1024:.1f} KiB)"
        )
    for g in pp.groups:
        for v in group_weights[g.name]:
            b = math.ceil(src.values[v].total_bits / 8)
            lines.append(
                f"static elem_t wstream_{v}[{b}];  "
                f"// DRAM-resident streamed weights ({b / 1024:.1f} KiB)"
            )
    lines.append("")
    io = ["elem_t *" + v for v in src.graph_inputs] + [
        "elem_t *" + v for v in src.graph_outputs
    ]
    lines.append(f"void run_{src.name}({', '.join(io)}) {{")
    lines.append(
        "  // groups execute sequentially; one bitstream resident at a time"
    )
    spilled = {s.value for s in pp.spills()}

    def ref(v: str) -> str:
        return f"spill_{v}" if v in spilled else v

    traffic = pp.boundary_traffic()
    for gi, g in enumerate(pp.groups):
        call = [ref(v) for v in g.dfg.graph_inputs + g.dfg.graph_outputs]
        call += [f"wstream_{v}" for v in group_weights[g.name]]
        streamed = g.weight_streamed
        note = (
            f", weights streamed {streamed}" if streamed else ""
        )
        lines.append(
            f"  // {g.name}: {', '.join(n.name for n in g.dfg.nodes)} "
            f"(BRAM {g.bram}, DSP {g.dsp}, {g.cycles} cycles{note})"
        )
        lines.append(f"  {g.name}_m_axi({', '.join(call)});")
        if gi < len(pp.groups) - 1:
            nxt = pp.groups[gi + 1]
            wb, rb = traffic[gi]
            cyc = transition_cycles(wb, rb)
            lines.append(
                f"  // transition {g.name} -> {nxt.name}: write {wb} B "
                f"overlaps read {rb} B — {cyc} cycles modeled"
            )
            for v in g.spill_out:
                b = math.ceil(src.values[v].total_bits / 8)
                lines.append(f"  dma_write_async({ref(v)}, {b});")
            for v in nxt.spill_in:
                # a spill_in that is also a graph output was written to
                # its host-visible buffer (a run_* parameter), not to a
                # spill_* staging buffer — read whichever buffer the
                # next kernel call actually receives
                b = math.ceil(src.values[v].total_bits / 8)
                lines.append(f"  dma_read_async({ref(v)}, {b});")
            lines.append("  dma_join();")
    lines.append("}")
    lines.append("")
    return "\n".join(lines)
