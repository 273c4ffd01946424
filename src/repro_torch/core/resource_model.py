"""MING resource & latency estimation (paper contribution C3).

Two halves:

* :class:`FpgaResourceModel` — the paper-faithful model: BRAM18K blocks,
  DSP slices with *integer-arithmetic aware* packing (the paper's claim of
  higher accuracy vs. StreamHLS comes precisely from modeling int8 DSP
  packing and BRAM18K granularity), and the cycle estimate
  ``II * ceil(trip/unroll) + depth`` summed over dataflow nodes.

* :class:`HopperSpec` — data-sheet constants of the NVIDIA H100 the
  runtime executes on (SM count, shared memory per block, L2, device
  memory size and rate); ``dse.plan_conv_rows`` sizes the streaming conv
  kernel's shared-memory working set against it.

Three *execution modes* reproduce the paper's comparison frameworks:
``VANILLA`` (materialize everything, no unroll — Vitis auto baseline),
``MATERIALIZED_DATAFLOW`` (StreamHLS-like: task pipelining + unroll, but
intermediates and reorder copies materialized, WAR hazards ⇒ II=2) and
``STREAMING`` (MING: line buffers only, hazard-free II=1).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

from .analysis import KernelClass
from .ir import DFG, GenericOp, PAYLOAD_COSTS, PayloadKind
from .streaming import NodePlan, StreamingPlan

# ---------------------------------------------------------------------------
# FPGA constants (Kria KV260 per the paper's evaluation)
# ---------------------------------------------------------------------------

BRAM18K_BITS = 18_432          # one RAM18K block stores up to 18,432 bits
KV260_BRAM18K = 288
KV260_DSP = 1_248
#: Zynq UltraScale+ ZU3EG (Ultra96-class edge part): BRAM-richer but far
#: DSP-poorer than the KV260's K26 — 216 BRAM36 (= 432 RAM18K) vs 360
#: DSP48E2.  The multi-target sweep's second budget point: designs that
#: partition on the KV260 for BRAM often fit the ZU3EG whole but unroll
#: ~3.5× narrower.
ZU3EG_BRAM18K = 432
ZU3EG_DSP = 360
#: arrays at or below this size are mapped to LUTRAM by Vitis, not BRAM
LUTRAM_THRESHOLD_BITS = 1_024
#: DRAM bandwidth in bytes per fabric cycle (KV260 DDR4 ≈ 19 GB/s at a
#: 300 MHz fabric clock ⇒ ~64 B/cycle; derated to a conservative
#: streaming-access figure).  Charged for layer-group spills *and* for
#: partial weight streaming's tile traffic.
DRAM_BYTES_PER_CYCLE = 16
#: one AXI DMA burst: the granularity at which a group-boundary fill can
#: start trailing the previous group's spill write through DRAM.
DRAM_BURST_BYTES = 4_096


def transition_cycles(write_bytes: int, read_bytes: int) -> int:
    """Cycles for one layer-group boundary's DRAM traffic, with the
    spill write of group *k* overlapped against the fill of group *k+1*.

    The successor's read streams one DMA burst behind the predecessor's
    write, so the bus time is ``max(write, read)`` plus the *exposed
    tail* — the trailing burst the read cannot hide, capped by the
    smaller transfer (a sub-burst boundary degenerates to the serial
    sum, never worse than it).  A one-sided boundary (nothing to read
    back, or nothing written) has no overlap partner and pays its own
    transfer in full.
    """
    w = math.ceil(write_bytes / DRAM_BYTES_PER_CYCLE)
    r = math.ceil(read_bytes / DRAM_BYTES_PER_CYCLE)
    if w == 0 or r == 0:
        return w + r
    tail = math.ceil(DRAM_BURST_BYTES / DRAM_BYTES_PER_CYCLE)
    return max(w, r) + min(tail, w, r)


class ExecMode(str, enum.Enum):
    VANILLA = "vanilla"
    MATERIALIZED_DATAFLOW = "materialized_dataflow"   # StreamHLS-like
    STREAMING = "streaming"                            # MING


def dsp_per_mult(bits: int) -> float:
    """DSP48E2 cost of one multiply at a given integer width.

    int8 multiplies pack two-per-DSP when operands share a port (the
    standard INT8 packing on Xilinx DSP48E2); int16 fits one; wider needs
    cascades.  This integer-awareness is what the paper's model adds over
    StreamHLS's float-centric count.
    """
    if bits <= 8:
        return 0.5
    if bits <= 18:
        return 1.0
    if bits <= 27:
        return 2.0
    return 4.0


#: DSPs consumed by address/index arithmetic per dataflow node (empirical
#: Vitis behaviour; visible in the paper's Vanilla column: 1 MAC ⇒ 5 DSP).
ADDR_DSP_OVERHEAD = 4


def bram_blocks(bits: int, partitions: int = 1) -> int:
    """BRAM18K blocks for an array of ``bits`` split into ``partitions``.

    Each partition is a separate physical array: partitions at or below
    the LUTRAM threshold synthesize to distributed RAM (0 BRAM); larger
    ones round up to whole RAM18K blocks — the granularity loss under
    ARRAY_PARTITION is why unrolling inflates BRAM (paper Sec. V on
    StreamHLS's partition-driven BRAM growth)."""
    if bits <= 0:
        return 0
    per = math.ceil(bits / max(partitions, 1))
    if per <= LUTRAM_THRESHOLD_BITS:
        return 0
    return partitions * math.ceil(per / BRAM18K_BITS)


@dataclass
class NodeEstimate:
    name: str
    cycles: int
    dsp: int
    bram: int
    macs: int
    fill: int = 0   # cycles until first output (FIFO sizing / pipeline fill)


@dataclass
class GraphEstimate:
    mode: ExecMode
    nodes: list[NodeEstimate]
    #: BRAM18K blocks consumed by inter-process stream FIFOs (STREAMING
    #: mode only — materialized modes pass arrays, not streams)
    fifo_bram: int = 0

    @property
    def cycles(self) -> int:
        # paper Sec. IV-C: total execution cycles estimated as the sum of
        # individual node latencies (the DSE objective of Eq. (1)).
        return sum(n.cycles for n in self.nodes)

    @property
    def pipeline_cycles(self) -> int:
        """What the HLS report shows for a DATAFLOW region: concurrent
        stages, total ≈ slowest stage + downstream fill latencies.  Used
        for Table II comparisons; ``cycles`` stays the DSE objective."""
        if self.mode == ExecMode.VANILLA:
            return self.cycles  # vanilla has no task pipelining
        slowest = max(n.cycles for n in self.nodes)
        fills = sum(n.fill for n in self.nodes)
        return slowest + fills

    @property
    def dsp(self) -> int:
        return sum(n.dsp for n in self.nodes)

    @property
    def bram(self) -> int:
        return sum(n.bram for n in self.nodes) + self.fifo_bram

    @property
    def macs(self) -> int:
        return sum(n.macs for n in self.nodes)


class FpgaResourceModel:
    """Static estimator — never re-runs 'synthesis' (contribution C3)."""

    def __init__(
        self,
        *,
        war_ii: int = 2,
        vanilla_node_overhead_frac: float = 0.2,
    ) -> None:
        self.war_ii = war_ii
        self.vanilla_node_overhead_frac = vanilla_node_overhead_frac

    # -- per-node cycle/resource estimates -----------------------------------

    def node_cycles(
        self, plan: NodePlan, unroll: int, ii: int, weight_tiles: int = 1
    ) -> int:
        loops = plan.loops
        body = ii * math.ceil(loops.total_trip / max(unroll, 1))
        if (
            plan.kernel_class == KernelClass.SLIDING_WINDOW
            and plan.op.payload == PayloadKind.MAC
            and plan.info.stride > 1
        ):
            # a strided conv emits fewer windows than it ingests rows:
            # the MAC trip count (over *output* positions) undercounts
            # the cycles the node spends consuming its input stream, so
            # the node can never beat the ingest rate.  Recover the
            # streamed-input element count from the maps (the composite
            # subscripts span s*(P-1)+δ*(R-1)+1 input positions) and
            # floor the body at one element-vector per II cycles.
            op = plan.op
            smap = next(
                (m for m in op.input_maps
                 if any(not e.is_single_dim() for e in m.results)),
                None,
            )
            if smap is not None:
                in_elems = 1
                for expr in smap.results:
                    par = red = None
                    if not expr.is_single_dim() and expr.const == 0:
                        for d, c in expr.terms:
                            if op.is_parallel_dim(d):
                                par = (d, c)
                            else:
                                red = (d, c)
                    if par is not None and red is not None:
                        in_elems *= (
                            par[1] * (op.dim_extent(par[0]) - 1)
                            + red[1] * (op.dim_extent(red[0]) - 1) + 1
                        )
                    else:
                        in_elems *= op.dim_extent(expr.terms[0][0])
                body = max(body, ii * math.ceil(in_elems / max(unroll, 1)))
        cyc = body + loops.pipeline_depth
        if weight_tiles > 1:
            # partial weight streaming: the const buffer is tiled along
            # the output-channel axis and double-buffered from DRAM.
            # Charge the DRAM round-trip for the full weight set (each
            # tile crosses the bus once per inference; 2× for the
            # write/read pair, matching the spill model) plus one
            # pipeline restart per tile pass.
            const_bytes = math.ceil(plan.const_buffer_bits / 8)
            cyc += math.ceil(2 * const_bytes / DRAM_BYTES_PER_CYCLE)
            cyc += (weight_tiles - 1) * loops.pipeline_depth
        return cyc

    def node_dsp(self, plan: NodePlan, unroll: int) -> int:
        mults, adds = PAYLOAD_COSTS[plan.op.payload]
        # fused epilogue ops run once per output element on the stream-exit
        # datapath: multiplies there need DSPs (one instance, not scaled by
        # the reduction unroll), adds/compares go to LUT fabric.  An AVG
        # entry's DIV exit path counts as one multiply (Vitis lowers
        # division by a compile-time constant to multiply+shift).
        epi = sum(PAYLOAD_COSTS[e.kind][0] for e in plan.op.epilogue)
        epi_dsp = math.ceil(epi * dsp_per_mult(plan.op.elem_bits)) if epi else 0
        if plan.op.payload == PayloadKind.AVG:
            # standalone avg pool: the window accumulates are LUT adders
            # (like ADD/MAX), and the DIV exit path is ONE divider
            # instance regardless of unroll — the same single
            # constant-reciprocal multiply the fused-epilogue form is
            # charged, so fusing never changes the modeled DSP cost.
            return epi_dsp + math.ceil(dsp_per_mult(plan.op.elem_bits))
        if mults == 0:
            # pure adds/max/relu synthesize to LUT fabric — no DSP, and no
            # DSP-based address arithmetic either (paper Vanilla column:
            # Conv+ReLU shows 5 DSP ⇒ the ReLU node contributes none).
            return epi_dsp
        per_point = mults * dsp_per_mult(plan.op.elem_bits)
        return math.ceil(per_point * unroll) + ADDR_DSP_OVERHEAD + epi_dsp

    def stream_fifo_blocks(self, plan: StreamingPlan) -> int:
        """BRAM18K blocks for the inter-process FIFOs of a streaming plan.

        Like the line buffers, dataflow FIFOs are explicitly BRAM-bound
        (Vitis implements hls::stream channels between DATAFLOW processes
        as BRAM FIFOs unless forced to SRL), so every internal channel
        costs at least one RAM18K; deep diamond-absorbing FIFOs round up
        by capacity.  Host-boundary streams are AXI-stream ports, not
        on-fabric FIFOs — they are not charged.  This is the term operator
        fusion attacks: a fused consumer's FIFO disappears outright.
        """
        blocks = 0
        for s in plan.streams.values():
            if s.producer is None or s.consumer is None:
                continue
            blocks += max(1, math.ceil(s.depth * s.elem_bits / BRAM18K_BITS))
        return blocks

    def node_bram_streaming(
        self, plan: NodePlan, unroll: int, width: int = 1, weight_tiles: int = 1
    ) -> int:
        """MING: line buffer + window buffer only.

        The line buffer is partitioned by the *stream width* (lanes that
        read/write it concurrently), not the full unroll product: unrolling
        the reduction loops reads the (register-resident, fully partitioned)
        window buffer, not the line buffer.  Line buffers are explicitly
        BRAM-bound (``BIND_STORAGE impl=bram``, Sec. III-C) so each lane
        slice costs ≥1 RAM18K regardless of the LUTRAM threshold — this is
        what produces the paper's constant 16-per-conv BRAM signature.
        Window/weight buffers are completely partitioned → registers.

        ``weight_tiles > 1`` (partial weight streaming): only one
        ``1/weight_tiles`` slice of the const buffer is resident, double
        buffered (ping + pong) so the next tile's DRAM fetch overlaps the
        current tile's compute — 2× tile BRAM instead of the full set."""
        blocks = 0
        if plan.line_buffer_bits > 0:
            lanes = max(width, 1)
            per = math.ceil(plan.line_buffer_bits / lanes)
            blocks += lanes * max(1, math.ceil(per / BRAM18K_BITS))
        # window buffer: completely partitioned → registers (per-partition
        # size below the LUTRAM threshold by construction)
        blocks += bram_blocks(
            plan.window_buffer_bits, partitions=max(unroll, 1)
        )
        if weight_tiles > 1:
            tile_bits = math.ceil(plan.const_buffer_bits / weight_tiles)
            blocks += 2 * bram_blocks(tile_bits, partitions=max(unroll, 1))
        else:
            blocks += bram_blocks(plan.const_buffer_bits, partitions=max(unroll, 1))
        return blocks

    def node_bram_materialized(
        self, plan: NodePlan, dfg: DFG, unroll: int, reorder_copy: bool
    ) -> int:
        """Vanilla / StreamHLS: the node's *output tensor* is allocated in
        BRAM (plus a reorder copy for the StreamHLS-like mode, Fig. 2a)."""
        out = dfg.values[plan.op.output]
        blocks = bram_blocks(out.total_bits, partitions=max(unroll, 1))
        if reorder_copy:
            blocks *= 2
        blocks += bram_blocks(plan.const_buffer_bits, partitions=max(unroll, 1))
        return blocks

    # -- whole-graph estimates -------------------------------------------------

    def estimate(
        self,
        plan: StreamingPlan,
        mode: ExecMode,
        unrolls: dict[str, int] | None = None,
        widths: dict[str, int] | None = None,
        weight_tiles: dict[str, int] | None = None,
    ) -> GraphEstimate:
        from .streaming import _first_output_cycles  # cycle-free import

        unrolls = unrolls or {}
        widths = widths or {}
        weight_tiles = weight_tiles or {}
        dfg = plan.dfg
        nodes: list[NodeEstimate] = []
        graph_input_bits = sum(dfg.values[g].total_bits for g in dfg.graph_inputs)
        first = True
        for np_ in plan.node_order():
            u = unrolls.get(np_.name, 1)
            w = widths.get(np_.name, 1)
            fill = _first_output_cycles(np_)
            if mode == ExecMode.VANILLA:
                ii = 1
                cyc = self.node_cycles(np_, 1, ii)
                cyc = int(cyc * (1 + self.vanilla_node_overhead_frac))
                dsp = self.node_dsp(np_, 1)
                bram = self.node_bram_materialized(np_, dfg, 1, reorder_copy=False)
                if first:
                    bram += bram_blocks(graph_input_bits)  # input staged in BRAM
            elif mode == ExecMode.MATERIALIZED_DATAFLOW:
                ii = self.war_ii  # WAR hazards block II=1 (paper Sec. V)
                cyc = self.node_cycles(np_, u, ii)
                dsp = self.node_dsp(np_, u)
                bram = self.node_bram_materialized(np_, dfg, u, reorder_copy=True)
            else:  # STREAMING — MING
                ii = 1
                t = weight_tiles.get(np_.name, 1)
                cyc = self.node_cycles(np_, u, ii, weight_tiles=t)
                dsp = self.node_dsp(np_, u)
                bram = self.node_bram_streaming(np_, u, w, weight_tiles=t)
                fill = max(1, fill // max(w, 1))
            nodes.append(
                NodeEstimate(np_.name, cyc, dsp, bram, np_.op.macs(), fill)
            )
            first = False
        fifo = (
            self.stream_fifo_blocks(plan) if mode == ExecMode.STREAMING else 0
        )
        return GraphEstimate(mode, nodes, fifo_bram=fifo)


# ---------------------------------------------------------------------------
# NVIDIA H100 (Hopper) device description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HopperSpec:
    """Data-sheet constants of one NVIDIA H100 SXM card (NVIDIA's H100
    data sheet and the Hopper architecture white paper) — nothing here
    is measured.  Used by ``dse.plan_conv_rows`` to size the streaming
    conv kernel's shared-memory working set."""

    sms: int = 132                         # streaming multiprocessors
    smem_per_block: int = 232_448          # 227 KB usable by one block
    l2_bytes: int = 50 * 1000 * 1000       # 50 MB L2 cache
    hbm_bytes: int = 80 * 1000**3          # 80 GB device memory
    hbm_bw: float = 3.35e12                # B/s
    peak_fp32_flops: float = 67e12         # FLOP/s outside tensor cores


H100 = HopperSpec()
