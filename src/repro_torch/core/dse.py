"""MING lightweight DSE (paper Sec. IV-C, Eq. (1)).

The ILP::

    min   Σ_v Cycles(v)                       (objective: sum of node latencies)
    s.t.  u_ℓ | trip(ℓ)                       (unroll divisibility)
          Σ u_ℓ η_ℓd ≤ D_total                (DSP budget)
          Σ u_ℓ η_ℓb ≤ B_total                (BRAM budget)
          κ_src(s),s = κ_dst(s),s             (stream width consistency)

is solved *exactly* with branch-and-bound over divisor lattices — the
paper's point is that streaming collapses the design space enough that a
lightweight solver suffices; we lean on the same property (candidate sets
are divisor lists, typically a few dozen entries per node).

The decision variable is one unroll factor per dataflow node.  Reduction
loops unroll first (they add MACs/cycle without widening streams); once a
node's reduction trips are fully unrolled, further factors widen the
parallel (stream) loops.  The resulting *stream width* ``κ`` must agree
across every producer/consumer pair — Eq. (1)'s stream constraint.

``plan_conv_rows``, ``plan_attention_blocks``, ``plan_mlp_blocks`` and
``plan_ssd_blocks`` are the runtime's counterparts on the NVIDIA H100:
the same question (what fits the on-chip buffer?) asked of a thread
block's shared memory and registers; their outputs tile the streaming
conv, flash-attention, fused-MLP and SSD kernels.  The backwards'
planners (``plan_attn_bwd_blocks``, ``plan_mlp_bwd_blocks``,
``plan_ssd_bwd_blocks``) also pick each one's route.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional

from .resource_model import (
    ExecMode,
    FpgaResourceModel,
    GraphEstimate,
    KV260_BRAM18K,
    KV260_DSP,
    H100,
    HopperSpec,
)
from .streaming import NodePlan, StreamingPlan


def divisors(n: int, cap: int | None = None) -> list[int]:
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    out.sort()
    if cap is not None:
        out = [d for d in out if d <= cap]
    return out


# ---------------------------------------------------------------------------
# Node-level unroll semantics
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UnrollChoice:
    """One candidate unroll factor for a node, with derived quantities.

    ``weight_tiles > 1`` marks a partial-weight-streaming variant: the
    const buffer is split into that many output-channel tiles, double
    buffered from DRAM — less BRAM, more cycles (the DRAM round trip)."""

    unroll: int
    stream_width: int     # κ: parallel lanes on this node's streams
    dsp: int
    bram: int
    cycles: int
    weight_tiles: int = 1


def _reduction_trip(plan: NodePlan) -> int:
    op = plan.op
    r = 1
    for d in plan.info.classes.reduction:
        r *= op.dim_extent(d)
    return max(r, 1)


def _parallel_trip(plan: NodePlan) -> int:
    """Product of the *unrollable* parallel dims only.

    Sliding spatial (window) dims are never unrolled — replicating the
    sliding loops would break the streaming arrival order (Sec. IV-B's
    point about polyhedral reordering) — so the widening budget is the
    channel-like parallel dims (e.g. c_out), matching the paper's DSP
    ladder (Table II: conv unroll ≈ K·K·C_in · C_out)."""
    op = plan.op
    window = set(plan.info.classes.window)
    p = 1
    for d in op.parallel_dims:
        if d not in window:
            p *= op.dim_extent(d)
    return max(p, 1)


def node_candidates(
    plan: NodePlan,
    model: FpgaResourceModel,
    d_total: int,
    max_unroll: int = 4096,
    *,
    weight_streaming: bool = False,
) -> list[UnrollChoice]:
    """Enumerate legal unroll factors for one node (Unroll Constr.),
    STREAMING mode (II=1, line-buffer BRAM only).

    Factors are products r*p with r | reduction_trip and p | parallel_trip;
    the stream width is p (reduction unrolling does not widen streams).

    ``weight_streaming=True`` additionally enumerates partial-weight-
    streaming variants (weight_tiles > 1 along the const-indexed output
    channels, stream width pinned to 1): strictly slower than their
    resident-weight twins, but the only shapes that fit when the weights
    alone approach the BRAM budget.
    """
    red = _reduction_trip(plan)
    par = _parallel_trip(plan)
    tileable = plan.weight_tileable_extent
    tile_opts = [1]
    if weight_streaming and tileable > 1 and plan.const_buffer_bits > 0:
        tile_opts += [t for t in divisors(tileable) if t > 1]
    choices: dict[tuple[int, int], UnrollChoice] = {}
    for t in tile_opts:
        for r in divisors(red, cap=max_unroll):
            for p in divisors(par, cap=max(max_unroll // r, 1)):
                u = r * p
                if u > max_unroll:
                    continue
                # widening streams before exhausting the reduction wastes
                # DSPs feeding idle lanes — prune dominated shapes
                if p > 1 and r != red:
                    continue
                # a streamed weight tile feeds one lane; widening the
                # stream would demand concurrent tiles (defeats the point)
                if t > 1 and p > 1:
                    continue
                cyc = model.node_cycles(plan, u, ii=1, weight_tiles=t)
                dsp = model.node_dsp(plan, u)
                if dsp > d_total:
                    continue
                bram = model.node_bram_streaming(plan, u, width=p, weight_tiles=t)
                prev = choices.get((u, t))
                cand = UnrollChoice(u, p, dsp, bram, cyc, weight_tiles=t)
                if prev is None or cand.cycles < prev.cycles:
                    choices[(u, t)] = cand
    return sorted(choices.values(), key=lambda c: (c.unroll, c.weight_tiles))


# ---------------------------------------------------------------------------
# Exact branch-and-bound ILP solver
# ---------------------------------------------------------------------------


@dataclass
class DseResult:
    unrolls: dict[str, int]
    stream_widths: dict[str, int]
    estimate: GraphEstimate
    objective_cycles: int
    dsp_used: int
    bram_used: int
    feasible: bool
    explored: int = 0
    #: nodes mapped with partial weight streaming (node -> tile count > 1)
    weight_tiles: dict[str, int] = field(default_factory=dict)


def solve_ilp(
    plan: StreamingPlan,
    *,
    options=None,
    d_total: int | None = None,
    b_total: int | None = None,
    model: FpgaResourceModel | None = None,
    max_unroll: int | None = None,
    weight_streaming: bool = False,
) -> DseResult:
    """Solve Eq. (1) exactly for the STREAMING (MING) mode.

    ``options`` (a :class:`repro_torch.core.CompileOptions`, duck-typed here
    to keep ``core.dse`` import-light) supplies the budgets, resource
    model, and unroll cap from its target — the same bundle the driver
    and the partition DP consume, so a caller never has to unpack the
    knobs positionally.  ``weight_streaming`` stays a per-solve flag:
    the partitioner flips it per slice (see below), independent of the
    bundle's policy.

    Inter-process FIFO BRAM (see
    :meth:`FpgaResourceModel.stream_fifo_blocks`) is assignment-independent
    and charged as a fixed overhead against ``b_total`` — fusing nodes
    (``repro_torch.passes``) shrinks it before the solver ever runs.

    ``weight_streaming=True`` lets the candidate sets include partial
    weight streaming (see :func:`node_candidates`).  Off by default:
    streamed designs are strictly slower than their resident twins, so
    admitting them unconditionally would make *every* graph "feasible"
    and erase the partitioning signal.  The partitioner re-solves with
    it for any slice whose resident plan is over budget — that makes
    streamed groups a first-class choice its DP prices against cutting
   , while graphs that fit resident never pick up tiles.
    """
    if options is not None:
        if any(v is not None for v in (d_total, b_total, model, max_unroll)):
            raise ValueError(
                "pass either options=CompileOptions(...) or the loose "
                "d_total/b_total/model/max_unroll kwargs, not both"
            )
        tgt = options.target
        d_total, b_total = tgt.d_total, tgt.b_total
        model = tgt.model()
        max_unroll = options.resolved_max_unroll
    d_total = KV260_DSP if d_total is None else d_total
    b_total = KV260_BRAM18K if b_total is None else b_total
    max_unroll = 4096 if max_unroll is None else max_unroll
    model = model or FpgaResourceModel()
    nodes = plan.node_order()
    fifo_bram = model.stream_fifo_blocks(plan)
    b_nodes = b_total - fifo_bram
    cand: dict[str, list[UnrollChoice]] = {
        n.name: node_candidates(
            n, model, d_total, max_unroll, weight_streaming=weight_streaming
        )
        for n in nodes
    }

    def _infeasible(explored: int = 0) -> DseResult:
        unrolls = {n.name: 1 for n in nodes}
        est = model.estimate(plan, ExecMode.STREAMING, unrolls)
        return DseResult(unrolls, dict(unrolls), est, est.cycles,
                         est.dsp, est.bram, feasible=False, explored=explored)

    if any(not cs for cs in cand.values()) or b_nodes < 0:
        return _infeasible()

    # stream adjacency: consumer -> producers already placed (topo order)
    producers_of: dict[str, list[str]] = {n.name: [] for n in nodes}
    for s in plan.streams.values():
        if s.producer and s.consumer:
            producers_of[s.consumer].append(s.producer)

    order = [n.name for n in nodes]
    best: dict = {"cycles": math.inf, "assign": None, "explored": 0}
    # optimistic per-node lower bounds for pruning: cycles drive the
    # branch-and-bound incumbent check, bram/dsp prove infeasibility of a
    # partial assignment without enumerating its subtree (this is what
    # makes "the whole graph provably does not fit" cheap enough for the
    # layer-group partitioner to probe prefixes with).
    suffix_cycles = [0] * (len(order) + 1)
    suffix_bram = [0] * (len(order) + 1)
    suffix_dsp = [0] * (len(order) + 1)
    for i in range(len(order) - 1, -1, -1):
        cs = cand[order[i]]
        suffix_cycles[i] = suffix_cycles[i + 1] + min(c.cycles for c in cs)
        suffix_bram[i] = suffix_bram[i + 1] + min(c.bram for c in cs)
        suffix_dsp[i] = suffix_dsp[i + 1] + min(c.dsp for c in cs)

    if suffix_bram[0] > b_nodes or suffix_dsp[0] > d_total:
        return _infeasible()

    def recurse(
        i: int, assign: dict[str, UnrollChoice], dsp: int, bram: int, cycles: int
    ) -> None:
        best["explored"] += 1
        if cycles + suffix_cycles[i] >= best["cycles"]:
            return
        if i == len(order):
            best["cycles"] = cycles
            best["assign"] = dict(assign)
            return
        name = order[i]
        # stream constraint: κ must equal every already-placed producer's κ
        widths = {assign[p].stream_width for p in producers_of[name] if p in assign}
        for choice in cand[name]:
            if widths and choice.stream_width not in widths:
                continue
            if dsp + choice.dsp + suffix_dsp[i + 1] > d_total:
                continue
            if bram + choice.bram + suffix_bram[i + 1] > b_nodes:
                continue
            assign[name] = choice
            recurse(i + 1, assign, dsp + choice.dsp, bram + choice.bram,
                    cycles + choice.cycles)
            del assign[name]

    recurse(0, {}, 0, 0, 0)

    if best["assign"] is None:
        # infeasible under the budgets — report unroll=1 estimate
        return _infeasible(best["explored"])

    assign: dict[str, UnrollChoice] = best["assign"]
    unrolls = {n: c.unroll for n, c in assign.items()}
    tiles = {n: c.weight_tiles for n, c in assign.items() if c.weight_tiles > 1}
    est = model.estimate(
        plan, ExecMode.STREAMING, unrolls,
        widths={n: c.stream_width for n, c in assign.items()},
        weight_tiles=tiles,
    )
    return DseResult(
        unrolls=unrolls,
        stream_widths={n: c.stream_width for n, c in assign.items()},
        estimate=est,
        objective_cycles=sum(c.cycles for c in assign.values()),
        dsp_used=sum(c.dsp for c in assign.values()),
        bram_used=sum(c.bram for c in assign.values()) + fifo_bram,
        feasible=True,
        explored=best["explored"],
        weight_tiles=tiles,
    )


def solve_materialized(
    plan: StreamingPlan,
    *,
    d_total: int = KV260_DSP,
    b_total: int | None = None,
    model: FpgaResourceModel | None = None,
) -> DseResult:
    """StreamHLS-like DSE: unroll under the DSP budget only (the paper's
    observation: StreamHLS's DSE tracks DSPs but not BRAM, which is what
    lets its designs blow past edge BRAM limits)."""
    model = model or FpgaResourceModel()
    unrolls: dict[str, int] = {}
    widths: dict[str, int] = {}
    budget = d_total
    for np_ in plan.node_order():
        red = _reduction_trip(np_)
        # greedy: largest reduction-unroll fitting the remaining DSP budget
        u = 1
        for cand_u in divisors(red):
            dsp = model.node_dsp(np_, cand_u)
            if dsp <= max(budget, 0):
                u = cand_u
        budget -= model.node_dsp(np_, u)
        unrolls[np_.name] = u
        widths[np_.name] = 1
    est = model.estimate(plan, ExecMode.MATERIALIZED_DATAFLOW, unrolls)
    feasible = b_total is None or est.bram <= b_total
    return DseResult(unrolls, widths, est, est.cycles, est.dsp, est.bram,
                     feasible=feasible)


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the streaming conv kernel under the
# shared-memory budget of one thread block
# ---------------------------------------------------------------------------

#: register tiles of the streaming conv kernel (output pixels along W ×
#: output channels per thread), instantiated in
#: ``kernels/csrc/conv2d_stream.cu``.  8 × 8 (64 accumulators) makes 10
#: shared-memory loads per 64 multiply-adds, where a 4 × 4 tile makes 5
#: per 16; the smaller tiles spread convs whose outputs are too few for
#: 8 × 8 tiles to fill the card.  8 × 8 runs streamed only
CONV_TILES = ((8, 8), (4, 4), (2, 4))
#: most threads a block may have: one register tile per thread per step,
#: so every thread of a block has work; at 64 accumulators a thread stays
#: under 128 registers, so two blocks of 256 share an SM
CONV_BLOCK_THREADS = 256
#: Cin channels per chunk of the K loop.  A constant, never the plan's:
#: every output's sum runs chunk by chunk, then (kh, kw, ci) within the
#: chunk, so float results are bit-identical across plans
CONV_CIN_CHUNK = 8
#: pixel pitch (32-bit words) of a streamed input slab: 16-byte pixels for
#: ``cp.async``, and 12 words apart put eight neighbouring pixels on eight
#: bank groups
CONV_CHUNK_PITCH = 12
#: shared-memory stages of the streamed route (weights and input slab of
#: one Cin chunk each): the next chunk loads while this one computes; at
#: two, a 252-thread block of the 224²×136 conv takes 67 KB, so two
#: blocks share an SM
CONV_STAGES = 2
#: Cin chunks one streamed stage may hold: a group changes no sum's
#: order, it only spends one barrier and one wait on several chunks
CONV_STAGE_CHUNKS = (1, 2, 4, 8)
#: shared memory of one SM (228 KB) less the 1 KB each block reserves,
#: split between two blocks: a plan within it leaves room for a second
#: block on the SM
CONV_TWO_BLOCKS_SMEM = 228 * 1024 // 2 - 1024


@dataclass
class ConvBlockPlan:
    """Chosen tiling of one streaming-conv launch.

    ``blocks``: ``rows`` (output rows per band — what one block walks),
    ``rows_step`` (output rows a step: one register tile each per
    thread), ``w_tile`` / ``c_tile`` (output columns / channels per
    block), ``tile_pixels`` × ``tile_channels`` (the register tile),
    ``threads`` (one per register tile of a step, ``rows_step ·
    w_tile/tile_pixels · c_tile/tile_channels``; a one-wave resident
    block has ``CONV_BLOCK_THREADS``, the spare ones only loading),
    ``streamed`` (weights and input in Cin chunks through a ring of
    stages; else the whole weight tile and every input channel stay
    resident) and ``stage_chunks`` (Cin chunks a streamed stage holds).
    ``smem_fill_bytes``: bytes the launch copies into shared memory
    (weights and input rows, halo rows and per-step weight reloads
    included; 32-bit elements)."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: tuple[int, int, int]
    smem_fill_bytes: int = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def conv_smem_bytes(*, kh: int, kw: int, c_in: int, stride: int,
                    rows_step: int, w_tile: int, c_tile: int,
                    streamed: bool, stage_chunks: int = 1) -> int:
    """Shared memory one block of the streaming conv kernel asks for, all
    widened to the 32-bit accumulate type (the formula of
    ``conv2d_stream.cu``).  Resident: the ``kh·kw·c_in·c_tile`` weight
    tile plus the ring of ``(rows_step-1)·stride + kh`` input rows of
    ``(w_tile-1)·stride + kw`` pixels, each ``c_in`` made odd wide.
    Streamed: ``CONV_STAGES`` stages of ``stage_chunks`` Cin chunks'
    weights and input slabs (pixels ``CONV_CHUNK_PITCH`` words apart)."""
    ring_rows = (rows_step - 1) * stride + kh
    slot_cols = (w_tile - 1) * stride + kw
    if streamed:
        return 4 * CONV_STAGES * stage_chunks * (
            kh * kw * CONV_CIN_CHUNK * c_tile
            + ring_rows * slot_cols * CONV_CHUNK_PITCH)
    return 4 * (kh * kw * c_in * c_tile + ring_rows * slot_cols * (c_in | 1))


def _conv_fill_bytes(*, batch: int, h_out: int, n_bands: int, band: int,
                     n_wt: int, n_ct: int, rows_step: int, w_tile: int,
                     c_tile: int, c_in: int, kh: int, kw: int, stride: int,
                     streamed: bool) -> int:
    """Bytes the launch copies into shared memory (4 per element)."""
    total = 0
    for band_i in range(n_bands):
        rows = min(band, h_out - band_i * band)
        steps = -(-rows // rows_step)
        slot_cols = (w_tile - 1) * stride + kw
        if streamed:
            ring_rows = (rows_step - 1) * stride + kh
            per_block = steps * (ring_rows * slot_cols * c_in
                                 + kh * kw * c_in * c_tile)
        else:
            in_rows = (rows - 1) * stride + kh
            per_block = in_rows * slot_cols * c_in + kh * kw * c_in * c_tile
        total += per_block
    return 4 * total * batch * n_wt * n_ct


def _conv_c_tile(c_out: int, tc: int, most: int) -> int:
    """Cout in the fewest channel tiles of at most ``most`` channels,
    each a whole number of ``tc``-channel register tiles."""
    n = -(-c_out // most)
    return _round_up(-(-c_out // n), tc)


def _conv_step(*, tp: int, cgs: int, h_cap: int, w_out: int, kh: int,
               kw: int, stride: int) -> tuple[int, int]:
    """(pixel groups along W, rows a step) with one register tile per
    thread: the most threads up to ``CONV_BLOCK_THREADS``, then the
    fewest input pixels a step reads per output pixel (its halo)."""
    best = None
    for pgs in range(1, min(16, -(-w_out // tp)) + 1):
        rs = max(1, min(h_cap, CONV_BLOCK_THREADS // (pgs * cgs)))
        halo = ((rs - 1) * stride + kh) * ((pgs * tp - 1) * stride + kw) \
            / (rs * pgs * tp)
        key = (-rs * pgs, halo)
        if best is None or key < best[0]:
            best = (key, pgs, rs)
    return best[1], best[2]


@functools.lru_cache(maxsize=4096)
def plan_conv_rows(
    *,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    kh: int,
    kw: int,
    stride: int = 1,
    batch: int = 1,
    rows: int | None = None,
    smem_budget: int | None = None,
    spec: HopperSpec = H100,
) -> ConvBlockPlan:
    """Tile the streaming conv kernel by four rules, the first that
    applies winning, each from tilings timed on the card (H100, PERF.md):

    1. **wide** — 8 × 8 tiles streamed, one Cin chunk a stage, Cout in
       tiles of at most 48 channels, where those blocks give every SM two
       (224²×136→136: 48 × 16 × 21 rows, 0.94 ms; 72- and 136-channel
       tiles 1.5-5 % slower; the resident 4 × 4 kernel before, 2.2 ms);
    2. **small** — a resident 4 × 4 tile (2 × 4 where 4 × 4 blocks
       would not give every SM one), Cout in tiles of at most 32
       channels, where the whole weight tile and ring leave room for a
       second block on the SM (the zoo: Cin 1-32; no pipeline to pay);
    3. **small and deep** — a spatial conv whose resident blocks of
       2 × 4 tiles (8 channels × the row, up to 32 pixels, × two rows)
       fit one block's shared memory and run in one wave: 256 threads
       each, those past the tiles only loading (16²×288→48: 0.09 ms, the
       same resident in other tilings 0.081-0.109, streamed 0.118-0.136);
    4. otherwise **streamed** 2 × 4 tiles, four Cin chunks a stage, 8
       pixels × two rows a step, Cout in tiles of at most 72 channels
       (16²×288→288: 0.143 ms, one chunk a stage 0.160, resident 0.26 in
       three waves; Dense layers of deep Cin), shrunk — chunks a stage,
       rows, pixels, channels — until it fits ``smem_budget``.

    In rules 1-2 the step has one thread per register tile, the most
    threads up to ``CONV_BLOCK_THREADS``, then the least halo.  The band
    (``rows``) starts at the whole frame — each input row read once —
    and halves while the launch would leave SMs idle; ``rows`` pins it
    (results never depend on it).  Raises :class:`ValueError` when not
    even rule 4's smallest tile fits.  Plans are memoized per shape (the
    conv wrapper asks on a shape's first call); treat the returned plan
    as read-only.
    """
    budget = smem_budget or spec.smem_per_block
    cap = h_out if rows is None else max(1, min(rows, h_out))
    two_blocks = min(budget, CONV_TWO_BLOCKS_SMEM)
    n_chunks = -(-c_in // CONV_CIN_CHUNK)

    def plan(tile, c_tile, pgs, rs, streamed, stage_chunks=1, threads=None):
        tp, tc = tile
        w_tile = pgs * tp
        n_wt, n_ct = -(-w_out // w_tile), -(-c_out // c_tile)
        if rows is not None:
            band = cap
        else:
            band = _round_up(h_out, rs)
            others = batch * n_wt * n_ct
            while band > rs and others * -(-h_out // band) < 2 * spec.sms:
                band = max(rs, _round_up(-(-band // 2), rs))
        smem = conv_smem_bytes(kh=kh, kw=kw, c_in=c_in, stride=stride,
                               rows_step=rs, w_tile=w_tile, c_tile=c_tile,
                               streamed=streamed, stage_chunks=stage_chunks)
        fill = _conv_fill_bytes(
            batch=batch, h_out=h_out, n_bands=-(-h_out // band), band=band,
            n_wt=n_wt, n_ct=n_ct, rows_step=rs, w_tile=w_tile, c_tile=c_tile,
            c_in=c_in, kh=kh, kw=kw, stride=stride, streamed=streamed)
        return ConvBlockPlan(
            "conv_rows",
            dict(rows=band, rows_step=rs, w_tile=w_tile, c_tile=c_tile,
                 tile_pixels=tp, tile_channels=tc,
                 threads=threads or rs * pgs * (c_tile // tc),
                 streamed=streamed, stage_chunks=stage_chunks),
            smem, (n_wt * n_ct, -(-h_out // band), batch), fill)

    def stepped(tile, most, streamed):
        c_tile = _conv_c_tile(c_out, tile[1], most)
        pgs, rs = _conv_step(tp=tile[0], cgs=c_tile // tile[1], h_cap=cap,
                             w_out=w_out, kh=kh, kw=kw, stride=stride)
        return plan(tile, c_tile, pgs, rs, streamed)

    def blocks(p):
        gx, gy, gz = p.grid
        return gx * gy * gz

    wide = stepped((8, 8), 48, True)                                 # 1
    if wide.smem_bytes <= two_blocks and blocks(wide) >= 2 * spec.sms:
        return wide
    for tile in ((4, 4), (2, 4)):                                    # 2
        small = stepped(tile, 32, False)
        if small.smem_bytes <= two_blocks and (
                tile == (2, 4) or blocks(small) >= spec.sms):
            return small
    if kh * kw > 1:                                                  # 3
        deep = plan((2, 4), 8, min(16, -(-w_out // 2)), min(2, cap), False,
                    threads=CONV_BLOCK_THREADS)
        if deep.smem_bytes <= budget and blocks(deep) <= spec.sms:
            return deep
    c_tile = _conv_c_tile(c_out, 4, 72)                              # 4
    pgs, rs, g = min(4, -(-w_out // 2)), min(2, cap), 4
    while g > 1 and g // 2 >= n_chunks:
        g //= 2
    while True:
        p = plan((2, 4), c_tile, pgs, rs, True, g)
        if p.smem_bytes <= budget:
            return p
        if g > 1:
            g //= 2
        elif rs > 1:
            rs = 1
        elif pgs > 1:
            pgs //= 2
        elif c_tile > 4:
            c_tile = 4
        else:
            raise ValueError(
                f"conv {kh}x{kw}x{c_in}->{c_out}: the smallest tile "
                f"({p.smem_bytes} B) exceeds the shared-memory budget "
                f"({budget} B)")


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the flash-attention kernel
# ---------------------------------------------------------------------------

#: keys per shared-memory tile, both routes of
#: ``kernels/csrc/flash_attention.cu``
ATTN_BLOCK_K = 64
#: f32 route (CUDA cores): 256 threads as a 16 × 16 grid, each holding a
#: (block_q/16) × 4 tile of the score block and a (block_q/16) × (D/16)
#: tile of the output; the query tiles it is instantiated for, largest first
ATTN_BLOCK_Q = (64, 32)
#: bf16 route (tensor cores): 4 warps of 16 query rows; the head is padded
#: with zeros to the next of these widths (mma's k is 16)
ATTN_MMA_BLOCK_Q = 64
ATTN_MMA_HEAD_PADS = (16, 32, 64, 128)
#: widest head either route takes
ATTN_MAX_HEAD_DIM = 128
#: floats of padding after each shared-memory row of the f32 route (keeps
#: 16-byte vector loads aligned and spreads the transposed stores over the
#: banks)
ATTN_SMEM_PAD = 4
#: the bf16 route's row padding, in bf16 elements: 16 bytes put the eight
#: rows of one ``ldmatrix`` phase into eight bank groups
MMA_ROW_PAD = 8
#: f32 output accumulators a thread keeps at most, on either route
ATTN_ACC_REGS = 64


@dataclass
class AttentionBlockPlan:
    """Chosen tiling of one flash-attention launch: ``blocks`` holds
    ``block_q`` (query rows per block), ``block_k`` (keys per shared-
    memory tile) and ``head_pad`` (the head as the block holds it: the
    head itself on the f32 route, padded to a multiple of 16 on the bf16
    route); ``grid`` is the number of blocks."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int

    @property
    def acc_regs(self) -> int:
        """f32 output accumulators one thread keeps: a warp's 16 rows ×
        the padded head over 32 threads (bf16 route), or (block_q/16) ×
        the columns per thread (f32 route)."""
        b = self.blocks
        if self.kind == "attention_mma":
            return 16 * b["head_pad"] // 32
        return b["block_q"] // 16 * attention_cols_per_thread(b["head_pad"])


def attention_cols_per_thread(head_dim: int) -> int:
    """Output columns one thread of the f32 route keeps (the kernel's
    ``DPT``): 2, 4 or 8, so that 16 threads cover the head."""
    return 2 if head_dim <= 32 else 4 if head_dim <= 64 else 8


def attention_head_pad(head_dim: int) -> int:
    """The bf16 route's head width: the head padded with zeros to the
    first of ``ATTN_MMA_HEAD_PADS`` that holds it."""
    return next(w for w in ATTN_MMA_HEAD_PADS if w >= head_dim)


def attention_smem_bytes(*, head_dim: int, block_q: int) -> int:
    """Shared memory one block of the f32 route asks for, all in f32: the
    query tile and the key tile transposed (``D × (tile + pad)``), the
    value tile (``block_k × 16·DPT``) and the probability tile
    (``block_q × (block_k + pad)``) — the formula of
    ``flash_attention.cu``."""
    pad, bk = ATTN_SMEM_PAD, ATTN_BLOCK_K
    dv = 16 * attention_cols_per_thread(head_dim)
    return 4 * (head_dim * (block_q + pad) + head_dim * (bk + pad)
                + bk * dv + block_q * (bk + pad))


def attention_mma_smem_bytes(*, head_dim: int) -> int:
    """Shared memory one block of the bf16 route asks for, all bf16: the
    query tile and two stages of key and value tiles, each row the padded
    head plus ``MMA_ROW_PAD`` — the formula of ``flash_attention.cu``'s
    ``mma_smem_bytes``."""
    rows = ATTN_MMA_BLOCK_Q + 2 * 2 * ATTN_BLOCK_K
    return 2 * rows * (attention_head_pad(head_dim) + MMA_ROW_PAD)


# the largest tile at the widest head must fit one block's shared memory
# on both routes (119,808 B and 87,040 B of 232,448 B), so the planner
# never has to refuse a head the kernel takes
assert attention_smem_bytes(head_dim=ATTN_MAX_HEAD_DIM,
                            block_q=ATTN_BLOCK_Q[0]) <= H100.smem_per_block
assert attention_mma_smem_bytes(
    head_dim=ATTN_MAX_HEAD_DIM) <= H100.smem_per_block


@functools.lru_cache(maxsize=4096)
def plan_attention_blocks(
    *,
    seq_q: int,
    seq_k: int,
    head_dim: int,
    batch_heads: int = 1,
    dtype: str,
) -> AttentionBlockPlan:
    """Tile the flash-attention kernel on the H100: one block per
    (batch·head, query tile) loops over the keys ``ATTN_BLOCK_K`` at a
    time (every tile fits, see the asserts above).

    ``dtype`` ``"bfloat16"`` takes the tensor-core route: 64-row query
    tiles (4 warps of 16 rows), the head padded to a multiple of 16.
    Otherwise (f32, the CUDA cores) the largest query tile wins (each key
    tile loaded into shared memory then serves more query rows); it halves
    while the launch would leave SMs idle (fewer than two blocks per SM)
    or while it exceeds the queries there are.  Raises
    :class:`ValueError` for a head wider than ``ATTN_MAX_HEAD_DIM``.
    Plans are memoized per shape; treat them as read-only.
    """
    if not 1 <= head_dim <= ATTN_MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention: head_dim {head_dim} outside the kernel's "
            f"1..{ATTN_MAX_HEAD_DIM}")
    if seq_q < 1 or seq_k < 1 or batch_heads < 1:
        raise ValueError(
            f"flash attention: empty problem (seq_q {seq_q}, seq_k "
            f"{seq_k}, batch_heads {batch_heads})")
    if dtype == "bfloat16":
        bq = ATTN_MMA_BLOCK_Q
        return AttentionBlockPlan(
            "attention_mma",
            {"block_q": bq, "block_k": ATTN_BLOCK_K,
             "head_pad": attention_head_pad(head_dim)},
            attention_mma_smem_bytes(head_dim=head_dim),
            batch_heads * -(-seq_q // bq),
        )
    tiles = ATTN_BLOCK_Q
    i = 0
    while i + 1 < len(tiles) and (
            tiles[i + 1] >= seq_q
            or batch_heads * -(-seq_q // tiles[i]) < 2 * H100.sms):
        i += 1
    bq = tiles[i]
    return AttentionBlockPlan(
        "attention",
        {"block_q": bq, "block_k": ATTN_BLOCK_K, "head_pad": head_dim},
        attention_smem_bytes(head_dim=head_dim, block_q=bq),
        batch_heads * -(-seq_q // bq),
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: routes and tiles of the attention backward
# ---------------------------------------------------------------------------

#: ``kernels/csrc/flash_attention_bwd.cu``, three kernels a call: delta
#: (one warp a query row, ``ATTN_BWD_THREADS`` a block), then dK/dV (one
#: block per (batch·KV head, key tile) walking the query tiles of its GQA
#: group in order) and dQ (one block per (batch·query head, query tile)
#: walking the key tiles in order) — deterministic, no float atomics.
#: Routes: bf16 ``"wgmma"`` (warpgroup products fed by TMA:
#: ``ATTN_BWD_WG_THREADS`` threads, a producer warpgroup and two
#: consumers; dK/dV blocks of ``ATTN_BWD_WG_TILES["dkdv"]`` = (keys a
#: block, query rows a ring slot), dQ blocks of
#: ``ATTN_BWD_WG_TILES["dq"]`` = (query rows a block, keys a ring slot),
#: rings of ``ATTN_BWD_WG_STAGES`` slots; blocks run tile major, the
#: heaviest causal tile of every head first) where TMA can read every
#: operand — a head of ``ATTN_BWD_WG_HEADS`` and 16-byte aligned bases;
#: other bf16 shapes ``"mma"`` (``mma.sync``, ``ATTN_BWD_MMA_THREADS``
#: threads, tiles of ``ATTN_BWD_TILE`` both ways, the head padded to
#: ``ATTN_MMA_HEAD_PADS``, blocks head major); f32 ``"cuda_core"``
#: (``ATTN_BWD_THREADS`` threads, the same tiles).  The kernel's constants
#: of the same meaning; a test holds them equal
ATTN_BWD_THREADS = 256
ATTN_BWD_MMA_THREADS = 128
ATTN_BWD_TILE = 64
ATTN_BWD_WG_THREADS = 384
ATTN_BWD_WG_TILES = {"dkdv": (128, 64), "dq": (128, 64)}
ATTN_BWD_WG_STAGES = 4
ATTN_BWD_WG_HEADS = (64, 128)


@dataclass
class AttnBwdPlan:
    """Routes and tiles of one attention backward (three launches):
    ``route`` (``"wgmma"`` or ``"mma"`` for bf16, ``"cuda_core"`` for
    f32); ``tiles`` the dK/dV kernel's (keys a block, query rows a step)
    and the dQ kernel's (query rows a block, keys a step); ``grids`` the
    blocks of ``"delta"``, ``"dkdv"`` and ``"dq"``; ``smem_bytes`` the
    dK/dV and dQ kernels' shared memory.  Causal, every kernel starts its
    heaviest tiles first: key tile 0 (dK/dV) and the last query tile (dQ)
    — on ``"wgmma"`` of every head at once (blocks tile major), on the
    other routes head by head."""

    route: str
    tiles: dict
    grids: dict
    smem_bytes: dict


def attn_bwd_smem_bytes(*, route: str, head_dim: int) -> dict:
    """Dynamic shared memory of the dK/dV and dQ kernels — the formulas of
    ``flash_attention_bwd.cu``.  ``"wgmma"``, all bf16 with the head as
    one or two 64-wide boxes: dK/dV the K and V tiles of its keys, then
    ``ATTN_BWD_WG_STAGES`` slots of a Q and a dO tile of its query rows
    plus their lse and delta (f32); dQ the Q and dO tiles of its rows, then
    the slots of a K and a V tile; each plus 1024 bytes to align it.
    ``"mma"``: six bf16 tiles of 64 rows of the padded head plus
    ``MMA_ROW_PAD``, and two stages of lse and delta.  ``"cuda_core"``: f32
    tiles of rows of the padded head plus 4 (dK/dV: K, V, Q, dO and the
    (64 × 68) p and ds tiles; dQ: Q, dO, K, V and ds transposed), and lse
    and delta of the query tile."""
    t = ATTN_BWD_TILE
    if route == "wgmma":
        (kb, qs), (qb, ks) = ATTN_BWD_WG_TILES["dkdv"], ATTN_BWD_WG_TILES["dq"]
        st, d = ATTN_BWD_WG_STAGES, head_dim
        return {"dkdv": 2 * kb * d * 2 + st * (2 * qs * d * 2 + 2 * qs * 4)
                + 1024,
                "dq": 2 * qb * d * 2 + st * 2 * ks * d * 2 + 1024}
    dp = attention_head_pad(head_dim)
    if route == "mma":
        b = 2 * 6 * t * (dp + MMA_ROW_PAD) + 4 * t * 4
        return {"dkdv": b, "dq": b}
    return {"dkdv": 4 * (4 * t * (dp + 4) + 2 * t * (t + 4) + 2 * t),
            "dq": 4 * (4 * t * (dp + 4) + t * (t + 4) + 2 * t)}


# every route's kernels fit one block's shared memory at the widest head
assert all(v <= H100.smem_per_block
           for r in ("wgmma", "mma", "cuda_core")
           for v in attn_bwd_smem_bytes(route=r,
                                        head_dim=ATTN_MAX_HEAD_DIM).values())


@functools.lru_cache(maxsize=4096)
def plan_attn_bwd_blocks(*, batch_heads_q: int, heads_q: int, heads_kv: int,
                         seq_q: int, seq_k: int, head_dim: int, dtype: str,
                         aligned: bool = True) -> AttnBwdPlan:
    """Route and tile the attention backward on the H100.  bf16 takes
    ``"wgmma"`` where TMA can read every operand — a head of
    ``ATTN_BWD_WG_HEADS`` (one or two 128-byte rows) and ``aligned``,
    every base 16-byte aligned — and ``"mma"`` otherwise; f32
    ``"cuda_core"``.  Raises :class:`ValueError` for a head outside
    1..``ATTN_MAX_HEAD_DIM``, an empty problem, heads that do not form
    whole GQA groups, or a dtype with no route."""
    if not 1 <= head_dim <= ATTN_MAX_HEAD_DIM:
        raise ValueError(
            f"attention backward: head_dim {head_dim} outside the kernel's "
            f"1..{ATTN_MAX_HEAD_DIM}")
    if min(batch_heads_q, heads_q, heads_kv, seq_q, seq_k) < 1:
        raise ValueError(
            f"attention backward: empty problem (B·Hq {batch_heads_q}, Hq "
            f"{heads_q}, Hkv {heads_kv}, Sq {seq_q}, Sk {seq_k})")
    if heads_q % heads_kv or batch_heads_q % heads_q:
        raise ValueError(
            f"attention backward: {batch_heads_q} query heads of {heads_q} "
            f"over {heads_kv} KV heads is not whole groups")
    if dtype == "float32":
        route = "cuda_core"
    elif dtype == "bfloat16":
        route = ("wgmma" if head_dim in ATTN_BWD_WG_HEADS and aligned
                 else "mma")
    else:
        raise ValueError(f"attention backward: no route for {dtype}")
    bhkv = batch_heads_q // heads_q * heads_kv
    if route == "wgmma":
        tiles = dict(ATTN_BWD_WG_TILES)
    else:
        tiles = {"dkdv": (ATTN_BWD_TILE,) * 2, "dq": (ATTN_BWD_TILE,) * 2}
    rows = ATTN_BWD_THREADS // 32
    return AttnBwdPlan(
        route, tiles,
        {"delta": -(-batch_heads_q * seq_q // rows),
         "dkdv": bhkv * -(-seq_k // tiles["dkdv"][0]),
         "dq": batch_heads_q * -(-seq_q // tiles["dq"][0])},
        attn_bwd_smem_bytes(route=route, head_dim=head_dim),
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the fused-MLP kernel
# ---------------------------------------------------------------------------

#: both routes of ``kernels/csrc/fused_mlp.cu``: 256 threads; a block
#: walks the hidden axis ``MLP_BLOCK_F`` columns at a time
MLP_THREADS = 256
MLP_BLOCK_F = 64
#: f32 route (CUDA cores): (rows per block, output columns per thread) the
#: kernel is instantiated for: rows × columns = 64 f32 accumulators a
#: thread, rows capped at 16
MLP_TILES = ((16, 1), (16, 2), (16, 4), (8, 8), (4, 16), (2, 32))
#: widest model dimension either route takes (the f32 route's register
#: accumulator; the bf16 route's eight CTAs of 1024 columns)
MLP_MAX_D = MLP_THREADS * MLP_TILES[-1][1]
#: f32 output accumulators a thread keeps, on either route
MLP_ACC_REGS = 64
#: bf16 route (tensor cores): the D columns one CTA of a cluster owns, the
#: most CTAs in a (portable) cluster, and the rows of x per row tile it is
#: instantiated for; a CTA's (rows, columns) f32 accumulator is at most
#: ``MLP_MMA_ACC`` elements, ``MLP_ACC_REGS`` a thread
MLP_MMA_COLS = (128, 256, 512, 1024)
MLP_MMA_MAX_CLUSTER = 8
MLP_MMA_ROWS = (16, 32, 64)
MLP_MMA_ACC = MLP_ACC_REGS * MLP_THREADS
#: the bf16 route's weight ring: stages, and rows of Wu / Wg per chunk
MLP_MMA_STAGES = 3
MLP_MMA_CHUNK_K = 128


@dataclass
class MlpBlockPlan:
    """Chosen tiling of one fused-MLP launch: ``blocks`` holds ``rows``
    (rows of x per block or cluster), ``cols`` (f32 route: output columns
    per thread; bf16 route: the D columns of one CTA), ``cluster`` (CTAs
    that share a row tile; 1 on the f32 route), ``block_f`` (hidden
    columns per step), ``splits`` (blocks or clusters the hidden axis is
    split over; 1 = no partials, no summing pass) and ``tiles_per_split``;
    ``grid`` is the number of blocks of the main pass."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int

    @property
    def acc_regs(self) -> int:
        """f32 output accumulators one thread keeps: a CTA's ``rows ×
        cols`` over its 256 threads (bf16 route), or ``rows × cols``
        (f32 route)."""
        b = self.blocks
        if self.kind == "fused_mlp_mma":
            return b["rows"] * b["cols"] // MLP_THREADS
        return b["rows"] * b["cols"]


def mlp_smem_bytes(*, rows: int, d: int) -> int:
    """Shared memory one block of the f32 route asks for, all in f32: the
    x rows (``d × rows``), the four partial up/gate sums (``2 × 4 ×
    block_f × rows``) and the hidden tile (``block_f × rows``) — the
    formula of ``fused_mlp.cu``'s ``smem_bytes``."""
    slices = MLP_THREADS // MLP_BLOCK_F
    return 4 * (d * rows + 2 * slices * MLP_BLOCK_F * rows
                + MLP_BLOCK_F * rows)


def mlp_mma_smem_bytes(*, rows: int, cols: int) -> int:
    """Shared memory one CTA of the bf16 route asks for: the weight ring
    (``stages × 2 × chunk_k × (block_f + 8)`` bf16), the x slice (``rows ×
    (cols + 8)`` bf16), two h tiles of a high and a low part each (``4 ×
    rows × (block_f + 8)`` bf16) and the up / gate partials (``2 × rows ×
    (block_f + 4)`` f32) — the formula of ``fused_mlp.cu``'s
    ``mma_smem_bytes``."""
    stage = 2 * MLP_MMA_CHUNK_K * (MLP_BLOCK_F + MMA_ROW_PAD)
    return (2 * (MLP_MMA_STAGES * stage + rows * (cols + MMA_ROW_PAD)
                 + 4 * rows * (MLP_BLOCK_F + MMA_ROW_PAD))
            + 4 * 2 * rows * (MLP_BLOCK_F + 4))


# every tile fits one block's shared memory: the f32 route's x rows at
# their widest D, and each bf16 tile the planner may pick (216,064 B at
# most)
assert all(mlp_smem_bytes(rows=r, d=MLP_THREADS * c) <= H100.smem_per_block
           for r, c in MLP_TILES)
assert all(mlp_mma_smem_bytes(rows=r, cols=c) <= H100.smem_per_block
           for r in MLP_MMA_ROWS for c in MLP_MMA_COLS if r * c <= MLP_MMA_ACC)
assert MLP_MMA_COLS[-1] * MLP_MMA_MAX_CLUSTER >= MLP_MAX_D


def _mlp_splits(row_tiles: int, f: int, units: int) -> tuple[int, int]:
    """(splits, tiles per split) of the hidden axis: as many as give two
    waves of ``units`` blocks over the SMs, at most one split per
    ``block_f`` tile, and no split left empty."""
    f_tiles = -(-f // MLP_BLOCK_F)
    want = -(-2 * H100.sms // (row_tiles * units))
    splits = max(1, min(f_tiles, want))
    per_split = -(-f_tiles // splits)
    return -(-f_tiles // per_split), per_split


@functools.lru_cache(maxsize=4096)
def plan_mlp_blocks(*, m: int, d: int, f: int, dtype: str) -> MlpBlockPlan:
    """Tile the fused-MLP kernel on the H100.

    ``dtype`` ``"bfloat16"`` takes the tensor-core route: a cluster of
    ``cluster`` CTAs splits D, each owning ``cols`` columns — the fewest
    of ``MLP_MMA_COLS`` for which eight CTAs cover D — and a row tile of
    ``rows`` rows: the fewest of 16, 32, 64 that hold M, as far as the
    accumulator (``rows × cols ≤ MLP_MMA_ACC``) allows.  Otherwise (f32,
    the CUDA cores) the output columns per thread follow from ``d`` (the
    fewest tile whose 256 × columns cover it), and with them the rows per
    block.  On both, when the row tiles give fewer than two waves of
    blocks (decode: a few rows), the hidden axis is split across blocks
    or clusters until they do, as far as its ``block_f`` tiles go; no
    split is left empty.  Raises :class:`ValueError` above ``MLP_MAX_D``
    and for an empty problem.  Plans are memoized per shape; treat them
    as read-only."""
    if m < 1 or d < 1 or f < 1:
        raise ValueError(
            f"fused MLP: empty problem (M {m}, D {d}, F {f})")
    if d > MLP_MAX_D:
        raise ValueError(
            f"fused MLP: d_model {d} exceeds the kernel's limit "
            f"{MLP_MAX_D} (its (rows, D) accumulator lives in registers)")
    if dtype == "bfloat16":
        cols = next(c for c in MLP_MMA_COLS
                    if -(-d // c) <= MLP_MMA_MAX_CLUSTER)
        cluster = -(-d // cols)
        rows = next((r for r in MLP_MMA_ROWS
                     if r >= m and r * cols <= MLP_MMA_ACC),
                    max(r for r in MLP_MMA_ROWS if r * cols <= MLP_MMA_ACC))
        m_tiles = -(-m // rows)
        splits, per_split = _mlp_splits(m_tiles, f, cluster)
        return MlpBlockPlan(
            "fused_mlp_mma",
            {"rows": rows, "cols": cols, "cluster": cluster,
             "block_f": MLP_BLOCK_F, "splits": splits,
             "tiles_per_split": per_split},
            mlp_mma_smem_bytes(rows=rows, cols=cols),
            m_tiles * splits * cluster,
        )
    rows, cols = next((r, c) for r, c in MLP_TILES if MLP_THREADS * c >= d)
    m_tiles = -(-m // rows)
    splits, per_split = _mlp_splits(m_tiles, f, 1)
    return MlpBlockPlan(
        "fused_mlp",
        {"rows": rows, "cols": cols, "cluster": 1, "block_f": MLP_BLOCK_F,
         "splits": splits, "tiles_per_split": per_split},
        mlp_smem_bytes(rows=rows, d=d), m_tiles * splits,
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tiles of the fused MLP's backward
# ---------------------------------------------------------------------------

#: ``kernels/csrc/fused_mlp_bwd.cu``, three kernels a call on one of three
#: routes.  The hidden kernel gives each (rows of M, columns of F) tile of
#: ``MLP_BWD_HIDDEN_TILE`` its g, u and dh over all of D and writes h, du
#: and dg once; the weight-gradient kernel sums dWd, dWu and dWg over all
#: of M and the dx kernel sums over all of F, one output tile of
#: ``MLP_BWD_GEMM_TILE`` a block, each walking its reduction
#: ``MLP_BWD_CHUNK_K`` deep at a time in order.  The dtypes' keys are the
#: routes each dtype takes where it can: bf16 ``"wgmma"`` (warpgroup
#: products fed by TMA: ``MLP_BWD_WG_THREADS`` threads, a producer
#: warpgroup and two consumers, a ring of ``MLP_BWD_STAGES`` chunks per
#: kernel; the weight gradients' tile is (F, D), dWu and dWg stored
#: transposed), f32 ``"cuda_core"`` (``MLP_THREADS`` threads, one chunk).
#: bf16 shapes that TMA cannot describe take ``"mma"`` (``mma.sync``,
#: ``MLP_THREADS`` threads, the ``MLP_BWD_MMA_*`` tiles, ``cp.async``
#: ``MLP_BWD_MMA_STAGES`` deep).  The kernel's constants of the same
#: meaning; a test holds them equal
MLP_BWD_HIDDEN_TILE = {"bfloat16": (128, 64), "float32": (64, 64)}
MLP_BWD_GEMM_TILE = {"bfloat16": (128, 256), "float32": (64, 64)}
MLP_BWD_CHUNK_K = {"bfloat16": 64, "float32": 16}
#: the ``"wgmma"`` hidden kernel's chunk (its rows of ``2 ×`` this many
#: bytes swizzled over their width: 128 as the product kernels', or 64)
MLP_BWD_HIDDEN_CHUNK_K = 64
MLP_BWD_STAGES = {"hidden": 4, "gemm": 3}
MLP_BWD_WG_THREADS = 384
MLP_BWD_MMA_HIDDEN_TILE = (128, 64)
MLP_BWD_MMA_GEMM_TILE = (128, 128)
MLP_BWD_MMA_CHUNK_K = 32
MLP_BWD_MMA_STAGES = 3
#: what the ``"wgmma"`` route needs: TMA's global strides and bases are
#: 16-byte multiples, so D and F multiples of this many bf16
MLP_BWD_TMA_ALIGN = 8


@dataclass
class MlpBwdPlan:
    """Tiling of one fused-MLP backward (three launches): ``route``
    (``"wgmma"`` or ``"mma"`` for bf16, ``"cuda_core"`` for f32);
    ``grids`` the blocks of each kernel (``"hidden"``, ``"wgrad"`` — the
    weight gradients' tiles of all two or three products in one launch —
    and ``"dx"``); ``hidden_bytes`` the scratch the wrapper allocates for
    h, du and dg (bf16: each as a bf16 high and low plane; f32: one f32
    plane; 4 bytes an element either way); ``smem_bytes`` each kernel's
    shared memory."""

    route: str
    grids: dict
    hidden_bytes: int
    smem_bytes: dict


def mlp_bwd_smem_bytes(route: str) -> dict:
    """Shared memory of each backward kernel on ``route`` — the formulas of
    ``fused_mlp_bwd.cu``.  ``"wgmma"``, per stage of rows of ``2 ×
    MLP_BWD_CHUNK_K`` bytes (the product kernels) or ``2 ×
    MLP_BWD_HIDDEN_CHUNK_K`` (the hidden kernel): the hidden kernel's x and
    dy (``rows`` each), Wu, Wg and Wd (``cols`` each), its ring at least
    the epilogue's six planes of (64 × ``cols``) a consumer in 8 KB boxes;
    the two product kernels' A hi and A lo (``rows`` each) and B
    (``cols``); each ring plus 1024 bytes to align it and its full and
    empty barriers.
    ``"mma"``, per stage: the hidden kernel's x and dy chunks (``rows × (k
    + 8)``), Wu's and Wg's (``k × (cols + 8)``) and Wd's (``cols × (k +
    8)``); the two GEMM kernels' A and B chunks with a low plane each,
    either layout (``4 × max(rows × (k + 8), k × (rows + 8))``), all bf16.
    ``"cuda_core"``: two (hidden: five) chunks of ``k × (tile + 4)``
    floats."""
    if route == "wgmma":
        (hm, hn), (gm, gn) = (MLP_BWD_HIDDEN_TILE["bfloat16"],
                              MLP_BWD_GEMM_TILE["bfloat16"])
        row, hrow = 2 * MLP_BWD_CHUNK_K["bfloat16"], 2 * MLP_BWD_HIDDEN_CHUNK_K
        hs, gs = MLP_BWD_STAGES["hidden"], MLP_BWD_STAGES["gemm"]
        ring = max(hs * (2 * hm + 3 * hn) * hrow, 2 * 6 * (hn // 64) * 8192)
        return {"hidden": ring + 1024 + 16 * hs,
                "gemm": gs * (2 * gm + gn) * row + 1024 + 16 * gs}
    if route == "mma":
        (hm, hn), (gm, gn) = MLP_BWD_MMA_HIDDEN_TILE, MLP_BWD_MMA_GEMM_TILE
        k, pad = MLP_BWD_MMA_CHUNK_K, MMA_ROW_PAD
        hidden = 2 * hm * (k + pad) + 2 * k * (hn + pad) + hn * (k + pad)
        gemm = 4 * max(gm * (k + pad), k * (gm + pad))
        return {"hidden": 2 * MLP_BWD_MMA_STAGES * hidden,
                "gemm": 2 * MLP_BWD_MMA_STAGES * gemm}
    (hm, hn), (gm, gn) = (MLP_BWD_HIDDEN_TILE["float32"],
                          MLP_BWD_GEMM_TILE["float32"])
    k = MLP_BWD_CHUNK_K["float32"]
    return {"hidden": 4 * k * (2 * (hm + 4) + 3 * (hn + 4)),
            "gemm": 4 * k * ((gm + 4) + (gn + 4))}


assert all(v <= H100.smem_per_block for r in ("wgmma", "mma", "cuda_core")
           for v in mlp_bwd_smem_bytes(r).values())


@functools.lru_cache(maxsize=4096)
def plan_mlp_bwd_blocks(*, m: int, d: int, f: int, gated: bool,
                        dtype: str, aligned: bool = True) -> MlpBwdPlan:
    """Tile the fused MLP's backward on the H100: one block per hidden
    tile, per weight-gradient tile (dWd (F, D); dWu and, gated, dWg (D,
    F); on ``"wgmma"`` all three as (F, D) tiles) and per dx tile (M, D).
    bf16 takes ``"wgmma"`` where TMA can describe every operand — D and F
    multiples of ``MLP_BWD_TMA_ALIGN`` and ``aligned``, every base 16-byte
    aligned — and ``"mma"`` otherwise.  Raises :class:`ValueError` where
    :func:`plan_mlp_blocks` does (the same ``MLP_MAX_D``: the forward's
    limit binds the pair) and for a dtype with no route."""
    plan_mlp_blocks(m=m, d=d, f=f, dtype=dtype)     # the forward's checks
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"fused MLP backward: no route for {dtype}")

    def tiles(rows, cols, tm, tn):
        return -(-rows // tm) * -(-cols // tn)

    terms = 3 if gated else 2
    if dtype == "float32":
        route = "cuda_core"
    elif (d % MLP_BWD_TMA_ALIGN == 0 and f % MLP_BWD_TMA_ALIGN == 0
          and aligned):
        route = "wgmma"
    else:
        route = "mma"
    if route == "mma":
        (hm, hn), (gm, gn) = MLP_BWD_MMA_HIDDEN_TILE, MLP_BWD_MMA_GEMM_TILE
    else:
        (hm, hn), (gm, gn) = (MLP_BWD_HIDDEN_TILE[dtype],
                              MLP_BWD_GEMM_TILE[dtype])
    if route == "wgmma":
        wgrad = terms * tiles(f, d, gm, gn)
    else:
        wgrad = tiles(f, d, gm, gn) + (terms - 1) * tiles(d, f, gm, gn)
    return MlpBwdPlan(
        route,
        {"hidden": tiles(m, f, hm, hn), "wgrad": wgrad,
         "dx": tiles(m, d, gm, gn)},
        terms * 4 * m * f,
        mlp_bwd_smem_bytes(route),
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the Mamba-2 SSD kernel
# ---------------------------------------------------------------------------

#: f32 route of ``kernels/csrc/mamba2_ssd.cu`` (``mamba2_ssd_kernel``,
#: CUDA cores): 256 threads as 16 × 16; a block walks the positions
#: ``SSD_BLOCK_L`` at a time.  32 positions: two blocks then share an SM
#: (79 KB of shared memory each at P 64, N 128, against 133 KB at 64),
#: which was faster on the card at mamba2-1.3b's prefill
SSD_BLOCK_L = 32
#: bf16 route (``mamba2_ssd_mma_kernel``, tensor cores): the (positions
#: per tile, heads per block) pairs it is instantiated for.  At
#: mamba2-1.3b's prefill (B 4, H 64) on the card, 64 positions and two
#: heads a block (128 blocks of 512 threads, one an SM, sharing b and c)
#: ran 3-4 % faster than 32 positions and one head (256 blocks, two an
#: SM); 32 × 2 and 64 × 1 were slower than both and were dropped
#: (PERF.md).  The wide tile is taken while its blocks keep seven in eight
#: SMs busy, the narrow one below that (a batch of one or two)
SSD_MMA_WIDE = (64, 2)
SSD_MMA_NARROW = (32, 1)
SSD_MMA_TILES = (SSD_MMA_NARROW, SSD_MMA_WIDE)
#: widest head and state either route covers; the bf16 route holds P and
#: N padded with zeros to these widths
SSD_MAX_HEAD_DIM = 64
SSD_MAX_STATE_DIM = 128
#: the SSD backward (``kernels/csrc/mamba2_ssd_bwd.cu``): a dS pass walks
#: each (batch row, head) — in f32 each (batch row, head,
#: ``SSD_BWD_PASS_ROWS`` rows of P) — from the last tile to the first and
#: writes the cotangent of the state leaving every tile; then a tile
#: kernel runs every (batch row, tile, ``SSD_BWD_HEADS_PER_BLOCK`` heads)
#: in parallel, reading the state the forward saved at the start of the
#: tile.  Tiles of ``SSD_BWD_BLOCK_L`` positions, so a forward that saves
#: its states takes tiles of this length (both routes have one)
SSD_BWD_BLOCK_L = 32
SSD_BWD_PASS_ROWS = 16
#: heads a tile block holds, one after the other: they share the tile's b
#: and c, so db and dc leave as partials summed over them — a sixteenth
#: of the per-head partials' bytes, 2048 blocks at mamba2-1.3b's train
#: shape.  16 ran fastest of 2, 4, 8 and 16 there on the card (PERF.md
#: §6); the kernel's ``HB``, which a test holds equal to this
SSD_BWD_HEADS_PER_BLOCK = 16
assert SSD_BWD_BLOCK_L == SSD_BLOCK_L == SSD_MMA_NARROW[0]


@dataclass
class SsdBlockPlan:
    """Tiling of one SSD launch: ``blocks`` holds ``route`` (``"mma"``
    for bf16, ``"cuda_core"`` for f32), ``block_l`` (positions per tile)
    and ``heads_per_block``; ``grid`` is the number of blocks, one per
    (batch row, group of heads)."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int


def ssd_smem_bytes(*, head_dim: int, state_dim: int) -> int:
    """Shared memory one block of the f32 route asks for: c and b of a
    tile (``2 × block_l × pitch``), x of the tile (``block_l × P``), the
    gated c·b tile (``block_l × (block_l + 1)``), the state (``P ×
    pitch``) and four per-position vectors plus one scalar, all f32; the
    pitch of a state row is ``N`` made odd — the formula of
    ``mamba2_ssd.cu``."""
    q, p = SSD_BLOCK_L, head_dim
    pitch = state_dim if state_dim % 2 else state_dim + 1
    return 4 * (2 * q * pitch + q * p + q * (q + 1) + p * pitch + 4 * q + 1)


def ssd_mma_smem_bytes(*, block_l: int, heads_per_block: int) -> int:
    """Shared memory one block of the bf16 route asks for (``MmaSmem`` of
    ``mamba2_ssd.cu``): c and b tiles, two stages each, shared by the
    block's heads, rows of ``N`` padded to 128 + 8 bf16; per head x (two
    stages, rows of 64 + 8), the state's hi and lo parts (64 × 136 bf16
    each), dt (two stages) and three per-position f32 vectors, plus 16
    bytes for exp(cum_last).  P and N do not enter: the tiles are padded."""
    q = block_l
    pitch, xpitch = SSD_MAX_STATE_DIM + 8, SSD_MAX_HEAD_DIM + 8
    shared = 2 * 2 * q * pitch * 2
    head = (2 * q * xpitch + 2 * SSD_MAX_HEAD_DIM * pitch) * 2 + 5 * q * 4 + 16
    return shared + heads_per_block * head


# the widest head and state fit one block's shared memory on both routes
# (f32: 78,980 B; bf16 at 32 positions and one head: 79,504 B)
assert ssd_smem_bytes(head_dim=SSD_MAX_HEAD_DIM,
                      state_dim=SSD_MAX_STATE_DIM) <= H100.smem_per_block
assert all(ssd_mma_smem_bytes(block_l=q, heads_per_block=hb)
           <= H100.smem_per_block for q, hb in SSD_MMA_TILES)


def _check_ssd_problem(batch, length, heads, head_dim, state_dim) -> None:
    if min(batch, length, heads, head_dim, state_dim) < 1:
        raise ValueError(
            f"SSD: empty problem (B {batch}, L {length}, H {heads}, "
            f"P {head_dim}, N {state_dim})")
    if head_dim > SSD_MAX_HEAD_DIM or state_dim > SSD_MAX_STATE_DIM:
        raise ValueError(
            f"SSD: head_dim {head_dim} / state_dim {state_dim} exceed the "
            f"kernel's {SSD_MAX_HEAD_DIM} / {SSD_MAX_STATE_DIM}")


@functools.lru_cache(maxsize=4096)
def plan_ssd_blocks(*, batch: int, length: int, heads: int, head_dim: int,
                    state_dim: int, dtype: str,
                    save_states: bool = False) -> SsdBlockPlan:
    """Tile the SSD kernel on the H100: a block walks the sequence for one
    (batch row, group of heads) a tile at a time with the state on chip.
    bf16 takes the tensor-core route (``SSD_MMA_WIDE`` where its blocks
    keep seven in eight SMs busy, else ``SSD_MMA_NARROW``); f32 the
    CUDA-core route (``SSD_BLOCK_L``, one head).  With ``save_states``
    (training: the forward writes the state entering each tile for the
    backward) bf16 takes ``SSD_MMA_NARROW``, whose tiles are the
    backward's ``SSD_BWD_BLOCK_L``.  Results do not depend on the tile
    beyond f32 rounding.  Raises :class:`ValueError` for a head wider than
    ``SSD_MAX_HEAD_DIM``, a state wider than ``SSD_MAX_STATE_DIM``, an
    empty problem or a dtype with no route."""
    _check_ssd_problem(batch, length, heads, head_dim, state_dim)
    if dtype == "bfloat16":
        wide = (not save_states and batch * -(-heads // SSD_MMA_WIDE[1])
                >= 7 * H100.sms // 8)
        q, hb = SSD_MMA_WIDE if wide else SSD_MMA_NARROW
        return SsdBlockPlan(
            "mamba2_ssd", {"route": "mma", "block_l": q,
                           "heads_per_block": hb},
            ssd_mma_smem_bytes(block_l=q, heads_per_block=hb),
            batch * -(-heads // hb),
        )
    if dtype != "float32":
        raise ValueError(f"SSD: no route for {dtype}")
    return SsdBlockPlan(
        "mamba2_ssd", {"route": "cuda_core", "block_l": SSD_BLOCK_L,
                       "heads_per_block": 1},
        ssd_smem_bytes(head_dim=head_dim, state_dim=state_dim),
        batch * heads,
    )


@dataclass
class SsdBwdPlan:
    """Tiling of one SSD backward (two launches): ``blocks`` holds
    ``route`` (``"mma"`` for bf16, ``"cuda_core"`` for f32), ``block_l``
    and ``heads_per_block``; ``grids`` the pass's blocks, (B·H, 1) in
    bf16 and (B·H, ceil(P / 16)) in f32, and the tile kernel's (B,
    n_tiles, ceil(H / heads_per_block)) — the launcher launches these,
    refusing grids that do not cover the problem; ``smem_bytes`` each
    kernel's shared memory."""

    blocks: dict
    grids: dict
    smem_bytes: dict


def ssd_bwd_smem_bytes(*, head_dim: int, state_dim: int,
                       dtype: str) -> dict:
    """Shared memory of each backward kernel, ``{"pass": ..., "tile":
    ...}`` — the formulas of ``mamba2_ssd_bwd.cu``.  bf16 (the tiles are
    padded, so P and N do not enter): the pass holds c, dy and dt, two
    stages each (rows of 128 + 8 and 64 + 8 bf16); the tile kernel c, b,
    x, dy, the state's and dS's hi and lo parts and G's hi and lo (rows
    padded by 8 bf16), then 19 per-position f32 vectors and 10 f32
    scalars.  f32: the pass c (rows of 128) and the dy slice; the
    tile kernel c and b of a tile (``2 × block_l × pitch``), x and dy
    (``2 × block_l × P`` made odd), the state entering the tile and the
    cotangent of the state leaving it (``2 × P × pitch``), the gated c·bᵀ,
    the gated dy·xᵀ and their product (``3 × block_l × (block_l + 1)``),
    six per-position vectors and eight per-warp partials; a row of ``N``
    (``P``) takes the odd pitch ``N | 1`` (``P | 1``)."""
    q, rows = SSD_BWD_BLOCK_L, SSD_BWD_PASS_ROWS
    if dtype == "bfloat16":
        cp, xp, gp = SSD_MAX_STATE_DIM + 8, SSD_MAX_HEAD_DIM + 8, q + 8
        return {"pass": 2 * (2 * q * cp + 2 * q * xp + 4 * q),
                "tile": 2 * (2 * q * cp + 2 * q * xp
                             + 4 * SSD_MAX_HEAD_DIM * cp + 2 * q * gp)
                + 4 * (19 * q + 8 + 2)}
    npitch, xpitch = state_dim | 1, head_dim | 1
    return {"pass": 4 * (q * SSD_MAX_STATE_DIM + q * rows),
            "tile": 4 * (2 * q * npitch + 2 * q * xpitch
                         + 2 * head_dim * npitch + 3 * q * (q + 1)
                         + 6 * q + 8)}


# each kernel of either route fits one block's shared memory at the
# widest head and state
assert all(v <= H100.smem_per_block for dt in ("bfloat16", "float32")
           for v in ssd_bwd_smem_bytes(head_dim=SSD_MAX_HEAD_DIM,
                                       state_dim=SSD_MAX_STATE_DIM,
                                       dtype=dt).values())


@functools.lru_cache(maxsize=4096)
def plan_ssd_bwd_blocks(*, batch: int, length: int, heads: int,
                        head_dim: int, state_dim: int,
                        dtype: str) -> SsdBwdPlan:
    """Tile the SSD backward on the H100: the dS pass, one block of 8
    warps per (batch row, head) (f32: of 4 warps per (batch row, head, 16
    rows of P)) walking its tiles of ``SSD_BWD_BLOCK_L`` positions from
    last to first; then the tile kernel, one block of 8 warps per (batch
    row, tile, ``SSD_BWD_HEADS_PER_BLOCK`` heads), all in parallel.  bf16
    runs the products on the tensor cores (``"mma"``), f32 on the CUDA
    cores (``"cuda_core"``).  Raises :class:`ValueError` where
    :func:`plan_ssd_blocks` does."""
    _check_ssd_problem(batch, length, heads, head_dim, state_dim)
    routes = {"bfloat16": "mma", "float32": "cuda_core"}
    if dtype not in routes:
        raise ValueError(f"SSD backward: no route for {dtype}")
    hb = SSD_BWD_HEADS_PER_BLOCK
    return SsdBwdPlan(
        {"route": routes[dtype], "block_l": SSD_BWD_BLOCK_L,
         "heads_per_block": hb},
        {"pass": (batch * heads, 1 if dtype == "bfloat16"
                  else -(-head_dim // SSD_BWD_PASS_ROWS)),
         "tile": (batch, -(-length // SSD_BWD_BLOCK_L), -(-heads // hb))},
        ssd_bwd_smem_bytes(head_dim=head_dim, state_dim=state_dim,
                           dtype=dtype),
    )
