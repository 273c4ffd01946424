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
conv, flash-attention, fused-MLP and SSD kernels.
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

#: register tile of the streaming conv kernel (pixels along W x output
#: channels per thread) and its block size — fixed in
#: ``kernels/csrc/conv2d_stream.cu``; tiles are multiples of these
CONV_TILE_PIXELS = 4
CONV_TILE_CHANNELS = 4
CONV_BLOCK_THREADS = 256


@dataclass
class ConvBlockPlan:
    """Chosen tiling of one streaming-conv launch.

    ``blocks``: ``rows`` (output rows per band — what one block walks),
    ``rows_step`` (output rows computed between two ring refills),
    ``w_tile`` / ``c_tile`` (output columns / channels per block)."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: tuple[int, int, int]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def conv_smem_bytes(*, kh: int, kw: int, c_in: int, stride: int,
                    rows_step: int, w_tile: int, c_tile: int) -> int:
    """Shared memory one block of the streaming conv kernel asks for:
    the resident weight tile plus the input-row ring, both widened to
    the 32-bit accumulate type (the formula of ``conv2d_stream.cu``)."""
    ring_rows = (rows_step - 1) * stride + kh
    slot_cols = (w_tile - 1) * stride + kw
    return 4 * (kh * kw * c_in * c_tile + ring_rows * slot_cols * (c_in | 1))


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
    """Tile the streaming conv kernel so one block's working set — the
    ``(rows_step - 1)·stride + kh`` input rows of the ring, each
    ``(w_tile - 1)·stride + kw`` columns × ``c_in`` wide, plus the
    ``kh·kw·c_in·c_tile`` weight tile — fits the shared-memory budget.

    The (``c_tile``, ``w_tile``) pair with the most outputs per ring step
    wins (ties: wider channel tile — fewer re-reads of the input);
    ``rows_step`` then grows until a step keeps every thread of the
    block busy; the band (``rows``) starts at the whole frame — each
    input row read once — and halves while the launch would leave SMs
    idle.  ``rows`` pins the band instead (results never depend on it).
    Raises :class:`ValueError` when not even the smallest tile fits.
    Plans are memoized per shape (the conv wrapper asks on every call);
    treat the returned plan as read-only.
    """
    budget = smem_budget or spec.smem_per_block
    tp, tc = CONV_TILE_PIXELS, CONV_TILE_CHANNELS

    def smem(rows_step: int, w_tile: int, c_tile: int) -> int:
        return conv_smem_bytes(kh=kh, kw=kw, c_in=c_in, stride=stride,
                               rows_step=rows_step, w_tile=w_tile,
                               c_tile=c_tile)

    w_cands = []
    wt = _round_up(min(w_out, 64), tp)
    while wt >= tp:
        w_cands.append(wt)
        wt = _round_up(wt // 2, tp) if wt > tp else 0
    best = None
    for c_tile in range(_round_up(min(c_out, 64), tc), 0, -tc):
        for w_tile in w_cands:
            if smem(1, w_tile, c_tile) <= budget:
                if best is None or c_tile * w_tile > best[0] * best[1]:
                    best = (c_tile, w_tile)
                break
    if best is None:
        raise ValueError(
            f"conv {kh}x{kw}x{c_in}->{c_out}: the smallest tile "
            f"({smem(1, tp, tc)} B) exceeds the shared-memory budget "
            f"({budget} B)"
        )
    c_tile, w_tile = best
    n_wt = -(-w_out // w_tile)
    n_ct = -(-c_out // c_tile)

    cap = h_out if rows is None else max(1, min(rows, h_out))
    rows_step = 1
    per_row = (w_tile // tp) * (c_tile // tc)
    while (
        rows_step * per_row < CONV_BLOCK_THREADS
        and rows_step * 2 <= cap
        and smem(rows_step * 2, w_tile, c_tile) <= budget
    ):
        rows_step *= 2

    if rows is not None:
        band = cap
    else:
        band = _round_up(h_out, rows_step)
        others = batch * n_wt * n_ct
        while band > rows_step and others * -(-h_out // band) < 2 * spec.sms:
            band = max(rows_step, _round_up(-(-band // 2), rows_step))
    return ConvBlockPlan(
        "conv_rows",
        {"rows": band, "rows_step": rows_step, "w_tile": w_tile,
         "c_tile": c_tile},
        smem(rows_step, w_tile, c_tile),
        (n_wt * n_ct, -(-h_out // band), batch),
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the flash-attention kernel
# ---------------------------------------------------------------------------

#: fixed shape of ``kernels/csrc/flash_attention.cu``: 256 threads as a
#: 16 × 16 grid, each holding a (block_q/16) × 4 tile of the score block
#: and a (block_q/16) × (D/16) tile of the output; keys stream through
#: shared memory ``ATTN_BLOCK_K`` at a time
ATTN_BLOCK_K = 64
#: query tiles the kernel is instantiated for, largest first
ATTN_BLOCK_Q = (64, 32)
#: widest head the register tile takes (8 output columns per thread)
ATTN_MAX_HEAD_DIM = 128
#: floats of padding after each shared-memory row (keeps 16-byte vector
#: loads aligned and spreads the transposed stores over the banks)
ATTN_SMEM_PAD = 4


@dataclass
class AttentionBlockPlan:
    """Chosen tiling of one flash-attention launch: ``blocks`` holds
    ``block_q`` (query rows per block) and ``block_k`` (keys per shared-
    memory tile); ``grid`` is the number of blocks."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int


def attention_cols_per_thread(head_dim: int) -> int:
    """Output columns one thread keeps (the kernel's ``DPT``): 2, 4 or 8,
    so that 16 threads cover the head."""
    return 2 if head_dim <= 32 else 4 if head_dim <= 64 else 8


def attention_smem_bytes(*, head_dim: int, block_q: int) -> int:
    """Shared memory one block asks for, all in f32: the query tile and
    the key tile transposed (``D × (tile + pad)``), the value tile
    (``block_k × 16·DPT``) and the probability tile (``block_q ×
    (block_k + pad)``) — the formula of ``flash_attention.cu``."""
    pad, bk = ATTN_SMEM_PAD, ATTN_BLOCK_K
    dv = 16 * attention_cols_per_thread(head_dim)
    return 4 * (head_dim * (block_q + pad) + head_dim * (bk + pad)
                + bk * dv + block_q * (bk + pad))


# the largest tile at the widest head must fit one block's shared memory
# (119,808 B of 232,448 B), so the planner never has to refuse a head
# the register tile takes
assert attention_smem_bytes(head_dim=ATTN_MAX_HEAD_DIM,
                            block_q=ATTN_BLOCK_Q[0]) <= H100.smem_per_block


@functools.lru_cache(maxsize=4096)
def plan_attention_blocks(
    *,
    seq_q: int,
    seq_k: int,
    head_dim: int,
    batch_heads: int = 1,
) -> AttentionBlockPlan:
    """Tile the flash-attention kernel on the H100: one block per
    (batch·head, query tile) loops over the keys ``ATTN_BLOCK_K`` at a
    time, holding query, key, value and probability tiles in shared
    memory (every tile fits, see the assert above).

    The largest query tile wins (each key tile loaded into shared memory
    then serves more query rows); it halves while the launch would leave
    SMs idle (fewer than two blocks per SM) or while it exceeds the
    queries there are.  Raises :class:`ValueError` for a head wider than
    the register tile (``ATTN_MAX_HEAD_DIM``).  Plans are memoized per
    shape; treat them as read-only.
    """
    if not 1 <= head_dim <= ATTN_MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention: head_dim {head_dim} outside the kernel's "
            f"1..{ATTN_MAX_HEAD_DIM}")
    if seq_q < 1 or seq_k < 1 or batch_heads < 1:
        raise ValueError(
            f"flash attention: empty problem (seq_q {seq_q}, seq_k "
            f"{seq_k}, batch_heads {batch_heads})")
    tiles = ATTN_BLOCK_Q
    i = 0
    while i + 1 < len(tiles) and (
            tiles[i + 1] >= seq_q
            or batch_heads * -(-seq_q // tiles[i]) < 2 * H100.sms):
        i += 1
    bq = tiles[i]
    return AttentionBlockPlan(
        "attention", {"block_q": bq, "block_k": ATTN_BLOCK_K},
        attention_smem_bytes(head_dim=head_dim, block_q=bq),
        batch_heads * -(-seq_q // bq),
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the fused-MLP kernel
# ---------------------------------------------------------------------------

#: fixed shape of ``kernels/csrc/fused_mlp.cu``: 256 threads; a block
#: walks the hidden axis ``MLP_BLOCK_F`` columns at a time
MLP_THREADS = 256
MLP_BLOCK_F = 64
#: (rows per block, output columns per thread) the kernel is instantiated
#: for: rows × columns = 64 f32 accumulators a thread, rows capped at 16
MLP_TILES = ((16, 1), (16, 2), (16, 4), (8, 8), (4, 16), (2, 32))
#: widest model dimension the register accumulator takes
MLP_MAX_D = MLP_THREADS * MLP_TILES[-1][1]


@dataclass
class MlpBlockPlan:
    """Chosen tiling of one fused-MLP launch: ``blocks`` holds ``rows``
    (rows of x per block), ``cols`` (output columns per thread),
    ``block_f`` (hidden columns per step), ``splits`` (blocks the hidden
    axis is split over; 1 = no partials, no summing pass) and
    ``tiles_per_split``; ``grid`` is the number of blocks of the main
    pass."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int


def mlp_smem_bytes(*, rows: int, d: int) -> int:
    """Shared memory one block asks for, all in f32: the x rows
    (``d × rows``), the four partial up/gate sums (``2 × 4 × block_f ×
    rows``) and the hidden tile (``block_f × rows``) — the formula of
    ``fused_mlp.cu``."""
    slices = MLP_THREADS // MLP_BLOCK_F
    return 4 * (d * rows + 2 * slices * MLP_BLOCK_F * rows
                + MLP_BLOCK_F * rows)


# the x rows of every tile at its widest D fit one block's shared memory
assert all(mlp_smem_bytes(rows=r, d=MLP_THREADS * c) <= H100.smem_per_block
           for r, c in MLP_TILES)


@functools.lru_cache(maxsize=4096)
def plan_mlp_blocks(*, m: int, d: int, f: int) -> MlpBlockPlan:
    """Tile the fused-MLP kernel on the H100.

    The output columns per thread follow from ``d`` (the fewest tile whose
    256 × columns cover it), and with them the rows per block.  When the
    row tiles give fewer than two blocks per SM (decode: a few rows), the
    hidden axis is split across blocks until they do, as far as its
    ``block_f`` tiles go; no split is left empty.  Raises
    :class:`ValueError` above ``MLP_MAX_D`` (the register accumulator's
    limit) and for an empty problem.  Plans are memoized per shape; treat
    them as read-only."""
    if m < 1 or d < 1 or f < 1:
        raise ValueError(
            f"fused MLP: empty problem (M {m}, D {d}, F {f})")
    if d > MLP_MAX_D:
        raise ValueError(
            f"fused MLP: d_model {d} exceeds the kernel's limit "
            f"{MLP_MAX_D} (its (rows, D) accumulator lives in registers)")
    rows, cols = next((r, c) for r, c in MLP_TILES if MLP_THREADS * c >= d)
    m_tiles = -(-m // rows)
    f_tiles = -(-f // MLP_BLOCK_F)
    want = -(-2 * H100.sms // m_tiles)
    splits = max(1, min(f_tiles, want))
    per_split = -(-f_tiles // splits)
    splits = -(-f_tiles // per_split)
    return MlpBlockPlan(
        "fused_mlp",
        {"rows": rows, "cols": cols, "block_f": MLP_BLOCK_F,
         "splits": splits, "tiles_per_split": per_split},
        mlp_smem_bytes(rows=rows, d=d), m_tiles * splits,
    )


# ---------------------------------------------------------------------------
# NVIDIA H100: tile selection for the Mamba-2 SSD kernel
# ---------------------------------------------------------------------------

#: fixed shape of ``kernels/csrc/mamba2_ssd.cu``: 256 threads as 16 × 16;
#: a block walks the positions ``SSD_BLOCK_L`` at a time.  32 positions:
#: two blocks then share an SM (79 KB of shared memory each at P 64, N
#: 128, against 133 KB at 64), which was faster on the card at
#: mamba2-1.3b's prefill
SSD_BLOCK_L = 32
#: widest head and state the register tiles cover
SSD_MAX_HEAD_DIM = 64
SSD_MAX_STATE_DIM = 128


@dataclass
class SsdBlockPlan:
    """Tiling of one SSD launch: ``blocks`` holds ``block_l`` (positions
    per tile); ``grid`` is the number of blocks, one per (batch, head)."""

    kind: str
    blocks: dict
    smem_bytes: int
    grid: int


def ssd_smem_bytes(*, head_dim: int, state_dim: int) -> int:
    """Shared memory one block asks for, all in f32: c and b of a tile
    (``2 × block_l × pitch``), x of the tile (``block_l × P``), the gated
    c·b tile (``block_l × (block_l + 1)``), the state (``P × pitch``) and
    four per-position vectors plus one scalar; the pitch of a state row is
    ``N`` made odd — the formula of ``mamba2_ssd.cu``."""
    q, p = SSD_BLOCK_L, head_dim
    pitch = state_dim if state_dim % 2 else state_dim + 1
    return 4 * (2 * q * pitch + q * p + q * (q + 1) + p * pitch + 4 * q + 1)


# the widest head and state fit one block's shared memory (78,980 B)
assert ssd_smem_bytes(head_dim=SSD_MAX_HEAD_DIM,
                      state_dim=SSD_MAX_STATE_DIM) <= H100.smem_per_block


@functools.lru_cache(maxsize=4096)
def plan_ssd_blocks(*, batch: int, length: int, heads: int, head_dim: int,
                    state_dim: int) -> SsdBlockPlan:
    """Tile the SSD kernel on the H100: one block per (batch, head) walks
    the sequence ``SSD_BLOCK_L`` positions at a time with the head's state
    in shared memory (it fits, see the assert above).  Raises
    :class:`ValueError` for a head wider than ``SSD_MAX_HEAD_DIM``, a
    state wider than ``SSD_MAX_STATE_DIM`` or an empty problem."""
    if min(batch, length, heads, head_dim, state_dim) < 1:
        raise ValueError(
            f"SSD: empty problem (B {batch}, L {length}, H {heads}, "
            f"P {head_dim}, N {state_dim})")
    if head_dim > SSD_MAX_HEAD_DIM or state_dim > SSD_MAX_STATE_DIM:
        raise ValueError(
            f"SSD: head_dim {head_dim} / state_dim {state_dim} exceed the "
            f"kernel's {SSD_MAX_HEAD_DIM} / {SSD_MAX_STATE_DIM}")
    return SsdBlockPlan(
        "mamba2_ssd", {"block_l": SSD_BLOCK_L},
        ssd_smem_bytes(head_dim=head_dim, state_dim=state_dim),
        batch * heads,
    )
