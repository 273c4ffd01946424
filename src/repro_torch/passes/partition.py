"""Resource-aware, cost-aware layer-group partitioning.

When :func:`~repro_torch.core.dse.solve_ilp` proves the whole-graph streaming
plan exceeds the BRAM/DSP budgets even at unroll=1, we split the DFG at
stream cut-points into **layer groups**: contiguous topological slices
that each fit the budget on their own.  Groups execute sequentially on
the fabric (separate HLS kernels, one resident at a time); values
crossing a group boundary spill to DRAM buffers that the host-side
schedule allocates and threads between kernel invocations.

Two strategies over the (canonicalized, fused) topological order:

* ``"balanced"`` (default) — exact min-max search: a memoized DP over
  the cut positions that minimizes the *slowest group's* modeled cycles
  subject to per-group feasibility, tie-breaking on the **total host
  schedule** (group cycles plus overlapped boundary DMA, see
  :func:`~repro_torch.core.resource_model.transition_cycles`) and then on
  fewer groups.  Every candidate slice — not just single
  nodes — may be planned with **partial weight streaming** when its
  resident-weight plan is over budget, so the DP prices a group
  boundary (spill round-trip) against streamed weight tiles (DRAM tile
  traffic) and keeps whichever is modeled cheaper.
* ``"greedy"`` — the prefix cut (grow until the budget breaks),
  optimal in group *count* but free to leave one group far slower than
  the rest; kept for regression comparison with its historical
  semantics (weight streaming only as the single-node rescue).

Feasibility is monotone in group extent (a superset group needs at
least its subset's line buffers, FIFOs, and — streamed or not — weight
storage), so each start position probes forward only until the first
infeasible end; the suffix-bound fast infeasibility keeps every
probe cheap.

The result is the schedule IR of :mod:`repro_torch.core.compile_driver`:
``partition_layer_groups`` returns a :class:`CompiledDesign` (exported
here under its historical name ``PartitionPlan``), whose groups are
:class:`GroupSchedule`s (historically ``LayerGroup``).
"""
from __future__ import annotations

from typing import Optional

import repro_torch.instrument as instrument
from repro_torch.core.compile_driver import (
    _STRATEGIES,
    _WEIGHT_STREAMING,
    CompiledDesign,
    CompileOptions,
    GroupSchedule,
    SpillBuffer,
    boundary_bytes,
)
from repro_torch.core.dse import solve_ilp
from repro_torch.core.ir import DFG
from repro_torch.core.resource_model import (
    FpgaResourceModel,
    KV260_BRAM18K,
    KV260_DSP,
    transition_cycles,
)
from repro_torch.core.streaming import plan_streams

#: historical names for the schedule IR classes
LayerGroup = GroupSchedule
PartitionPlan = CompiledDesign


class PartitionError(ValueError):
    """A single node exceeds the budgets on its own — no cut can help,
    not even with partial weight streaming."""


class _GroupPlanner:
    """Plans (and caches) contiguous slices ``order[i:j]`` as groups.

    Every slice is planned resident-weights first; if that is over
    budget the slice is re-solved with ``weight_streaming=True`` — the
    first-class streaming choice the balanced DP prices against a cut.
    (The streamed candidate set is a superset of the resident one, so a
    slice that fits resident never silently picks up weight tiles.)
    """

    def __init__(self, dfg: DFG, *, d_total: int, b_total: int,
                 model: Optional[FpgaResourceModel], max_unroll: int,
                 weight_streaming: str = "auto") -> None:
        self.dfg = dfg
        self.order = [n.name for n in dfg.topo_order()]
        self.d_total = d_total
        self.b_total = b_total
        self.model = model
        self.max_unroll = max_unroll
        self.weight_streaming = weight_streaming
        self._resident: dict[tuple[int, int], tuple] = {}
        self._cache: dict[tuple[int, int], GroupSchedule] = {}
        #: search statistics the DP trace and ``CompiledDesign.dp_stats``
        #: surface — counts only, never consulted by the search itself
        self.stats: dict = {
            "nodes": len(self.order),
            "ilp_solves": 0,
            "streamed_resolves": 0,
            "slices_planned": 0,
            "slice_cache_hits": 0,
            "dp_states": 0,
            "dp_memo_hits": 0,
            "rejected_cuts": [],
        }

    def _reject_reason(self, dse) -> str:
        """Why an infeasible slice was rejected, from its unroll=1
        estimate vs the budgets: over BRAM, over DSP, both, or
        infeasible for another reason (e.g. no legal candidates)."""
        over = []
        if dse.bram_used > self.b_total:
            over.append("BRAM")
        if dse.dsp_used > self.d_total:
            over.append("DSP")
        return "+".join(over) or "infeasible"

    def _record_reject(self, i: int, j: int, dse, *, streamed: bool,
                       rescued: bool = False) -> None:
        """Log ``order[i:j]`` as a rejected cut candidate.  ``rescued``
        marks a slice that was infeasible with resident weights but
        kept after a streamed re-solve — rejected *as a resident cut*,
        which is the reason (BRAM/DSP) the trace surfaces."""
        self.stats["rejected_cuts"].append({
            "i": i, "j": j,
            "first": self.order[i], "last": self.order[j - 1],
            "reason": self._reject_reason(dse),
            "bram": dse.bram_used, "dsp": dse.dsp_used,
            "streamed_tried": streamed,
            "streamed_rescued": rescued,
        })

    def _solve(self, plan, *, weight_streaming: bool):
        with instrument.span(
            f"ilp:{plan.dfg.name}", cat="dse",
            args={"nodes": len(plan.node_order()),
                  "weight_streaming": weight_streaming},
        ) as sargs:
            dse = solve_ilp(
                plan, d_total=self.d_total, b_total=self.b_total,
                model=self.model, max_unroll=self.max_unroll,
                weight_streaming=weight_streaming,
            )
            sargs.update({"explored": dse.explored,
                          "feasible": dse.feasible,
                          "objective_cycles": dse.objective_cycles})
        return dse

    def _resident_plan(self, i: int, j: int):
        """(subgraph, streaming plan, resident-weights DSE) for
        ``order[i:j]`` — cached separately from :meth:`group` so pure
        resident-feasibility probes (the greedy strategy, the
        whole-graph fast path) never pay the streamed re-solve."""
        key = (i, j)
        hit = self._resident.get(key)
        if hit is None:
            names = self.order[i:j]
            sub = self.dfg.subgraph(names, name=f"{self.dfg.name}_g0")
            plan = plan_streams(sub)
            self.stats["ilp_solves"] += 1
            hit = (sub, plan, self._solve(plan, weight_streaming=False))
            self._resident[key] = hit
        return hit

    def group(self, i: int, j: int) -> GroupSchedule:
        """Plan ``order[i:j]``: resident if it fits, else re-solved with
        partial weight streaming (double-buffered DRAM tiles) — any
        slice length, not a single-node rescue.  Cached."""
        key = (i, j)
        g = self._cache.get(key)
        if g is None:
            self.stats["slices_planned"] += 1
            sub, plan, dse = self._resident_plan(i, j)
            resident = dse
            tried_stream = False
            if not dse.feasible and self.weight_streaming != "off":
                tried_stream = True
                self.stats["ilp_solves"] += 1
                self.stats["streamed_resolves"] += 1
                streamed = self._solve(plan, weight_streaming=True)
                if streamed.feasible:
                    dse = streamed
            if not resident.feasible:
                # a resident-infeasible slice is a rejected cut
                # candidate either way: when the streamed re-solve
                # rescues it the slice survives *streamed*, but the
                # resident rejection (and its BRAM/DSP reason) is what
                # explains the schedule in the trace
                self._record_reject(i, j, resident, streamed=tried_stream,
                                    rescued=dse.feasible)
            spill_in = [v for v in sub.graph_inputs
                        if v not in self.dfg.graph_inputs]
            spill_out = [v for v in sub.graph_outputs
                         if v not in self.dfg.graph_outputs]
            g = GroupSchedule(sub.name, sub, plan, dse, spill_in, spill_out)
            self._cache[key] = g
        else:
            self.stats["slice_cache_hits"] += 1
        return g

    def renamed(self, i: int, j: int, index: int) -> GroupSchedule:
        """The cached group, re-labelled with its final schedule index."""
        g = self.group(i, j)
        name = f"{self.dfg.name}_g{index}"
        if g.name != name:
            sub = self.dfg.subgraph(self.order[i:j], name=name)
            g = GroupSchedule(name, sub, g.plan, g.dse,
                              list(g.spill_in), list(g.spill_out))
            self._cache[(i, j)] = g
        return g

    def resident_feasible(self, i: int, j: int) -> bool:
        """``order[i:j]`` fits with all weights on-chip (no tiles)."""
        return self._resident_plan(i, j)[2].feasible

    def transition(self, left: GroupSchedule, right: GroupSchedule) -> int:
        """Overlapped boundary DMA between two adjacent groups — the
        same ``boundary_bytes`` the compiled design reports."""
        return transition_cycles(*boundary_bytes(self.dfg, left, right))

    def _check_first(self, i: int) -> None:
        if not self.group(i, i + 1).dse.feasible:
            how = (
                "even with streamed weights"
                if self.weight_streaming != "off"
                else "with resident weights (weight_streaming='off')"
            )
            raise PartitionError(
                f"{self.dfg.name}: node {self.order[i]} alone exceeds the "
                f"budgets (DSP={self.d_total}, BRAM={self.b_total}) {how} "
                "— partitioning cannot help"
            )

    def max_feasible_end(self, i: int) -> int:
        """Largest ``j`` with ``order[i:j]`` feasible — resident *or*
        weight-streamed (monotone probe).

        Raises :class:`PartitionError` when even ``order[i:i+1]`` cannot
        fit with streamed weights.
        """
        self._check_first(i)
        j = i + 1
        while j < len(self.order) and self.group(i, j + 1).dse.feasible:
            j += 1
        return j

    def max_resident_end(self, i: int) -> int:
        """The greedy probe: grow while the slice fits with
        resident weights; a lone infeasible node falls back to the
        streamed single-node group (the historical rescue)."""
        self._check_first(i)
        j = i + 1
        while j < len(self.order) and self.resident_feasible(i, j + 1):
            j += 1
        return j


def _balanced_cuts(planner: _GroupPlanner) -> list[tuple[int, int]]:
    """Cost-aware min-max DP over cut positions.

    Primary objective: minimize the slowest group's modeled cycles —
    exact (every greedy cut is in the candidate space, so the balanced
    result is never worse than greedy on the max, a property pinned by
    tests/test_partition_properties.py).  Tie-breaks: the total host
    schedule (group cycles + overlapped boundary DMA — this is where a
    spill round-trip is traded against a streamed slice's weight-tile
    traffic), then fewer groups.

    The tie-break total is exact for linear chains (every boundary's
    traffic depends only on the cut position).  For diamonds the bridge
    added when combining ``group(i, j)`` with the memoized suffix uses
    the suffix's already-chosen first group, whose ``spill_in`` can vary
    with its extent — an exact total there would need two-dimensional
    DP state; we accept the approximation on the secondary key only.
    """
    n = len(planner.order)
    # memo[i] = ((max_cycles, total_cycles, n_groups), cuts-for-suffix)
    memo: dict[int, tuple[tuple[int, int, int], list[tuple[int, int]]]] = {
        n: ((0, 0, 0), [])
    }

    def best(i: int) -> tuple[tuple[int, int, int], list[tuple[int, int]]]:
        hit = memo.get(i)
        if hit is not None:
            planner.stats["dp_memo_hits"] += 1
            return hit
        planner.stats["dp_states"] += 1
        end = planner.max_feasible_end(i)
        best_key: tuple[int, int, int] | None = None
        best_cuts: list[tuple[int, int]] = []
        for j in range(i + 1, end + 1):
            g = planner.group(i, j)
            (rest_max, rest_total, rest_groups), rest_cuts = best(j)
            bridge = (
                planner.transition(g, planner.group(*rest_cuts[0]))
                if rest_cuts else 0
            )
            key = (
                max(g.cycles, rest_max),
                g.cycles + bridge + rest_total,
                1 + rest_groups,
            )
            if best_key is None or key < best_key:
                best_key = key
                best_cuts = [(i, j)] + rest_cuts
        assert best_key is not None  # end >= i+1 guarantees one candidate
        memo[i] = (best_key, best_cuts)
        return memo[i]

    return best(0)[1]


def _greedy_cuts(planner: _GroupPlanner) -> list[tuple[int, int]]:
    """Greedy behaviour: grow each group until the next node breaks it."""
    cuts: list[tuple[int, int]] = []
    i = 0
    n = len(planner.order)
    while i < n:
        j = planner.max_resident_end(i)
        cuts.append((i, j))
        i = j
    return cuts


def partition_layer_groups(
    dfg: DFG,
    *,
    options: Optional[CompileOptions] = None,
    d_total: Optional[int] = None,
    b_total: Optional[int] = None,
    model: Optional[FpgaResourceModel] = None,
    max_unroll: Optional[int] = None,
    strategy: Optional[str] = None,
    weight_streaming: Optional[str] = None,
) -> CompiledDesign:
    """Whole graph if it fits resident; otherwise cost-aware balanced
    topological layer groups (or the greedy cut,
    ``strategy="greedy"``) — where the balanced DP may keep a slice
    whole with streamed weight tiles instead of cutting it (disable
    with ``weight_streaming="off"``).

    An ``options`` bundle (:class:`repro_torch.core.CompileOptions`) is the
    single source of truth ``compile_design`` threads through the whole
    stack: budgets and the resource model come from its target, the
    strategy, unroll cap, and streaming policy from its fields.  Mixing
    it with loose kwargs is an error (never a silent override)."""
    if options is not None:
        loose = (d_total, b_total, model, max_unroll, strategy,
                 weight_streaming)
        if any(v is not None for v in loose):
            raise ValueError(
                "pass either options=CompileOptions(...) or the loose "
                "d_total/b_total/model/max_unroll/strategy/"
                "weight_streaming kwargs, not both"
            )
        tgt = options.target
        d_total, b_total = tgt.d_total, tgt.b_total
        model = tgt.model()
        max_unroll = options.resolved_max_unroll
        strategy = options.strategy
        weight_streaming = options.weight_streaming
    else:
        d_total = KV260_DSP if d_total is None else d_total
        b_total = KV260_BRAM18K if b_total is None else b_total
        max_unroll = 4096 if max_unroll is None else max_unroll
        strategy = "balanced" if strategy is None else strategy
        weight_streaming = (
            "auto" if weight_streaming is None else weight_streaming
        )
    if strategy not in _STRATEGIES:
        raise ValueError(
            f"unknown partition strategy {strategy!r} — one of {_STRATEGIES}"
        )
    if weight_streaming not in _WEIGHT_STREAMING:
        # a policy string, NOT solve_ilp's per-solve bool — catch e.g.
        # weight_streaming=False before it silently behaves as "auto"
        raise ValueError(
            f"weight_streaming must be one of {_WEIGHT_STREAMING}, got "
            f"{weight_streaming!r}"
        )
    planner = _GroupPlanner(
        dfg, d_total=d_total, b_total=b_total, model=model,
        max_unroll=max_unroll, weight_streaming=weight_streaming,
    )
    tracer = instrument.current()
    n = len(planner.order)
    with tracer.span(f"partition:{dfg.name}", cat="partition") as pargs:
        if planner.resident_feasible(0, n):
            # fits whole with weights on-chip: never cut a feasible graph
            # (the ROADMAP reconfiguration-cost item gates that trade)
            cuts = [(0, n)]
            whole = True
        else:
            whole = False
            cuts = (_balanced_cuts if strategy == "balanced"
                    else _greedy_cuts)(planner)
        groups = [planner.renamed(i, j, idx)
                  for idx, (i, j) in enumerate(cuts)]
        design = CompiledDesign(dfg, groups, d_total, b_total,
                                whole_graph_feasible=whole, options=options)
        design.dp_stats = _finish_stats(planner, strategy, design, cuts)
        pargs.update({"groups": len(groups), "whole_graph_feasible": whole})
    if tracer.enabled:
        tracer.instant(f"dp_stats:{dfg.name}", cat="partition",
                       args=design.dp_stats)
    return design


def _finish_stats(planner: _GroupPlanner, strategy: str,
                  design: CompiledDesign, cuts: list[tuple[int, int]]) -> dict:
    """The search-statistics record attached to every design: planner
    counters, a rejected-cut reason histogram, and the final frontier
    (the kept cuts with their modeled cost)."""
    stats = dict(planner.stats)
    stats["rejected_cuts"] = list(stats["rejected_cuts"])
    stats["strategy"] = strategy
    stats["whole_graph_feasible"] = design.whole_graph_feasible
    reasons: dict[str, int] = {}
    for rc in stats["rejected_cuts"]:
        reasons[rc["reason"]] = reasons.get(rc["reason"], 0) + 1
    stats["rejected_by_reason"] = reasons
    stats["frontier"] = [
        {
            "group": g.name, "i": i, "j": j,
            "cycles": g.cycles, "bram": g.bram, "dsp": g.dsp,
            "weight_tiles": g.weight_streamed,
        }
        for (i, j), g in zip(cuts, design.groups)
    ]
    return stats
