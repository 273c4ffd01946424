"""Unified compile driver: one entry point, one schedule IR.

Earlier versions had two ad-hoc lowering paths: the monolithic
``plan_streams → solve_ilp → emit_cpp`` chain for graphs that fit, and
``partition_layer_groups → emit_partitioned`` for graphs that don't —
with every consumer (HLS emitter, paper tables, Pallas wrappers)
re-deriving plan state on its own.  This module replaces both with an
explicit **schedule IR**:

* :class:`GroupSchedule` — one sequentially-executed slice of the graph:
  its subgraph, streaming plan, ILP solution (unrolls, stream widths,
  weight tiles), spill edges, and modeled cycles.
* :class:`CompiledDesign` — the ordered list of ``GroupSchedule``s plus
  the spill ledger and whole-design accounting.  A single-group design
  is just the degenerate case (``partitioned == False``).
* :func:`compile_design` — ``compile_design(dfg, target) ->
  CompiledDesign``: pass pipeline → cycle-balanced partitioning →
  per-group streaming + DSE.  (The historical ``compile`` alias
  finished its deprecation cycle and was removed; accessing
  it raises an ``AttributeError`` that names the new entry point.)
* :class:`CompileOptions` — the one frozen knob bundle (target preset
  or custom :class:`Target`, partition strategy, pass-pipeline
  selection, weight-streaming policy, DSE unroll cap), validated at
  construction and threaded through the driver, the partition DP
  (``repro_torch.passes.partition``), and the ILP
  (``repro_torch.core.dse.solve_ilp``) instead of loose positional kwargs.

Every backend works off the one ``CompiledDesign``:
``repro_torch.core.emit_hls.emit_design`` (Vitis C++, one kernel per group +
host schedule), ``repro_torch.kernels.ops.run_compiled`` (one fused Pallas/XLA
executable per group), and ``benchmarks/paper_tables`` (reporting).
The user-facing handle wrapping all of this is
``repro_torch.api.CompiledArtifact``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

import repro_torch.instrument as instrument

from .dse import DseResult
from .ir import DFG
from .resource_model import (
    DRAM_BYTES_PER_CYCLE,
    FpgaResourceModel,
    KV260_BRAM18K,
    KV260_DSP,
    ZU3EG_BRAM18K,
    ZU3EG_DSP,
    transition_cycles,
)
from .streaming import StreamingPlan

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids core→passes cycle
    from repro_torch.passes.base import PipelineResult


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Target:
    """A device budget the driver compiles against."""

    name: str = "kv260"
    d_total: int = KV260_DSP
    b_total: int = KV260_BRAM18K
    max_unroll: int = 4096

    def model(self) -> FpgaResourceModel:
        return FpgaResourceModel()


KV260 = Target()
ZU3EG = Target(name="zu3eg", d_total=ZU3EG_DSP, b_total=ZU3EG_BRAM18K)

#: device presets the multi-target sweep iterates over
TARGETS: dict[str, Target] = {t.name: t for t in (KV260, ZU3EG)}


# ---------------------------------------------------------------------------
# CompileOptions: the one validated knob bundle
# ---------------------------------------------------------------------------

_STRATEGIES = ("balanced", "greedy")
_WEIGHT_STREAMING = ("auto", "off")
_LINT = ("warn", "error", "off")


@dataclass(frozen=True)
class CompileOptions:
    """Everything a compile can be configured with, validated up front.

    ``target``
        A :class:`Target` or a preset name from :data:`TARGETS`
        (``"kv260"`` / ``"zu3eg"``); names resolve at construction.
    ``strategy``
        Partitioner: ``"balanced"`` (min-max DP) or ``"greedy"``
        (prefix cut, kept for regression comparison).
    ``passes``
        Pass-pipeline selection: ``None`` → the default pipeline;
        ``()`` → skip rewrites entirely; a tuple of registry names
        (``repro_torch.passes.PASS_REGISTRY``) → that exact pipeline, in that
        order.  Unknown names fail here, not mid-compile.
    ``weight_streaming``
        ``"auto"`` (the partitioner may re-solve over-budget slices
        with DRAM-streamed weight tiles) or ``"off"`` (resident weights
        only — graphs like ``fat_conv`` then raise
        :class:`~repro_torch.passes.partition.PartitionError`).
    ``max_unroll``
        DSE search cap per node; ``None`` defers to the target's
        ``max_unroll``.
    ``verify``
        Run the structural verifier between passes (PassManager
        contract); only worth disabling in tight benchmark loops.
    ``trace``
        Instrumentation: ``False`` (default) compiles with
        the ambient tracer (usually the no-op null tracer — zero
        observable effect); ``True`` attaches a fresh
        :class:`repro_torch.instrument.Tracer` to the design so pass/DP/DSE
        spans and runtime counters are collected; a string path does
        the same and is where the CLI writes the Chrome trace JSON.
        Tracing never changes schedules, emitted HLS, or BENCH metrics.
    ``lint``
        Static analysis: ``"warn"`` (default) runs the
        ``repro_torch.analyze`` diagnostics engine over the compiled design
        and stores the findings on ``CompiledDesign.diagnostics``
        (surfaced through ``Report`` telemetry and ``python -m repro
        lint``); ``"error"`` additionally fails the compile with
        :class:`repro_torch.analyze.LintError` when any ERROR-severity
        diagnostic fires; ``"off"`` skips the analyzer entirely.
        Like ``trace``, linting never changes the schedule.
    """

    target: Target | str = "kv260"
    strategy: str = "balanced"
    passes: Optional[tuple[str, ...]] = None
    weight_streaming: str = "auto"
    max_unroll: Optional[int] = None
    verify: bool = True
    trace: bool | str = False
    lint: str = "warn"

    def __post_init__(self) -> None:
        t = self.target
        if isinstance(t, str):
            if t not in TARGETS:
                raise ValueError(
                    f"unknown target preset {t!r} — available: "
                    f"{sorted(TARGETS)} (or pass a repro_torch.core.Target)"
                )
            object.__setattr__(self, "target", TARGETS[t])
        elif not isinstance(t, Target):
            raise ValueError(
                f"target must be a Target or preset name, got "
                f"{type(t).__name__}"
            )
        if self.strategy not in _STRATEGIES:
            raise ValueError(
                f"unknown partition strategy {self.strategy!r} — "
                f"one of {_STRATEGIES}"
            )
        if self.weight_streaming not in _WEIGHT_STREAMING:
            raise ValueError(
                f"weight_streaming must be one of {_WEIGHT_STREAMING}, "
                f"got {self.weight_streaming!r}"
            )
        if self.max_unroll is not None and self.max_unroll < 1:
            raise ValueError(f"max_unroll must be >= 1, got {self.max_unroll}")
        if not isinstance(self.trace, (bool, str)):
            raise ValueError(
                f"trace must be False, True, or an output path, got "
                f"{type(self.trace).__name__}"
            )
        if isinstance(self.trace, str) and not self.trace:
            raise ValueError(
                "trace='' is ambiguous — use trace=False to disable or "
                "trace=True to collect without writing"
            )
        if self.lint not in _LINT:
            raise ValueError(
                f"lint must be one of {_LINT}, got {self.lint!r}"
            )
        if self.passes is not None:
            names = tuple(self.passes)
            object.__setattr__(self, "passes", names)
            from repro_torch.passes import validate_pass_names

            validate_pass_names(names)

    # -- identity ------------------------------------------------------------

    def cache_key(self) -> str:
        """A stable, hashable digest of everything that determines the
        *compiled design*: the resolved target budgets, partition
        strategy, pass selection, weight-streaming policy, unroll cap,
        and verify flag.  ``trace`` and ``lint`` are deliberately
        excluded — neither instrumentation nor the diagnostics engine
        changes schedules (pinned by ``tests/test_instrument.py`` /
        ``tests/test_analyze.py``), so traced/linted and plain compiles
        share cache entries.  (A ``lint="error"`` rejection produces no
        design, so nothing stale can be cached.)

        This is *the* key for compiled-artifact caching: the serving
        artifact LRU (``repro_torch.serve.ArtifactCache``) and the
        ``REPRO_BENCH_CACHE`` disk cache both key on
        ``(model name, options.cache_key())`` instead of ad-hoc target
        names, so an option change can never serve a stale design.
        """
        import hashlib

        t = self.target
        payload = (
            "ck1",  # bumped when the digest's field set changes
            t.name, t.d_total, t.b_total, t.max_unroll,
            self.strategy, self.passes, self.weight_streaming,
            self.max_unroll, self.verify,
        )
        return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]

    # -- resolved views ------------------------------------------------------

    @property
    def resolved_max_unroll(self) -> int:
        return self.max_unroll if self.max_unroll is not None \
            else self.target.max_unroll

    @property
    def trace_path(self) -> Optional[str]:
        """The trace output path when ``trace`` names one, else None."""
        return self.trace if isinstance(self.trace, str) else None

    def run_pipeline(self, dfg: DFG):
        """Run the selected pass pipeline over ``dfg`` (clone-first, as
        PassManager always does).  Returns a ``PipelineResult`` or
        ``None`` when ``passes == ()``."""
        from repro_torch.passes import (
            PassManager,
            pipeline_from_names,
            run_default_pipeline,
        )

        if self.passes is None:
            return run_default_pipeline(dfg, verify=self.verify)
        if not self.passes:
            return None
        pm = PassManager(pipeline_from_names(self.passes), verify=self.verify)
        return pm.run(dfg)


# ---------------------------------------------------------------------------
# Schedule IR
# ---------------------------------------------------------------------------


@dataclass
class SpillBuffer:
    """A DRAM buffer carrying one value across a group boundary."""

    value: str
    bits: int

    @property
    def bytes(self) -> int:
        return math.ceil(self.bits / 8)


@dataclass
class GroupSchedule:
    """One sequentially-executed slice of the graph, independently
    planned through streaming + DSE.  The unit every backend consumes."""

    name: str
    dfg: DFG
    plan: StreamingPlan
    dse: DseResult
    spill_in: list[str] = field(default_factory=list)
    spill_out: list[str] = field(default_factory=list)

    @property
    def bram(self) -> int:
        return self.dse.bram_used

    @property
    def dsp(self) -> int:
        return self.dse.dsp_used

    @property
    def cycles(self) -> int:
        return self.dse.estimate.pipeline_cycles

    @property
    def weight_streamed(self) -> dict[str, int]:
        """Nodes mapped with partial weight streaming (node -> tiles)."""
        return dict(self.dse.weight_tiles)

    @property
    def node_names(self) -> list[str]:
        return [n.name for n in self.dfg.nodes]


def boundary_bytes(
    dfg: DFG, left: "GroupSchedule", right: "GroupSchedule"
) -> tuple[int, int]:
    """(write, read) bytes DMA'd at the ``left → right`` group
    transition — the one definition of boundary traffic, shared by the
    design's accounting and the partition DP's tie-break cost so the DP
    always optimizes the total it reports."""
    w = sum(math.ceil(dfg.values[v].total_bits / 8) for v in left.spill_out)
    r = sum(math.ceil(dfg.values[v].total_bits / 8) for v in right.spill_in)
    return w, r


@dataclass
class CompiledDesign:
    """The schedule IR root: ordered groups + spill ledger + budgets.

    ``source`` is the (post-pass-pipeline) graph the groups partition;
    ``original`` the pre-pipeline graph when :func:`compile` ran the
    passes.  Known to every backend; derived nowhere else.
    """

    source: DFG
    groups: list[GroupSchedule]
    d_total: int
    b_total: int
    whole_graph_feasible: bool
    target: Optional[Target] = None
    original: Optional[DFG] = None
    pass_result: Optional["PipelineResult"] = None
    #: the validated knob bundle this design was compiled under (None
    #: for designs built through the bare partitioner API)
    options: Optional[CompileOptions] = None
    #: partition-DP search statistics (states explored, memo hits,
    #: rejected cuts with reasons, final frontier) — always recorded by
    #: the partitioner, surfaced through Report/trace
    dp_stats: Optional[dict] = field(default=None, repr=False, compare=False)
    #: the Tracer that observed this compile when CompileOptions.trace
    #: was set; CompiledArtifact re-installs it for run()/emit_hls() so
    #: runtime counters land in the same trace.  Never pickled.
    tracer: Optional[object] = field(default=None, repr=False, compare=False)
    #: static-analysis findings (``repro_torch.analyze.Diagnostic``) collected
    #: when ``CompileOptions.lint`` is not "off"; surfaced through
    #: Report telemetry and ``python -m repro lint``
    diagnostics: list = field(default_factory=list, repr=False,
                              compare=False)

    def __getstate__(self):
        # a save()d design must not drag its trace along: traces are an
        # export (write_trace), not part of the schedule IR
        state = dict(self.__dict__)
        state["tracer"] = None
        return state

    # -- group-level accounting ---------------------------------------------

    @property
    def partitioned(self) -> bool:
        return len(self.groups) > 1

    @property
    def feasible(self) -> bool:
        return all(g.dse.feasible for g in self.groups)

    @property
    def max_bram(self) -> int:
        """Peak resident BRAM — one group occupies the fabric at a time."""
        return max(g.bram for g in self.groups)

    @property
    def max_dsp(self) -> int:
        return max(g.dsp for g in self.groups)

    @property
    def max_group_cycles(self) -> int:
        """The slowest group — the cycle-balanced partitioner's objective."""
        return max(g.cycles for g in self.groups)

    @property
    def weight_streamed(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for g in self.groups:
            out.update(g.weight_streamed)
        return out

    # -- spill ledger --------------------------------------------------------

    def spills(self) -> list[SpillBuffer]:
        seen: dict[str, SpillBuffer] = {}
        for g in self.groups:
            for v in g.spill_out:
                val = self.source.values[v]
                seen.setdefault(v, SpillBuffer(v, val.total_bits))
        return list(seen.values())

    @property
    def spill_bits(self) -> int:
        return sum(s.bits for s in self.spills())

    def boundary_traffic(self) -> list[tuple[int, int]]:
        """(write_bytes, read_bytes) DMA'd at each group→group
        transition: group *k* writes its ``spill_out`` while group
        *k+1*'s ``spill_in`` is read back — the two transfers overlap
        (see :func:`~repro_torch.core.resource_model.transition_cycles`).
        A value that skips groups is written once at its producer's
        transition and read at each consuming group's fill."""
        return [
            boundary_bytes(self.source, g, nxt)
            for g, nxt in zip(self.groups, self.groups[1:])
        ]

    @property
    def spill_cycles(self) -> int:
        """Boundary DMA under the overlapped model: per transition,
        ``max(spill write, fill read)`` plus the exposed burst tail —
        not a serial write-then-read round trip."""
        return sum(transition_cycles(w, r) for w, r in self.boundary_traffic())

    @property
    def serial_spill_cycles(self) -> int:
        """The serial cost model: the same boundary transfers, charged
        serially (write completes before the read starts, no overlap).
        On single-consumer chains this equals the older per-spill-value
        round trip exactly; with multi-consumer spills it charges one
        fill per consuming group (the overlap model's traffic, which
        that model under-counted).  Kept as the regression baseline the
        overlapped model must never exceed."""
        return sum(
            math.ceil(w / DRAM_BYTES_PER_CYCLE)
            + math.ceil(r / DRAM_BYTES_PER_CYCLE)
            for w, r in self.boundary_traffic()
        )

    @property
    def total_cycles(self) -> int:
        """Sequential schedule: groups back-to-back plus spill traffic."""
        return sum(g.cycles for g in self.groups) + self.spill_cycles

    # -- host-visible schedule ----------------------------------------------

    def schedule(self) -> list[dict]:
        """Host-visible schedule rows (consumed by the emitter and the
        benchmark report)."""
        return [
            {
                "group": g.name,
                "nodes": g.node_names,
                "bram": g.bram,
                "dsp": g.dsp,
                "cycles": g.cycles,
                "spill_in": list(g.spill_in),
                "spill_out": list(g.spill_out),
                "weight_streamed": g.weight_streamed,
            }
            for g in self.groups
        ]


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def compile_design(
    dfg: DFG,
    target: Optional[Target | str] = None,
    *,
    options: Optional[CompileOptions] = None,
    strategy: Optional[str] = None,
    run_passes: Optional[bool] = None,
) -> CompiledDesign:
    """Lower ``dfg`` to a :class:`CompiledDesign`.

    Configuration comes from one :class:`CompileOptions` (preferred) or
    the legacy kwargs (``target`` / ``strategy`` / ``run_passes``),
    which are folded into an options bundle — mixing both is an error.

    Stages: (1) the selected pass pipeline (default: canonicalize /
    DCE / CSE / fusion); (2) whole-graph streaming + ILP; (3) if over
    budget resident, the cost-aware balanced partitioner
    (``repro_torch.passes.partition``) — which may keep any slice whole with
    streamed weight tiles instead of cutting it (unless
    ``weight_streaming="off"``), pricing DRAM tile traffic against
    overlapped spill boundaries.
    """
    from repro_torch.passes import partition_layer_groups

    if options is None:
        options = CompileOptions(
            target=target if target is not None else KV260,
            strategy=strategy if strategy is not None else "balanced",
            passes=() if run_passes is False else None,
        )
    elif target is not None or strategy is not None or run_passes is not None:
        raise ValueError(
            "pass either options=CompileOptions(...) or the legacy "
            "target/strategy/run_passes kwargs, not both"
        )

    # tracer lifecycle: options.trace attaches a fresh Tracer
    # unless one is already ambient (a CLI/benchmark harness driving
    # several compiles into one trace); with trace off, the ambient
    # tracer — normally the no-op NULL_TRACER — is used as-is, so the
    # disabled path is byte-identical to the uninstrumented one.
    ambient = instrument.current()
    owned = instrument.Tracer() if options.trace and not ambient.enabled \
        else None
    with instrument.use_tracer(owned):
        tracer = instrument.current()
        with tracer.span(f"compile:{dfg.name}", cat="compile",
                         args={"target": options.target.name,
                               "strategy": options.strategy}):
            pass_result = options.run_pipeline(dfg)
            lowered = pass_result.dfg if pass_result is not None else dfg
            design = partition_layer_groups(lowered, options=options)
            if options.lint != "off":
                from repro_torch.analyze import LintError, Severity, analyze_design

                design.diagnostics = analyze_design(design)
                if options.lint == "error" and any(
                    d.severity is Severity.ERROR for d in design.diagnostics
                ):
                    raise LintError(design.diagnostics, graph=lowered.name)
    design.target = options.target
    design.original = dfg
    design.pass_result = pass_result
    design.options = options
    if tracer.enabled:
        design.tracer = tracer
    return design


def __getattr__(name: str):
    """The ``compile`` alias (the original driver name, which
    shadowed the Python builtin) finished its deprecation cycle: every
    caller was migrated to :func:`compile_design`, and the alias is now
    gone rather than warning forever."""
    if name == "compile":
        raise AttributeError(
            "repro_torch.core.compile_driver.compile was removed after its "
            "deprecation cycle — call compile_design(dfg, ...) (same "
            "semantics, no builtin shadowing)"
        )
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
