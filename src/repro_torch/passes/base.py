"""Pass infrastructure: MLIR's PassManager, minus MLIR.

A :class:`Pass` is a named, statistics-reporting rewrite over a
:class:`~repro_torch.core.ir.DFG`.  The :class:`PassManager` clones the input
graph (callers keep the original for before/after comparison), runs the
pipeline in order, verifies the graph after every pass, and collects the
per-pass statistics the MLIR ``-pass-statistics`` flag would print.

Every future rewrite lands as a Pass: implement ``run_on(dfg) -> dict``
(mutate in place, return {stat: count}) and append it to a pipeline.
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field

import repro_torch.instrument as instrument
from repro_torch.core.ir import DFG

from .verifier import VerificationError, verify_dfg


class Pass(abc.ABC):
    """One rewrite.  ``name`` identifies it in reports and errors."""

    name: str = "pass"

    @abc.abstractmethod
    def run_on(self, dfg: DFG) -> dict[str, int]:
        """Mutate ``dfg`` in place; return statistics (counts of what the
        pass did).  An all-zero dict means the pass made no change."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


@dataclass(frozen=True)
class PassStats:
    """Outcome of one pass application.

    ``wall_ms`` is the pass's measured wall time (the ``-mlir-timing``
    datum); it rides along in telemetry/provenance but never enters any
    schedule, emission, or BENCH metric — outputs stay deterministic.
    """

    name: str
    changed: bool
    stats: dict[str, int]
    wall_ms: float = 0.0


@dataclass
class PipelineResult:
    """The rewritten graph plus the statistics trail."""

    dfg: DFG
    passes: list[PassStats] = field(default_factory=list)

    @property
    def changed(self) -> bool:
        return any(p.changed for p in self.passes)

    def stat(self, key: str) -> int:
        """Sum one statistic across every pass that reported it."""
        return sum(p.stats.get(key, 0) for p in self.passes)

    def report(self) -> str:
        """MLIR ``-pass-statistics``-style summary."""
        lines = [f"pass pipeline on {self.dfg.name}:"]
        for p in self.passes:
            stats = ", ".join(f"{k}={v}" for k, v in sorted(p.stats.items()) if v)
            lines.append(f"  {p.name:<28} {stats or '(no change)'}")
        return "\n".join(lines)


class PassManager:
    """Runs a pipeline of passes with inter-pass verification.

    ``verify=True`` (default) runs the structural verifier after every
    pass and re-raises :class:`VerificationError` naming the pass that
    broke the graph — the MLIR contract that makes rewrites composable.
    """

    def __init__(self, passes: list[Pass], *, verify: bool = True) -> None:
        self.passes = list(passes)
        self.verify = verify

    def run(self, dfg: DFG, *, clone: bool = True) -> PipelineResult:
        tracer = instrument.current()
        g = dfg.clone() if clone else dfg
        if self.verify:
            verify_dfg(g)  # reject malformed inputs before rewriting
        result = PipelineResult(dfg=g)
        snap = instrument.snapshot_dfg(g) if tracer.enabled else None
        with tracer.span(f"pipeline:{g.name}", cat="passes") as pipe_args:
            for p in self.passes:
                with tracer.span(f"pass:{p.name}", cat="passes") as sargs:
                    t0 = time.perf_counter()
                    stats = p.run_on(g) or {}
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    sargs.update(stats)
                if self.verify:
                    with tracer.span(f"verify:{p.name}", cat="passes"):
                        try:
                            verify_dfg(g)
                        except VerificationError as e:
                            raise VerificationError(
                                f"pass {p.name!r} produced a malformed "
                                f"DFG: {e}"
                            ) from e
                result.passes.append(PassStats(
                    p.name, any(v for v in stats.values()), dict(stats),
                    wall_ms=wall_ms,
                ))
                if tracer.enabled:
                    # -print-ir-after-all: structural diff per pass, the
                    # full textual IR only on request (ir_snapshots)
                    after = instrument.snapshot_dfg(g)
                    args: dict = {
                        "diff": instrument.diff_snapshots(snap, after)
                    }
                    if tracer.ir_snapshots:
                        args["ir"] = instrument.format_dfg(g)
                    tracer.instant(f"ir_after:{p.name}", cat="passes",
                                   args=args)
                    snap = after
            pipe_args["passes"] = len(self.passes)
        return result
