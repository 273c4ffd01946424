"""Compiler & runtime instrumentation — zero-dependency.

One layer, five pieces:

* :mod:`repro_torch.instrument.tracer` — the span/instant/counter
  :class:`Tracer`, the ambient contextvar slot (:func:`use_tracer` /
  :func:`current`), and Chrome trace-event export + validation;
* :mod:`repro_torch.instrument.metrics` — live aggregated telemetry: the
  labeled Counter/Gauge/Histogram :class:`MetricsRegistry` with JSON
  snapshots and Prometheus-text exposition, its own ambient slot
  (:func:`use_metrics` / :func:`metrics_current`), and
  :data:`NULL_REGISTRY`;
* :mod:`repro_torch.instrument.profiler` — the modeled-vs-measured join:
  run a compiled artifact and reconcile per-group wall times against
  the resource model's cycle predictions;
* :mod:`repro_torch.instrument.snapshot` — structural DFG snapshots and
  diffs (``-print-ir-after-all``);
* :mod:`repro_torch.instrument.provenance` — git-sha/host/time stamps for
  BENCH rows and exported traces.

The contract that makes this safe to thread everywhere: with no tracer
installed and :data:`NULL_REGISTRY` ambient, every entry point here is
a true no-op and instrumented code produces byte-identical output
(pinned by ``tests/test_instrument.py`` and ``tests/test_metrics.py``).
"""
from .metrics import (
    LATENCY_BUCKETS_MS,
    NULL_REGISTRY,
    MetricsRegistry,
    NullRegistry,
    use_metrics,
    validate_metrics_snapshot,
)
from .metrics import current as metrics_current
from .profiler import ProfileReport, profile_artifact
from .provenance import git_sha, provenance
from .snapshot import diff_is_empty, diff_snapshots, format_dfg, snapshot_dfg
from .tracer import (
    CATEGORIES,
    NULL_TRACER,
    NullTracer,
    Tracer,
    counter,
    current,
    instant,
    span,
    tracing_active,
    use_tracer,
    validate_chrome_trace,
)

__all__ = [
    "CATEGORIES",
    "LATENCY_BUCKETS_MS",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "MetricsRegistry",
    "NullRegistry",
    "NullTracer",
    "ProfileReport",
    "Tracer",
    "counter",
    "current",
    "diff_is_empty",
    "diff_snapshots",
    "format_dfg",
    "git_sha",
    "instant",
    "metrics_current",
    "profile_artifact",
    "provenance",
    "snapshot_dfg",
    "span",
    "tracing_active",
    "use_metrics",
    "use_tracer",
    "validate_chrome_trace",
]
