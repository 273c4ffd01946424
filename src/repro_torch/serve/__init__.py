"""Serving runtime over compiled artifacts.

The seed's LM serving driver (``repro_torch.launch.serve``) resurrected for
the CNN compiler: a request queue with **dynamic batching** under a
configurable latency budget, executing whole batches through the
batched group executables of :meth:`CompiledArtifact.run
<repro_torch.api.artifact.CompiledArtifact.run>` (``batch_mode="vmap"``), an
artifact LRU keyed ``(model, CompileOptions.cache_key())``, and an
open-loop load generator for the ``BENCH_serve.json`` trajectory.

Observability is two-layered: post-hoc traces still hang
off the tracer — counters land in the same Chrome trace as the
compile spans — while *live* aggregates (queue depth, lifecycle-stage
latency histograms, rejection causes, batch occupancy) go to the
engine's :class:`~repro_torch.instrument.MetricsRegistry`
(:meth:`ServeEngine.metrics` / :meth:`ServeEngine.flight_records`).
The registry is the serving layer's one aggregation path: the load
generator and ``benchmarks/serve_bench.py`` consume counter deltas and
snapshots from it rather than diffing ad-hoc stats dicts.
"""
from .cache import ArtifactCache
from .engine import ServeConfig, ServeEngine
from .loadgen import LoadReport, run_load

__all__ = [
    "ArtifactCache",
    "LoadReport",
    "ServeConfig",
    "ServeEngine",
    "run_load",
]
