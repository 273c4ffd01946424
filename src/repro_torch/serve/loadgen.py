"""Open-loop load generator + latency report for the serve engine.

Open-loop means arrivals follow the offered schedule regardless of how
the server is doing — the methodology that actually exposes queueing
collapse (a closed loop self-throttles and flatters p99).  Arrival
times are deterministic under ``seed`` (uniform spacing at the offered
QPS); inputs are seeded small-integer tensors matching the artifact's
compiled input shapes, same value model as
:func:`repro_torch.passes.interp.random_env`.

Saturation is data, not a crash: when admission rejects an arrival
(:class:`queue.Full`) the generator records the rejection and keeps to
its schedule — rejected arrivals are *excluded* from the latency
distribution (they have no completion) but counted in the report, so an
overloaded run reads as "p99 exploded, rejects nonzero" instead of a
stack trace.  Counters come from the engine's metrics registry when it
is enabled (the ``serve_*_total`` series), falling back to the legacy
``engine.stats`` snapshot otherwise.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import time
from typing import Optional

import numpy as np


def _percentile(sorted_ms: list, q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_ms:
        return 0.0
    idx = min(len(sorted_ms) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_ms) - 1)))))
    return sorted_ms[idx]


@dataclasses.dataclass
class LoadReport:
    """One load level's outcome — a row of ``BENCH_serve.json``.

    ``requests`` counts *served* requests; ``rejected`` the arrivals
    admission turned away (their latencies are not in the
    distribution)."""

    offered_qps: float
    achieved_qps: float
    requests: int
    duration_s: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    mean_batch: float
    batches: int
    rejected: int

    def row(self) -> dict:
        return {
            "offered_qps": round(self.offered_qps, 3),
            "achieved_qps": round(self.achieved_qps, 3),
            "requests": self.requests,
            "duration_s": round(self.duration_s, 4),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "mean_ms": round(self.mean_ms, 3),
            "mean_batch": round(self.mean_batch, 3),
            "batches": self.batches,
            "rejected": self.rejected,
        }


def _counter_deltas(engine):
    """Start-of-run counter baseline: registry series when enabled
    (one aggregation path, satellite of the metrics registry), legacy
    stats snapshot otherwise.  Returns a closure producing
    ``(batches, rejected)`` deltas."""
    reg = getattr(engine, "registry", None)
    if reg is not None and reg.enabled:
        c_batches = reg.counter("serve_batches_total")
        c_rejected = reg.counter("serve_rejected_total", labels=("cause",))
        b0, r0 = c_batches.value(), c_rejected.total()
        return lambda: (int(c_batches.value() - b0),
                        int(c_rejected.total() - r0))
    stats0 = engine.stats
    return lambda: (engine.stats["batches"] - stats0["batches"],
                    engine.stats["rejected"] - stats0["rejected"])


def run_load(engine, *, offered_qps: float, requests: int,
             seed: int = 0, inputs: Optional[list] = None) -> LoadReport:
    """Drive ``engine`` with ``requests`` arrivals at ``offered_qps``
    (uniform spacing, open-loop: the generator sleeps to each arrival
    time and never waits on results mid-run).  Returns the latency
    report; per-request latency is completion minus *intended* arrival,
    so generator scheduling jitter does not flatter the server.
    """
    if offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {offered_qps}")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    src = engine.artifact.source
    rng = np.random.default_rng(seed)
    if inputs is None:
        inputs = []
        for _ in range(min(requests, 16)):  # rotate a small input pool
            inputs.append({
                k: rng.integers(-4, 5, size=src.values[k].shape,
                                dtype=np.int32)
                for k in src.graph_inputs
            })
    gap = 1.0 / offered_qps
    deltas = _counter_deltas(engine)
    done_at: list = [None] * requests
    futures = []
    rejected_local = 0
    t_start = time.perf_counter()
    for i in range(requests):
        arrival = t_start + i * gap
        delay = arrival - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            fut = engine.submit(inputs[i % len(inputs)])
        except queue_mod.Full:
            # saturation: admission said no — record it and hold the
            # open-loop schedule (do NOT retry; that would close the loop)
            rejected_local += 1
            continue

        def _stamp(f, i=i):
            done_at[i] = time.perf_counter()

        fut.add_done_callback(_stamp)
        futures.append((arrival, i, fut))
    for _, _, fut in futures:
        fut.result()  # surface worker exceptions loudly
    t_end = time.perf_counter()
    lat_ms = sorted(
        (done_at[i] - arrival) * 1e3 for arrival, i, _ in futures
    )
    duration = t_end - t_start
    served = len(futures)
    batches, rejected_counted = deltas()
    return LoadReport(
        offered_qps=offered_qps,
        achieved_qps=served / duration if duration > 0 else 0.0,
        requests=served,
        duration_s=duration,
        p50_ms=_percentile(lat_ms, 50),
        p99_ms=_percentile(lat_ms, 99),
        mean_ms=sum(lat_ms) / len(lat_ms) if lat_ms else 0.0,
        mean_batch=served / batches if batches else 0.0,
        batches=batches,
        rejected=max(rejected_counted, rejected_local),
    )
