"""Dynamic-batching serve engine over one compiled artifact.

Requests enqueue per-sample inputs; a single worker thread drains the
queue into batches — up to :attr:`ServeConfig.max_batch` requests, or
whatever arrived before the *latency budget* measured from the first
queued request expires — and executes each batch as **one** batched
device dispatch per group (``CompiledArtifact.run(...,
batch_mode="vmap")``).  Under light load a request ships almost alone
(latency ≈ budget + one-sample execute); under heavy load batches fill
to ``max_batch`` and throughput rides the batched executables.  This is
the classic dynamic-batching contract (hls4ml's deployment benches,
Venieris' toolflow survey) on top of our bucketed executable cache: batch
sizes land on :data:`repro_torch.kernels.ops.BATCH_BUCKETS`, so steady-state
traffic never rebuilds an executable.

Observability is two-layered.  The tracer still gets its post-hoc
series (``serve_batch`` / ``serve_latency_ms`` / ``serve_qps`` plus a
``serve:batch`` span per dispatch, in the *same* trace as the compile
spans).  Live aggregates go to a
:class:`repro_torch.instrument.MetricsRegistry`: every request carries an id
and moves through four lifecycle stages — **queue-wait** (submit →
worker dequeue), **batch-form** (dequeue → batch sealed), **execute**
(stack + device dispatch), **respond** (future fan-out) — each recorded
as a ``serve_stage_ms{stage=...}`` histogram, alongside queue-depth and
in-flight gauges, a batch-occupancy histogram, and rejection counters
by cause.  A bounded flight recorder keeps the last N batch records for
post-mortems (:meth:`ServeEngine.flight_records`).  Pass
``registry=NULL_REGISTRY`` to switch all of it off; outputs are
byte-identical either way (pinned by ``tests/test_metrics.py``).
Contextvars do not cross threads, so the worker re-installs the
engine's tracer explicitly (:func:`repro_torch.instrument.use_tracer`).

The device boundary: ``device=None`` is the CUDA card (no card → an
error at ``start()``).  Constants are resolved **and moved to the device
once** in ``start()``, never per batch; the worker thread selects the
device for itself and launches on its own current stream; a batch's
``execute`` stage ends after the device has finished, because the
output's conversion to NumPy at the boundary waits for it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, Optional

import numpy as np

from repro_torch import instrument
from repro_torch.instrument import metrics as metrics_mod


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the dynamic batcher.

    ``max_batch`` caps the per-dispatch batch (keep it on a
    :data:`~repro_torch.kernels.ops.BATCH_BUCKETS` bucket or the runner pads
    up to the next one); ``latency_budget_ms`` is how long the first
    request of a forming batch may wait for company; ``queue_depth``
    bounds admission — a full queue rejects instead of hiding unbounded
    latency; ``flight_records`` bounds the post-mortem ring of recent
    batch records (0 disables it)."""

    max_batch: int = 32
    latency_budget_ms: float = 5.0
    queue_depth: int = 1024
    flight_records: int = 64

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.latency_budget_ms < 0:
            raise ValueError("latency_budget_ms must be >= 0, got "
                             f"{self.latency_budget_ms}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.flight_records < 0:
            raise ValueError(
                f"flight_records must be >= 0, got {self.flight_records}")


@dataclasses.dataclass
class _Request:
    req_id: int
    inputs: dict
    future: Future
    t_submit: float


_STOP = object()


class ServeEngine:
    """Serve one :class:`~repro_torch.api.artifact.CompiledArtifact`.

    Use as a context manager (or ``start()``/``stop()``)::

        with ServeEngine(artifact, ServeConfig(max_batch=32)) as eng:
            fut = eng.submit(x)          # per-sample input, no batch dim
            y = fut.result()

    ``submit`` returns a :class:`concurrent.futures.Future`;
    ``__call__`` is the blocking sugar.  ``params`` fixes the constant
    bindings (weights) for every request of this engine — serving mixes
    *inputs*, never weights.

    ``registry`` is the engine's metrics home: by default each engine
    owns a fresh :class:`~repro_torch.instrument.MetricsRegistry` (so
    :meth:`metrics` always has something to say); pass
    :data:`~repro_torch.instrument.NULL_REGISTRY` to disable instrumentation
    entirely, or share one registry across engines to aggregate.
    """

    def __init__(self, artifact, config: Optional[ServeConfig] = None, *,
                 params: Optional[Mapping] = None,
                 device=None, seed: int = 0,
                 registry=None) -> None:
        self.artifact = artifact
        self.config = config or ServeConfig()
        self.params = params
        self.device = device
        self._device = None  # resolved at start()
        self.seed = seed
        self.registry = (metrics_mod.MetricsRegistry()
                         if registry is None else registry)
        self._queue: "queue.Queue" = queue.Queue(self.config.queue_depth)
        self._worker: Optional[threading.Thread] = None
        self._stopping = False
        self._tracer = None
        # the worker thread mutates these while callers read them (the
        # load generator diffs before/after): one lock guards the dict,
        # the public `stats` property hands out snapshots
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "rejected": 0,
                       "max_batch_seen": 0}
        self._req_ids = itertools.count()
        self._flight: "collections.deque" = collections.deque(
            maxlen=self.config.flight_records or None
        )
        self._t_start: Optional[float] = None
        self._declare_metrics()

    def _declare_metrics(self) -> None:
        """Declare the serve series once, up front — a snapshot taken
        before any traffic still lists every family (empty families are
        how dashboards learn the schema)."""
        reg = self.registry
        self._m_requests = reg.counter(
            "serve_requests_total", "requests admitted")
        self._m_batches = reg.counter(
            "serve_batches_total", "batches dispatched")
        self._m_rejected = reg.counter(
            "serve_rejected_total", "requests rejected by cause",
            labels=("cause",))
        self._m_queue_depth = reg.gauge(
            "serve_queue_depth", "requests waiting for a batch")
        self._m_inflight = reg.gauge(
            "serve_inflight_batches", "batches currently executing")
        self._m_stage_ms = reg.histogram(
            "serve_stage_ms", "per-request lifecycle stage latency (ms)",
            labels=("stage",))
        self._m_latency_ms = reg.histogram(
            "serve_request_latency_ms",
            "submit-to-response latency (ms)")
        self._m_occupancy = reg.histogram(
            "serve_batch_occupancy", "requests per dispatched batch",
            buckets=metrics_mod.BATCH_BUCKETS_SIZES)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeEngine":
        if self._worker is not None:
            raise RuntimeError(
                f"{self.artifact.source.name}: engine already started"
            )
        # capture the tracer on the *caller's* context: the ambient one
        # if enabled (same trace as everything else this thread did),
        # else the artifact's compile-time tracer.  The worker thread
        # re-installs it — contextvars do not propagate into threads.
        ambient = instrument.current()
        self._tracer = ambient if ambient.enabled else self.artifact.tracer
        # resolve constants once: user params + seeded fill for the
        # rest — re-deriving random_env per batch would put RNG work on
        # the hot path (and is why this isn't left to artifact.run)
        from repro_torch.device import env_to_device, resolve_device
        from repro_torch.passes import interp

        self._device = resolve_device(self.device)  # no card → raises here
        src = self.artifact.source
        resolved = dict(self.params or {})
        consts = {n for n, v in src.values.items() if v.is_constant}
        missing = consts - set(resolved)
        if missing:
            env = interp.random_env(src, seed=self.seed,
                                    device=self._device)
            resolved.update({n: env[n] for n in missing})
        # on the device once, here — a batch only moves its inputs
        self._params_resolved = env_to_device(resolved, self._device)
        self._t_start = time.perf_counter()
        self._stopping = False
        self._worker = threading.Thread(
            target=self._serve_loop, name="repro-serve", daemon=True
        )
        self._worker.start()
        return self

    def stop(self) -> None:
        """Stop the worker, then *drain* the queue: any request still
        queued (admitted behind the stop signal, or racing shutdown)
        fails its future with :class:`RuntimeError` instead of leaving
        the caller blocked on ``fut.result()`` forever."""
        if self._worker is None:
            return
        self._stopping = True  # new submits reject from here on
        self._queue.put(_STOP)
        self._worker.join()
        self._worker = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            self._bump("rejected")
            if self.registry.enabled:
                self._m_rejected.inc(cause="shutdown")
                self._m_queue_depth.dec()
            item.future.set_exception(RuntimeError(
                f"{self.artifact.source.name}: engine stopped before the "
                "request was served"
            ))

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- stats & metrics -----------------------------------------------------

    @property
    def stats(self) -> dict:
        """A point-in-time copy of the legacy counters dict
        (``requests`` / ``batches`` / ``rejected`` /
        ``max_batch_seen``).  A *copy*: the worker keeps mutating the
        backing dict under its lock, so callers never see a torn read —
        and writes to the returned dict change nothing."""
        with self._stats_lock:
            return dict(self._stats)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def metrics(self) -> dict:
        """The engine registry's :meth:`snapshot` document (empty but
        schema-valid when the engine runs with ``NULL_REGISTRY``)."""
        return self.registry.snapshot()

    def flight_records(self) -> list:
        """The last N batch records, oldest first: per-batch dicts of
        ``{"batch_id", "request_ids", "n", "outcome",
        "queue_wait_ms", "batch_form_ms", "execute_ms", "respond_ms"}``
        (stage times in milliseconds; queue-wait is the mean over the
        batch's requests).  Bounded by
        :attr:`ServeConfig.flight_records`."""
        return list(self._flight)

    # -- request path --------------------------------------------------------

    def submit(self, inputs) -> Future:
        """Enqueue one sample (bare array, or ``{name: array}`` for
        multi-input graphs — per-sample shapes, no batch dim).  Keys
        and per-sample shapes are validated *here*, at admission: a
        malformed request must reject its own caller, never poison the
        innocent requests it would have co-batched with at
        ``np.stack`` time.  Raises :class:`queue.Full` when admission
        is over ``queue_depth``."""
        if self._worker is None or self._stopping:
            raise RuntimeError(
                f"{self.artifact.source.name}: engine not started — "
                "use `with engine:`"
            )
        src = self.artifact.source
        try:
            if not isinstance(inputs, Mapping):
                if len(src.graph_inputs) != 1:
                    raise ValueError(
                        f"{src.name} has {len(src.graph_inputs)} inputs "
                        f"({src.graph_inputs}); pass a dict, not a bare "
                        "array"
                    )
                inputs = {src.graph_inputs[0]: inputs}
            missing = set(src.graph_inputs) - set(inputs)
            unknown = set(inputs) - set(src.graph_inputs)
            if missing or unknown:
                raise ValueError(
                    f"{src.name}: request must bind exactly the graph "
                    f"inputs {list(src.graph_inputs)}"
                    + (f" — missing {sorted(missing)}" if missing else "")
                    + (f" — unknown {sorted(unknown)}" if unknown else "")
                )
            arrays = {}
            for k in src.graph_inputs:
                v = np.asarray(inputs[k])
                want = tuple(src.values[k].shape)
                if v.shape != want:
                    raise ValueError(
                        f"{src.name}: input {k!r} has shape {v.shape}; "
                        f"expected the per-sample shape {want} "
                        "(no batch dim)"
                    )
                arrays[k] = v
        except ValueError:
            if self.registry.enabled:
                self._m_rejected.inc(cause="invalid")
            raise
        req = _Request(next(self._req_ids), arrays, Future(),
                       time.perf_counter())
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._bump("rejected")
            if self.registry.enabled:
                self._m_rejected.inc(cause="queue_full")
            raise queue.Full(
                f"{src.name}: admission queue full "
                f"(queue_depth={self.config.queue_depth})"
            ) from None
        if self.registry.enabled:
            self._m_queue_depth.inc()
        return req.future

    def __call__(self, inputs):
        return self.submit(inputs).result()

    # -- worker --------------------------------------------------------------

    def _serve_loop(self) -> None:
        try:
            if self._device.type == "cuda":
                import torch

                # the device is per-thread state: select it in the
                # worker, whose kernel launches go to this thread's
                # current stream
                torch.cuda.set_device(self._device)
            self._serve_batches()
        except BaseException as exc:
            # a worker that dies must not leave callers blocked on their
            # futures: reject new submits and fail whatever is queued
            self._stopping = True
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    item.future.set_exception(RuntimeError(
                        f"{self.artifact.source.name}: serve worker died: "
                        f"{type(exc).__name__}: {exc}"))
            raise

    def _serve_batches(self) -> None:
        with instrument.use_tracer(self._tracer):
            tracer = instrument.current()
            while True:
                item = self._queue.get()
                if item is _STOP:
                    return
                t_dequeue = time.perf_counter()
                batch = [item]
                deadline = t_dequeue + self.config.latency_budget_ms / 1e3
                while len(batch) < self.config.max_batch:
                    wait = deadline - time.perf_counter()
                    if wait <= 0:
                        # budget spent: take whatever already queued,
                        # but don't wait for more
                        try:
                            nxt = self._queue.get_nowait()
                        except queue.Empty:
                            break
                    else:
                        try:
                            nxt = self._queue.get(timeout=wait)
                        except queue.Empty:
                            break
                    if nxt is _STOP:
                        self._execute(batch, tracer, t_dequeue)
                        return
                    batch.append(nxt)
                self._execute(batch, tracer, t_dequeue)

    def _execute(self, batch: list, tracer, t_dequeue: float) -> None:
        src = self.artifact.source
        reg = self.registry
        n = len(batch)
        t_sealed = time.perf_counter()
        if reg.enabled:
            self._m_queue_depth.dec(n)
            self._m_inflight.inc()
            self._m_occupancy.observe(n)
        outcome = "ok"
        try:
            stacked = {
                k: np.stack([r.inputs[k] for r in batch])
                for k in src.graph_inputs
            }
            with tracer.span("serve:batch", cat="serve",
                             args={"batch": n}):
                out = self.artifact.run(
                    stacked, self._params_resolved,
                    device=self._device, seed=self.seed,
                )
            if len(src.graph_outputs) == 1:
                rows = [out[i] for i in range(n)]
            else:
                rows = [{k: v[i] for k, v in out.items()} for i in range(n)]
        except Exception as exc:  # propagate to every caller, keep serving
            outcome = f"error:{type(exc).__name__}"
            t_exec_end = time.perf_counter()
            for r in batch:
                r.future.set_exception(exc)
            self._finish_batch(batch, tracer, t_dequeue, t_sealed,
                               t_exec_end, time.perf_counter(), outcome)
            return
        t_exec_end = time.perf_counter()
        self._bump("requests", n)
        self._bump("batches")
        with self._stats_lock:
            self._stats["max_batch_seen"] = max(
                self._stats["max_batch_seen"], n)
        for r in batch:
            r.future.set_result(rows.pop(0))
        t_respond = time.perf_counter()
        if tracer.enabled:
            tracer.counter("serve_batch", {"size": n})
            for r in batch:
                tracer.counter(
                    "serve_latency_ms",
                    {"ms": (t_exec_end - r.t_submit) * 1e3}
                )
            elapsed = t_exec_end - (self._t_start or t_exec_end)
            if elapsed > 0:
                with self._stats_lock:
                    served = self._stats["requests"]
                tracer.counter("serve_qps", {"qps": served / elapsed})
        self._finish_batch(batch, tracer, t_dequeue, t_sealed,
                           t_exec_end, t_respond, outcome)

    def _finish_batch(self, batch, tracer, t_dequeue, t_sealed,
                      t_exec_end, t_respond, outcome: str) -> None:
        """Record lifecycle metrics + one flight record for a finished
        (served or failed) batch."""
        reg = self.registry
        n = len(batch)
        waits_ms = [(t_dequeue - r.t_submit) * 1e3 for r in batch]
        form_ms = (t_sealed - t_dequeue) * 1e3
        exec_ms = (t_exec_end - t_sealed) * 1e3
        respond_ms = (t_respond - t_exec_end) * 1e3
        if reg.enabled:
            self._m_inflight.dec()
            if outcome == "ok":
                self._m_requests.inc(n)
                self._m_batches.inc()
            else:
                self._m_rejected.inc(n, cause="execute_error")
            for w in waits_ms:
                self._m_stage_ms.observe(w, stage="queue_wait")
            self._m_stage_ms.observe(form_ms, stage="batch_form")
            self._m_stage_ms.observe(exec_ms, stage="execute")
            self._m_stage_ms.observe(respond_ms, stage="respond")
            if outcome == "ok":
                for r in batch:
                    self._m_latency_ms.observe(
                        (t_respond - r.t_submit) * 1e3)
        if self.config.flight_records:
            self._flight.append({
                "batch_id": self.stats["batches"],
                "request_ids": [r.req_id for r in batch],
                "n": n,
                "outcome": outcome,
                "queue_wait_ms": round(sum(waits_ms) / n, 4),
                "batch_form_ms": round(form_ms, 4),
                "execute_ms": round(exec_ms, 4),
                "respond_ms": round(respond_ms, 4),
            })
