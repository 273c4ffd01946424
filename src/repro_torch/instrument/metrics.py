"""Live aggregated telemetry: a zero-dependency metrics registry.

The tracer answers "what happened, in order" — a post-hoc Chrome
trace of one compile/run.  This module answers "what is happening,
in aggregate": labeled counters, gauges, and latency histograms that
a serving engine can update from its worker thread while a load
generator (or an operator) reads consistent snapshots from another.
Prometheus invented nothing here — this is the standard three-kind
model (counter / gauge / histogram with cumulative ``le`` buckets),
implemented dependency-free the way the rest of ``repro_torch.instrument``
is, with the same governing contract as the tracer:

* every instrument is **thread-safe** (one registry lock covers
  update + snapshot — updates are a few dict ops, never worth a
  finer-grained scheme);
* :data:`NULL_REGISTRY` is the ambient default and a true no-op — a
  shared null instrument whose ``inc``/``set``/``observe`` do nothing,
  so uninstrumented runs allocate nothing and stay byte-identical
  (pinned by ``tests/test_metrics.py``, same discipline as
  :data:`repro_torch.instrument.tracer.NULL_TRACER`);
* producers never import consumers: the registry knows nothing about
  engines or kernels.  The series the stack actually emits are
  documented in DESIGN.md §9.

Two export forms: :meth:`MetricsRegistry.snapshot` (a versioned,
JSON-serializable document — the ``BENCH_serve.json`` cells and the CI
artifact carry these) and :meth:`MetricsRegistry.to_prometheus` (the
text exposition format, so a future HTTP front end can serve
``/metrics`` verbatim).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import threading
from typing import Iterator, Mapping, Optional, Sequence

#: fixed exponential latency buckets (milliseconds): 0.25 ms … ~8.2 s,
#: doubling — wide enough to hold both a sub-ms vmapped dispatch and a
#: queue-collapsed open-loop p99, coarse enough that a snapshot stays
#: small.  Shared by every ``*_ms`` histogram the stack emits so
#: series are comparable across engines and runs.
LATENCY_BUCKETS_MS: tuple[float, ...] = tuple(
    0.25 * 2 ** k for k in range(16)
)

#: batch-occupancy buckets: the vmap bucket ladder (powers of two up to
#: the top :data:`repro_torch.kernels.ops.BATCH_BUCKETS` extent)
BATCH_BUCKETS_SIZES: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64)

_KINDS = ("counter", "gauge", "histogram")


def _label_key(label_names: tuple[str, ...], labels: Mapping) -> tuple:
    """The child key for one label assignment, validated against the
    instrument's declared label names — a typo'd label must fail at the
    call site, not silently create a parallel series."""
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(label_names)}"
        )
    return tuple(str(labels[n]) for n in label_names)


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for the disabled path."""

    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def dec(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """The ambient default: every instrument is the shared no-op.

    ``enabled`` is False so hot paths can skip even the cheap calls;
    everything else exists so call sites never branch on registry
    identity (the tracer's exact contract)."""

    enabled = False

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  ) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        """An empty (but schema-valid) document, for export symmetry."""
        return {"version": 1, "counters": {}, "gauges": {}, "histograms": {}}

    def to_prometheus(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()


class _Instrument:
    """One named metric family: label names + per-label-set children.

    Subclasses define the child state and the update verbs.  All state
    mutation happens under the owning registry's lock — instruments are
    handed out once at construction and shared across threads."""

    kind = "base"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: tuple[str, ...]) -> None:
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.label_names = label_names
        self._children: dict[tuple, object] = {}

    def _child(self, labels: Mapping):
        """Get-or-create the child slot for one label assignment.
        Callers hold the lock."""
        key = _label_key(self.label_names, labels)
        child = self._children.get(key)
        if child is None:
            child = self._new_child()
            self._children[key] = child
        return child

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _export_children(self) -> list[dict]:
        out = []
        for key in sorted(self._children):
            row: dict = {"labels": dict(zip(self.label_names, key))}
            row.update(self._export_child(self._children[key]))
            out.append(row)
        return out

    def _export_child(self, child) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Instrument):
    """A monotonically increasing total (requests served, rejections by
    cause).  Decrementing is an error — that is what gauges are for."""

    kind = "counter"

    def _new_child(self) -> list:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name}: inc({amount}) — counters only go up"
            )
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            key = _label_key(self.label_names, labels)
            child = self._children.get(key)
            return child[0] if child else 0.0

    def total(self) -> float:
        """The sum over every label assignment."""
        with self._lock:
            return sum(c[0] for c in self._children.values())

    def _export_child(self, child) -> dict:
        return {"value": child[0]}


class Gauge(_Instrument):
    """A value that goes both ways (queue depth, in-flight batches)."""

    kind = "gauge"

    def _new_child(self) -> list:
        return [0.0]

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._child(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            key = _label_key(self.label_names, labels)
            child = self._children.get(key)
            return child[0] if child else 0.0

    def _export_child(self, child) -> dict:
        return {"value": child[0]}


class Histogram(_Instrument):
    """A distribution over fixed buckets (latency, batch occupancy).

    Buckets are **upper bounds** with Prometheus ``le`` semantics: an
    observation lands in every bucket whose bound is ≥ the value
    (cumulative counts), with an implicit ``+Inf`` bucket equal to the
    total count.  Bounds are fixed at construction — exponential
    latency ladders by default — so merging/diffing snapshots never
    has to re-bucket."""

    kind = "histogram"

    def __init__(self, registry, name, help, label_names,
                 buckets: Sequence[float]) -> None:
        super().__init__(registry, name, help, label_names)
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name}: bucket bounds must strictly increase, "
                f"got {bounds}"
            )
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError(
                f"histogram {name}: bounds must be finite (+Inf is "
                f"implicit), got {bounds}"
            )
        self.buckets = bounds

    def _new_child(self) -> dict:
        return {"counts": [0] * len(self.buckets), "inf": 0,
                "sum": 0.0, "count": 0, "min": None, "max": None}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            c = self._child(labels)
            c["sum"] += v
            c["count"] += 1
            c["min"] = v if c["min"] is None else min(c["min"], v)
            c["max"] = v if c["max"] is None else max(c["max"], v)
            # non-cumulative per-bucket counts internally; snapshot
            # accumulates them into le-form so hot-path observes stay O(1)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    c["counts"][i] += 1
                    return
            c["inf"] += 1

    def value(self, **labels) -> float:
        """The observation count (symmetry with counter/gauge)."""
        with self._lock:
            key = _label_key(self.label_names, labels)
            child = self._children.get(key)
            return child["count"] if child else 0.0

    def _export_child(self, child) -> dict:
        cum = []
        running = 0
        for bound, n in zip(self.buckets, child["counts"]):
            running += n
            cum.append({"le": bound, "count": running})
        cum.append({"le": "+Inf", "count": running + child["inf"]})
        return {
            "count": child["count"],
            "sum": round(child["sum"], 6),
            "min": child["min"],
            "max": child["max"],
            "buckets": cum,
        }


def quantile(hist_row: Mapping, q: float) -> float:
    """Estimate the ``q``-quantile (0..100) from one exported histogram
    row (``{"count": ..., "buckets": [{"le": ..., "count": ...}]}``) by
    linear interpolation within the landing bucket — the standard
    ``histogram_quantile`` estimate.  Returns 0.0 for empty rows; the
    ``+Inf`` bucket clamps to the largest finite bound (or the observed
    ``max`` when present)."""
    if not 0 <= q <= 100:
        raise ValueError(f"quantile must be in [0, 100], got {q}")
    total = hist_row.get("count", 0)
    buckets = hist_row.get("buckets") or []
    if not total or not buckets:
        return 0.0
    rank = q / 100.0 * total
    prev_bound, prev_count = 0.0, 0
    for b in buckets:
        bound, count = b["le"], b["count"]
        if bound == "+Inf":
            mx = hist_row.get("max")
            return float(mx if mx is not None else prev_bound)
        if count >= rank:
            if count == prev_count:
                return float(bound)
            frac = (rank - prev_count) / (count - prev_count)
            return float(prev_bound + frac * (bound - prev_bound))
        prev_bound, prev_count = bound, count
    return float(prev_bound)


class MetricsRegistry:
    """Threadsafe home of one process-area's instruments.

    Instruments are created once (``counter``/``gauge``/``histogram``
    are get-or-create: re-declaring the same name with the same kind
    and labels returns the existing instrument; with different ones it
    raises) and updated from any thread.  ``snapshot()`` returns a
    consistent point-in-time JSON document; ``to_prometheus()`` the
    text exposition."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    # -- declaration ---------------------------------------------------------

    def _declare(self, cls, name: str, help: str,
                 label_names: tuple[str, ...], **kwargs):
        if not name or not isinstance(name, str):
            raise ValueError(f"metric name must be a non-empty string, "
                             f"got {name!r}")
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.label_names != label_names
                        or kwargs.get("buckets") is not None
                        and getattr(existing, "buckets", None)
                        != tuple(float(b) for b in kwargs["buckets"])):
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{existing.kind} with labels "
                        f"{existing.label_names}"
                    )
                return existing
            inst = cls(self, name, help, label_names, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self._declare(Histogram, name, help, tuple(labels),
                             buckets=buckets)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """A consistent point-in-time export: ``{"version": 1,
        "counters": {...}, "gauges": {...}, "histograms": {...}}``,
        every leaf JSON-serializable (validated shape — see
        :func:`validate_metrics_snapshot`)."""
        with self._lock:
            doc: dict = {"version": 1, "counters": {}, "gauges": {},
                         "histograms": {}}
            for name, inst in sorted(self._instruments.items()):
                entry: dict = {
                    "help": inst.help,
                    "labels": list(inst.label_names),
                    "values": inst._export_children(),
                }
                if isinstance(inst, Histogram):
                    entry["buckets"] = list(inst.buckets)
                doc[inst.kind + "s"][name] = entry
            return doc

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (version 0.0.4):
        ``# HELP`` / ``# TYPE`` headers, one sample line per child,
        histograms expanded to ``_bucket{le=...}`` / ``_sum`` /
        ``_count`` series."""
        snap = self.snapshot()
        lines: list[str] = []

        def fmt_labels(labels: Mapping, extra: Optional[dict] = None) -> str:
            items = dict(labels)
            if extra:
                items.update(extra)
            if not items:
                return ""
            inner = ",".join(
                f'{k}="{_escape(str(v))}"' for k, v in items.items()
            )
            return "{" + inner + "}"

        def _escape(s: str) -> str:
            return s.replace("\\", r"\\").replace('"', r"\"") \
                    .replace("\n", r"\n")

        for kind in _KINDS:
            for name, entry in snap[kind + "s"].items():
                if entry["help"]:
                    lines.append(f"# HELP {name} {entry['help']}")
                lines.append(f"# TYPE {name} {kind}")
                for row in entry["values"]:
                    if kind == "histogram":
                        for b in row["buckets"]:
                            le = ("+Inf" if b["le"] == "+Inf"
                                  else repr(float(b["le"])))
                            lines.append(
                                f"{name}_bucket"
                                f"{fmt_labels(row['labels'], {'le': le})} "
                                f"{b['count']}"
                            )
                        lines.append(
                            f"{name}_sum{fmt_labels(row['labels'])} "
                            f"{row['sum']}"
                        )
                        lines.append(
                            f"{name}_count{fmt_labels(row['labels'])} "
                            f"{row['count']}"
                        )
                    else:
                        lines.append(
                            f"{name}{fmt_labels(row['labels'])} "
                            f"{row['value']}"
                        )
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Ambient registry (contextvar-threaded, the tracer's exact pattern)
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_metrics", default=NULL_REGISTRY
)


def current():
    """The ambient registry — :data:`NULL_REGISTRY` unless
    :func:`use_metrics` is active on this context."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_metrics(registry) -> Iterator:
    """Install ``registry`` as the ambient metrics registry for the
    dynamic extent.  ``None`` (or the already-installed registry) is a
    no-op scope, mirroring :func:`repro_torch.instrument.use_tracer`."""
    if registry is None or registry is _CURRENT.get():
        yield registry
        return
    token = _CURRENT.set(registry)
    try:
        yield registry
    finally:
        _CURRENT.reset(token)


# ---------------------------------------------------------------------------
# Snapshot schema validation (the CI artifact gate)
# ---------------------------------------------------------------------------


def validate_metrics_snapshot(obj) -> dict:
    """Validate a :meth:`MetricsRegistry.snapshot` document.  Raises
    :class:`ValueError` naming the first offence; returns ``obj``
    unchanged on success — the same contract as
    :func:`repro_torch.instrument.validate_chrome_trace`."""
    if not isinstance(obj, dict):
        raise ValueError(
            f"metrics snapshot: expected dict, got {type(obj).__name__}"
        )
    if obj.get("version") != 1:
        raise ValueError(
            f"metrics snapshot: unknown version {obj.get('version')!r}"
        )
    for kind in _KINDS:
        section = obj.get(kind + "s")
        if not isinstance(section, dict):
            raise ValueError(f"metrics snapshot: missing {kind}s section")
        for name, entry in section.items():
            where = f"metrics snapshot: {kind} {name!r}"
            if not isinstance(entry, dict):
                raise ValueError(f"{where} is not an object")
            if not isinstance(entry.get("labels"), list):
                raise ValueError(f"{where}: missing labels list")
            values = entry.get("values")
            if not isinstance(values, list):
                raise ValueError(f"{where}: missing values list")
            for row in values:
                if not isinstance(row.get("labels"), dict):
                    raise ValueError(f"{where}: row missing labels dict")
                if sorted(row["labels"]) != sorted(entry["labels"]):
                    raise ValueError(
                        f"{where}: row labels {sorted(row['labels'])} != "
                        f"declared {sorted(entry['labels'])}"
                    )
                if kind == "histogram":
                    for k in ("count", "sum", "buckets"):
                        if k not in row:
                            raise ValueError(f"{where}: row missing {k!r}")
                    buckets = row["buckets"]
                    if not buckets or buckets[-1]["le"] != "+Inf":
                        raise ValueError(
                            f"{where}: bucket list must end with +Inf"
                        )
                    counts = [b["count"] for b in buckets]
                    if counts != sorted(counts):
                        raise ValueError(
                            f"{where}: bucket counts must be cumulative"
                        )
                    if counts[-1] != row["count"]:
                        raise ValueError(
                            f"{where}: +Inf count {counts[-1]} != "
                            f"count {row['count']}"
                        )
                else:
                    if not isinstance(row.get("value"), (int, float)):
                        raise ValueError(f"{where}: row missing numeric value")
    return obj
