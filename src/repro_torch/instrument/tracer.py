"""Span tracing + metrics for the compile/run stack (zero-dependency).

MLIR ships its automation with instrumentation — ``-mlir-timing``,
``-print-ir-after-all``, pass statistics — and this module is our
equivalent, one layer the whole stack threads through:

* :class:`Tracer` — span-based (monotonic clock, nestable), plus
  instant events and counter samples, accumulated as Chrome
  trace-event dicts (the ``chrome://tracing`` / Perfetto format, see
  :func:`validate_chrome_trace`).
* a :mod:`contextvars` ambient slot — :func:`use_tracer` installs a
  tracer for a dynamic extent, :func:`current` reads it.  When nothing
  is installed, :data:`NULL_TRACER` is returned: every operation is a
  true no-op (shared null span, discarded args), so uninstrumented
  runs stay byte-identical in output and pay no event allocation.

Producers never import consumers: the tracer knows nothing about the
IR, passes, or kernels — they call ``current().span(...)`` /
``instant`` / ``counter`` and attach whatever args they like.  The
taxonomy actually emitted by the stack is documented in DESIGN.md §6.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import time
from typing import Any, Callable, Iterator, Mapping, Optional

#: categories the stack emits (informative, not enforced — see DESIGN.md §6)
CATEGORIES = ("compile", "passes", "partition", "analyze", "dse", "emit",
              "runtime")

#: Chrome trace-event phases this layer produces (and the validator's
#: accepted superset — "B"/"E" pairs appear in externally-merged traces)
_PHASES = {"X", "i", "I", "C", "M", "B", "E"}


class _DiscardDict(dict):
    """A write-sink: the null span hands this out so callers can attach
    span args unconditionally without the disabled path accumulating
    anything (or allocating a fresh dict per span)."""

    def __setitem__(self, key, value):  # pragma: no cover - trivial
        pass

    def update(self, *a, **kw):
        pass


_DISCARD = _DiscardDict()


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> Mapping:
        return _DISCARD

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The ambient default: every call is a no-op.

    ``enabled`` is False so hot loops can skip even the cheap calls
    (``if tracer.enabled: ...``); everything else exists so call sites
    never branch on tracer identity.
    """

    enabled = False
    ir_snapshots = False

    def span(self, name: str, *, cat: str = "compile",
             args: Optional[Mapping] = None) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, *, cat: str = "compile",
                args: Optional[Mapping] = None) -> None:
        pass

    def counter(self, name: str, values: Mapping[str, float], *,
                cat: str = "runtime") -> None:
        pass

    def to_chrome(self, *, provenance: Optional[Mapping] = None) -> dict:
        """An empty (but schema-valid) trace, for export symmetry."""
        return {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}


NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace events against one monotonic time base.

    ``span(name)`` is a context manager timing its body as a complete
    ("X") event; it yields the event's ``args`` dict so the body can
    attach statistics discovered *during* the span::

        with tracer.span("pass:fusion", cat="passes") as args:
            stats = run()
            args.update(stats)

    Spans nest naturally (same pid/tid, enclosing ts/dur).  ``instant``
    records a point event carrying structured args (the DP search
    statistics ride one of these); ``counter`` records a sampled value
    series (jit-cache hits, DMA bytes).

    ``ir_snapshots=True`` asks the PassManager for
    ``-print-ir-after-all`` behaviour: a structural snapshot + diff per
    pass (see :mod:`repro_torch.instrument.snapshot`) attached to the pass's
    ``ir_after`` instant events.
    """

    enabled = True

    def __init__(self, *, ir_snapshots: bool = False,
                 clock: Callable[[], int] = time.perf_counter_ns) -> None:
        self.ir_snapshots = ir_snapshots
        self.events: list[dict] = []
        self._clock = clock
        self._t0 = clock()
        self.meta: dict[str, Any] = {}

    # -- time base -----------------------------------------------------------

    def _us(self, t_ns: int) -> float:
        """Nanoseconds-since-epoch → µs relative to tracer start (the
        Chrome trace ``ts`` unit)."""
        return round((t_ns - self._t0) / 1e3, 3)

    def now_us(self) -> float:
        return self._us(self._clock())

    # -- event producers -----------------------------------------------------

    @contextlib.contextmanager
    def _span_cm(self, name: str, cat: str,
                 args: Optional[Mapping]) -> Iterator[dict]:
        payload: dict = dict(args) if args else {}
        t0 = self._clock()
        try:
            yield payload
        finally:
            t1 = self._clock()
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": self._us(t0),
                "dur": round((t1 - t0) / 1e3, 3),
                "pid": 1, "tid": 1, "args": payload,
            })

    def span(self, name: str, *, cat: str = "compile",
             args: Optional[Mapping] = None):
        return self._span_cm(name, cat, args)

    def instant(self, name: str, *, cat: str = "compile",
                args: Optional[Mapping] = None) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now_us(), "pid": 1, "tid": 1,
            "args": dict(args) if args else {},
        })

    def counter(self, name: str, values: Mapping[str, float], *,
                cat: str = "runtime") -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": self.now_us(), "pid": 1, "tid": 1,
            "args": {k: float(v) for k, v in values.items()},
        })

    # -- export --------------------------------------------------------------

    def to_chrome(self, *, provenance: Optional[Mapping] = None) -> dict:
        """The full Chrome trace-event JSON object (validated shape —
        see :func:`validate_chrome_trace`)."""
        other = dict(self.meta)
        if provenance:
            other["provenance"] = dict(provenance)
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write(self, path: str, *, provenance: Optional[Mapping] = None) -> str:
        obj = self.to_chrome(provenance=provenance)
        validate_chrome_trace(obj)  # never write an invalid trace
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        return path


# ---------------------------------------------------------------------------
# Ambient tracer (contextvar-threaded, per the byte-identity contract)
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_tracer", default=NULL_TRACER
)


def current():
    """The ambient tracer — :data:`NULL_TRACER` unless :func:`use_tracer`
    is active on this context."""
    return _CURRENT.get()


def tracing_active() -> bool:
    return _CURRENT.get().enabled


@contextlib.contextmanager
def use_tracer(tracer) -> Iterator:
    """Install ``tracer`` as the ambient tracer for the dynamic extent.

    Passing ``None`` (or an already-installed tracer) is a no-op scope,
    so call sites can write ``with use_tracer(maybe_tracer):``
    unconditionally."""
    if tracer is None or tracer is _CURRENT.get():
        yield tracer
        return
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


# module-level conveniences: operate on the ambient tracer
def span(name: str, *, cat: str = "compile", args: Optional[Mapping] = None):
    return _CURRENT.get().span(name, cat=cat, args=args)


def instant(name: str, *, cat: str = "compile",
            args: Optional[Mapping] = None) -> None:
    _CURRENT.get().instant(name, cat=cat, args=args)


def counter(name: str, values: Mapping[str, float], *,
            cat: str = "runtime") -> None:
    _CURRENT.get().counter(name, values, cat=cat)


# ---------------------------------------------------------------------------
# Chrome trace-event schema validation
# ---------------------------------------------------------------------------


def validate_chrome_trace(obj) -> dict:
    """Validate ``obj`` against the Chrome trace-event format (the JSON
    Object Format: ``{"traceEvents": [...]}``; a bare event array is
    also accepted, per the spec).  Raises :class:`ValueError` naming the
    first offending event; returns the object unchanged on success.

    Checked per event: ``name``/``cat``/``ph`` strings, ``ph`` a known
    phase, numeric non-negative ``ts`` (and ``dur`` for complete
    events), ``pid``/``tid`` integers, ``args`` a dict when present —
    the fields ``chrome://tracing`` and Perfetto actually require to
    render the event.
    """
    if isinstance(obj, list):
        events = obj
    elif isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(
                "chrome trace: top-level object needs a 'traceEvents' list"
            )
    else:
        raise ValueError(
            f"chrome trace: expected dict or list, got {type(obj).__name__}"
        )
    for i, ev in enumerate(events):
        where = f"chrome trace: event[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where} is not an object")
        for key in ("name", "ph"):
            if not isinstance(ev.get(key), str) or not ev[key]:
                raise ValueError(f"{where}: missing/empty string {key!r}")
        if ev["ph"] not in _PHASES:
            raise ValueError(
                f"{where} ({ev['name']!r}): unknown phase {ev['ph']!r}"
            )
        if ev["ph"] != "M":  # metadata events carry no timestamp
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(
                    f"{where} ({ev['name']!r}): bad ts {ts!r}"
                )
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"{where} ({ev['name']!r}): complete event needs "
                    f"numeric dur >= 0, got {dur!r}"
                )
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                raise ValueError(
                    f"{where} ({ev['name']!r}): {key} must be an int"
                )
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(
                f"{where} ({ev['name']!r}): args must be an object"
            )
        if ev["ph"] == "C":
            args = ev.get("args") or {}
            bad = [k for k, v in args.items()
                   if not isinstance(v, (int, float))]
            if bad:
                raise ValueError(
                    f"{where} ({ev['name']!r}): counter args must be "
                    f"numeric (bad: {bad})"
                )
    return obj
