"""The traced window: ``torch.profiler`` over the units (train steps, or a
prefill's calls) a traced run marks, reduced to what the per-layer
metrics read.

* busy time: the union of the device operations' intervals (kernels,
  copies, fills) inside the window, so overlapping operations count once;
  the window runs from the first traced unit's start to the last one's
  end on the host's clock, in the profiler's time base;
* time by kernel name, each operation clipped to the window;
* the kernel classes: the hand-written kernels by a piece of their names,
  cuBLAS by its (``MATMUL_PIECES``), and the rest, the model's glue;
* the longest idle gaps, each named by the innermost host operation that
  was running when the device went idle (or, where the host ran Python
  between operations, by the operation that came next).

Only a summary is kept: no trace file is written.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

import torch

#: hand-written kernels: class → (a piece of the name, a piece that must
#: not be in it), checked in this order
KERNEL_CLASSES = (
    ("attn_bwd", "attn_bwd_", None),
    ("attn_fwd", "flash_attention", "bwd"),
    ("ssd_bwd", "mamba2_ssd_bwd", None),
    ("ssd_fwd", "mamba2_ssd", "bwd"),
    ("mlp_bwd", "mlp_bwd_", None),
    ("mlp_fwd", "fused_mlp", "bwd"),
    ("conv", "conv2d_stream", None),
)
#: pieces of cuBLAS' kernel names (``nvjet_*`` on Hopper)
MATMUL_PIECES = ("nvjet", "gemm", "xmma", "cutlass", "gemv")
#: the profiler's kinds of device operation
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host operations that can name an idle gap
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
              "user_annotation")
UNIT_PREFIX = "perfbench.unit."


def kernel_class(name: str) -> str:
    """``attn_fwd`` … ``conv`` for a hand-written kernel, ``matmul`` for
    cuBLAS, ``glue`` for anything else."""
    low = name.lower()
    for cls, piece, not_piece in KERNEL_CLASSES:
        if piece in low and (not_piece is None or not_piece not in low):
            return cls
    if any(p in low for p in MATMUL_PIECES):
        return "matmul"
    return "glue"


@dataclass
class Unit:
    """One traced unit: its kind (``train`` or ``prefill``), rows and
    length, the rows a kernel call takes, and the program's count of
    calls of each hand-written kernel in it."""

    kind: str
    rows: int
    seq: int
    call_rows: int
    calls: dict = field(default_factory=dict)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: dict            # device operation name → seconds
    units: list              # Unit, in order
    idle_gaps: list          # [[host operation, seconds]], longest first
    read_s: float = 0.0      # seconds the reduction took

    def class_s(self, cls: str) -> float:
        return sum(s for n, s in self.by_name.items() if kernel_class(n) == cls)

    def device_s(self) -> float:
        return sum(self.by_name.values())

    def device_ops(self, top: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]


class Recorder:
    """Marks units; where ``enabled`` profiles them and reduces the
    trace (:meth:`summary`)."""

    def __init__(self, enabled: bool, counters=None):
        self.enabled = enabled
        self.units: list = []
        self._counters = counters
        self._prof = None
        self._stopped = False

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if torch.cuda.is_available():
            # the first launch after the start waits for the tracer to set
            # up: let it happen before the first unit
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def stop(self) -> None:
        if self._prof is not None and not self._stopped:
            self._prof.__exit__(None, None, None)
            self._stopped = True

    @contextlib.contextmanager
    def unit(self, kind: str, rows: int, seq: int, call_rows: int):
        """Mark one unit of the profiled range."""
        if self._prof is None or self._stopped:
            yield
            return
        before = self._counters() if self._counters else {}
        with torch.profiler.record_function(f"{UNIT_PREFIX}{len(self.units)}"):
            yield
        after = self._counters() if self._counters else {}
        self.units.append(Unit(kind, rows, seq, call_rows,
                               {k: after[k] - before[k] for k in after}))

    def summary(self) -> Summary | None:
        if self._prof is None or not self.units:
            return None
        self.stop()
        t0 = time.perf_counter()
        out = summarize(_events(self._prof), self.units)
        out.read_s = time.perf_counter() - t0
        return out


def _events(prof) -> list:
    """(kind, name, start_s, end_s) of every event of the trace, the times
    from the trace's first event (integers until then: nanoseconds since
    the epoch do not fit a float's precision)."""
    raw = []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if kind is None:
            on_dev = e.device_type() != torch.autograd.DeviceType.CPU
            kind = "kernel" if on_dev else "cpu_op"
        raw.append((kind, e.name(), e.start_ns(), e.duration_ns()))
    base = min((r[2] for r in raw), default=0)
    return [(k, n, (a - base) * 1e-9, (a - base + d) * 1e-9)
            for k, n, a, d in raw]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, units: list, top: int = 10) -> Summary:
    """Reduce ``events`` ((kind, name, start_s, end_s)) over the window
    the ``units``' annotations span."""
    marks = [(a, b) for kind, n, a, b in events
             if n.startswith(UNIT_PREFIX) and kind in ("user_annotation",
                                                       "cpu_op")]
    if not marks:
        raise RuntimeError("the trace holds no unit annotation")
    w0, w1 = min(a for a, _ in marks), max(b for _, b in marks)
    by_name: dict = {}
    spans = []
    for kind, name, a, b in events:
        if kind not in DEVICE_KINDS or name.startswith(UNIT_PREFIX):
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        spans.append((a, b))
    merged = _union(spans)
    busy = sum(b - a for a, b in merged)
    gaps, at = [], w0
    for a, b in merged:
        if a > at:
            gaps.append((a - at, at))
        at = max(at, b)
    if w1 > at:
        gaps.append((w1 - at, at))
    gaps.sort(reverse=True)
    host = sorted((a, b, n) for kind, n, a, b in events
                  if kind in HOST_KINDS and not n.startswith(UNIT_PREFIX))
    starts = [h[0] for h in host]
    named = []
    for length, t in gaps[:top]:
        at = bisect.bisect_right(starts, t)
        cover = [h for h in host[:at] if h[1] >= t]
        if cover:
            name = min(cover, key=lambda h: h[1] - h[0])[2]
        else:       # Python between operations: name the next one
            name = "host code before " + (host[at][2] if at < len(host)
                                          else "the window's end")
        named.append([name, length])
    return Summary(window_s=w1 - w0, busy_s=busy, by_name=by_name,
                   units=list(units), idle_gaps=named)


def _of_kind(summary: Summary, kind: str) -> bool:
    return any(u.kind == kind for u in summary.units)


def idle_share(summary: Summary, kind: str):
    """1 − busy / window of a window of ``kind`` units, in %."""
    if not _of_kind(summary, kind) or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)


def glue_share(summary: Summary, kind: str):
    """The device time in kernels neither hand-written nor cuBLAS over
    all device time of a window of ``kind`` units, in %."""
    total = summary.device_s()
    if not _of_kind(summary, kind) or total <= 0:
        return None
    return 100.0 * summary.class_s("glue") / total
