"""Integer range analysis: interval propagation over quantized datapaths.

Walks the DFG in topo order carrying a conservative value interval per
stream and infers, for every reduction (conv/matmul MAC, sum, fused
AVG-pool epilogue), the **minimum accumulator width** the lowering must
provide.  The rules:

* **R1 (ERROR)** — the worst-case accumulated sum does not fit the
  accumulator the lowering provides.  This is exactly the
  int8 batched-conv bug class: the vmapped per-tap matmul path
  accumulated in the *input* dtype, so int8 convs wrapped silently.
  The fixed lowering (``repro_torch.kernels.ops.conv2d_same_mm``) casts
  operands to int32 before the reduction; ``acc_bits="input"``
  reconstructs the pre-fix behaviour so the regression stays
  statically detectable.
* **R2 (INFO)** — a node's exact result range needs more bits than its
  output stream carries (``Value.elem_bits``).  In the paper's int8
  regime that is normal — a requantization step is assumed on the
  stream exit — so it is informational, but it is also precisely where
  the analysis widens back to the stream dtype to stay sound.

Soundness note: downstream intervals are always clamped to the stream
dtype (the FIFO physically carries ``elem_bits``), so the propagation
never narrows below what the hardware could observe.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

from repro_torch.core.ir import DFG, FusedEpilogue, GenericOp, PayloadKind

from .diagnostics import Diagnostic, Severity

#: the fixed lowering's accumulator: conv2d_same_mm casts int operands
#: to int32 before the per-tap matmuls, so every reduction accumulates
#: in 32 bits regardless of the stream dtype
DEFAULT_ACC_BITS = 32

#: ``acc_bits`` policy reconstructing the pre-fix lowering: the
#: accumulator is whatever dtype the node's streams carry
ACC_INPUT_DTYPE = "input"


@dataclass(frozen=True)
class Interval:
    """A closed integer interval [lo, hi]."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # -- arithmetic ---------------------------------------------------------

    def add(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def mul(self, other: "Interval") -> "Interval":
        corners = (
            self.lo * other.lo, self.lo * other.hi,
            self.hi * other.lo, self.hi * other.hi,
        )
        return Interval(min(corners), max(corners))

    def scale(self, k: int) -> "Interval":
        """Sum of ``k`` values each drawn from this interval."""
        return Interval(self.lo * k, self.hi * k)

    def floordiv(self, k: int) -> "Interval":
        return Interval(self.lo // k, self.hi // k)

    def join_max(self, other: "Interval") -> "Interval":
        return Interval(max(self.lo, other.lo), max(self.hi, other.hi))

    def relu(self) -> "Interval":
        return Interval(max(self.lo, 0), max(self.hi, 0))

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    # -- width --------------------------------------------------------------

    @property
    def bits(self) -> int:
        """Smallest signed width holding every value in the interval."""
        need_hi = self.hi.bit_length() + 1 if self.hi > 0 else 1
        need_lo = (-self.lo - 1).bit_length() + 1 if self.lo < 0 else 1
        return max(need_hi, need_lo)

    def fits(self, bits: int) -> bool:
        return self.bits <= bits

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"[{self.lo}, {self.hi}]"


def dtype_interval(bits: int) -> Interval:
    """The value range of a ``bits``-wide signed stream element."""
    return Interval(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------


def _reduction_trip(op: GenericOp) -> int:
    return math.prod(
        (op.dim_extent(d) for d in op.reduction_dims), start=1
    )


def _resolve_acc_bits(op: GenericOp, acc_bits: Union[int, str]) -> int:
    if acc_bits == ACC_INPUT_DTYPE:
        return op.elem_bits
    return int(acc_bits)


class _RangeWalker:
    def __init__(self, dfg: DFG, acc_bits: Union[int, str]):
        self.dfg = dfg
        self.acc_bits = acc_bits
        self.env: dict[str, Interval] = {}
        self.diags: list[Diagnostic] = []

    # -- diagnostics --------------------------------------------------------

    def _overflow(self, op: GenericOp, what: str, acc: Interval,
                  trip: int) -> None:
        avail = _resolve_acc_bits(op, self.acc_bits)
        if acc.fits(avail):
            return
        self.diags.append(Diagnostic(
            rule="R1",
            severity=Severity.ERROR,
            graph=self.dfg.name,
            node=op.name,
            message=(
                f"{what}: {trip}-term {op.payload.value} reduction "
                f"accumulates into {acc} — needs a {acc.bits}-bit "
                f"accumulator but the lowering provides {avail} bits"
            ),
            hint=(
                "accumulate in int32: cast operands before the "
                "reduction as kernels/ops.conv2d_same_mm does"
            ),
        ))

    # -- per-node transfer --------------------------------------------------

    def _value(self, name: str) -> Interval:
        if name in self.env:
            return self.env[name]
        v = self.dfg.values[name]
        iv = dtype_interval(v.elem_bits)
        self.env[name] = iv
        return iv

    def _payload_result(self, op: GenericOp) -> Interval:
        ins = [self._value(n) for n in op.inputs]
        trip = _reduction_trip(op)
        kind = op.payload

        if kind == PayloadKind.MAC:
            point = ins[0].mul(ins[1]) if len(ins) >= 2 else ins[0]
            acc = point.scale(trip)
            self._overflow(op, "payload", acc, trip)
            return acc
        if kind == PayloadKind.ADD:
            point = ins[0].add(ins[1]) if len(ins) >= 2 else ins[0]
            if trip > 1:
                acc = point.scale(trip)
                self._overflow(op, "payload", acc, trip)
                return acc
            return point
        if kind == PayloadKind.MUL:
            if len(ins) >= 2 and trip == 1:
                return ins[0].mul(ins[1])
            return dtype_interval(op.elem_bits)
        if kind == PayloadKind.MAX:
            out = ins[0]
            for other in ins[1:]:
                out = out.join_max(other)
            return out
        if kind == PayloadKind.AVG:
            acc = ins[0].scale(trip)
            self._overflow(op, "payload", acc, trip)
            return acc.floordiv(trip) if trip else ins[0]
        if kind == PayloadKind.RELU:
            return ins[0].relu()
        if kind == PayloadKind.SQUARED_RELU:
            r = ins[0].relu()
            return Interval(0, r.hi * r.hi)
        if kind == PayloadKind.IDENTITY:
            return ins[0] if ins else dtype_interval(op.elem_bits)
        # EXP and anything future: no useful static bound — the stream
        # dtype is the sound fallback (the FIFO carries elem_bits)
        return dtype_interval(op.elem_bits)

    def _apply_epilogue(
        self, op: GenericOp, e: FusedEpilogue, cur: Interval
    ) -> Interval:
        if e.window and any(f > 1 for f in e.window):
            w = math.prod(e.window)
            if e.kind == PayloadKind.AVG:
                acc = cur.scale(w)
                self._overflow(op, f"{e.kind.value}-pool epilogue", acc, w)
                return acc.floordiv(w)
            # MAX (and any order-statistic pool) preserves the interval
            return cur
        operand = self._value(e.operand) if e.operand else None
        if e.kind == PayloadKind.RELU:
            return cur.relu()
        if e.kind == PayloadKind.ADD and operand:
            return cur.add(operand)
        if e.kind == PayloadKind.MUL and operand:
            return cur.mul(operand)
        if e.kind == PayloadKind.MAX and operand:
            return cur.join_max(operand)
        if e.kind == PayloadKind.SQUARED_RELU:
            r = cur.relu()
            return Interval(0, r.hi * r.hi)
        if e.kind == PayloadKind.IDENTITY:
            return cur
        return dtype_interval(op.elem_bits)

    # -- driver -------------------------------------------------------------

    def run(self) -> None:
        for op in self.dfg.topo_order():
            exact = self._payload_result(op)
            for e in op.epilogue:
                exact = self._apply_epilogue(op, e, exact)
            out_v = self.dfg.values[op.output]
            carrier = dtype_interval(out_v.elem_bits)
            if exact.lo >= carrier.lo and exact.hi <= carrier.hi:
                self.env[op.output] = exact
            else:
                # the stream physically carries elem_bits: widen back to
                # the dtype range (sound) and note the assumed requant
                self.env[op.output] = carrier
                self.diags.append(Diagnostic(
                    rule="R2",
                    severity=Severity.INFO,
                    graph=self.dfg.name,
                    node=op.name,
                    message=(
                        f"output range {exact} needs {exact.bits} bits "
                        f"but stream {op.output!r} carries "
                        f"{out_v.elem_bits} — requantization assumed at "
                        "the stream exit"
                    ),
                    hint=(
                        "widen the output Value's elem_bits or fold an "
                        "explicit requantization scale into the epilogue"
                    ),
                ))


def analyze_ranges(
    dfg: DFG, *, acc_bits: Union[int, str] = DEFAULT_ACC_BITS
) -> list[Diagnostic]:
    """Range diagnostics for ``dfg`` under an accumulator policy.

    ``acc_bits`` is the width every reduction accumulates in: the
    default 32 models the fixed int32 lowering; ``"input"``
    (:data:`ACC_INPUT_DTYPE`) models the pre-fix lowering that
    accumulated in the stream dtype; any int models a custom datapath.
    """
    w = _RangeWalker(dfg, acc_bits)
    w.run()
    return w.diags


def value_intervals(
    dfg: DFG, *, acc_bits: Union[int, str] = DEFAULT_ACC_BITS
) -> dict[str, Interval]:
    """The propagated (stream-clamped) interval per value name."""
    w = _RangeWalker(dfg, acc_bits)
    w.run()
    return w.env


def overflow_safe(
    dfg: DFG, *, acc_bits: Union[int, str] = DEFAULT_ACC_BITS
) -> bool:
    """True when no ERROR-severity range diagnostic fires — the
    analyzer's claim that every reduction fits its accumulator."""
    return not any(
        d.severity is Severity.ERROR for d in
        analyze_ranges(dfg, acc_bits=acc_bits)
    )
