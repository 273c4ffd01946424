"""Structured diagnostics: the data model of the static analyzer.

Every analysis family (``ranges``, ``stream_skew``, ``hazards``,
``hygiene``) reports :class:`Diagnostic` records — severity, a stable
rule id from the :data:`~repro_torch.analyze.engine.RULES` catalog, the
graph/node/group location, a human message, and a fix hint — never
free-form strings.  The records are what every consumer shares:

* ``compile_design`` stores them on ``CompiledDesign.diagnostics`` and
  (under ``CompileOptions(lint="error")``) raises :class:`LintError`
  when any ERROR-severity record survives;
* ``Report`` telemetry and the ``python -m repro lint`` CLI format
  them (:meth:`Diagnostic.format`);
* CI serializes them (:func:`diagnostics_to_json`) as the
  ``lint_diagnostics.json`` workflow artifact.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence


class Severity(str, enum.Enum):
    """Diagnostic severity, ordered INFO < WARNING < ERROR."""

    INFO = "info"
    WARNING = "warning"
    ERROR = "error"

    @property
    def rank(self) -> int:
        return _SEVERITY_RANK[self]

    @classmethod
    def parse(cls, s: "str | Severity") -> "Severity":
        if isinstance(s, Severity):
            return s
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(
                f"unknown severity {s!r} — one of "
                f"{[m.value for m in cls]}"
            ) from None


_SEVERITY_RANK = {Severity.INFO: 0, Severity.WARNING: 1, Severity.ERROR: 2}


@dataclass(frozen=True)
class Diagnostic:
    """One finding of the static analyzer.

    ``rule`` is a stable id from the catalog (``SK1``, ``R1``, ``SH2``,
    ``H3``…); ``node`` names the offending node / stream / value when
    the finding is that local, ``group`` the :class:`GroupSchedule`
    when it is schedule-scoped.  ``hint`` says how to fix it, not just
    what is wrong.
    """

    rule: str
    severity: Severity
    message: str
    graph: str
    node: Optional[str] = None
    group: Optional[str] = None
    hint: Optional[str] = None

    @property
    def location(self) -> str:
        parts = [self.graph]
        if self.group:
            parts.append(self.group)
        if self.node:
            parts.append(self.node)
        return "/".join(parts)

    def format(self) -> str:
        """``error[R1] lenet5/conv0: message (hint: …)``"""
        s = f"{self.severity.value}[{self.rule}] {self.location}: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s

    def to_json(self) -> dict:
        out = {
            "rule": self.rule,
            "severity": self.severity.value,
            "message": self.message,
            "graph": self.graph,
        }
        if self.node:
            out["node"] = self.node
        if self.group:
            out["group"] = self.group
        if self.hint:
            out["hint"] = self.hint
        return out


class LintError(ValueError):
    """ERROR-severity diagnostics under ``CompileOptions(lint="error")``.

    Carries the full diagnostic list on ``.diagnostics`` (every
    severity, not just the fatal ones) so callers can render the whole
    picture, not only the message string.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic], graph: str = ""):
        self.diagnostics: tuple[Diagnostic, ...] = tuple(diagnostics)
        errs = [d for d in self.diagnostics if d.severity is Severity.ERROR]
        head = (f"{graph or (errs[0].graph if errs else '?')}: "
                f"{len(errs)} ERROR-severity diagnostic(s)")
        super().__init__(
            "\n".join([head] + ["  " + d.format() for d in errs])
        )


def max_severity(diags: Sequence[Diagnostic]) -> Optional[Severity]:
    """The worst severity present, or None for a clean list."""
    if not diags:
        return None
    return max((d.severity for d in diags), key=lambda s: s.rank)


def severity_counts(diags: Sequence[Diagnostic]) -> dict[str, int]:
    counts = {s.value: 0 for s in Severity}
    for d in diags:
        counts[d.severity.value] += 1
    return counts


def at_or_above(
    diags: Sequence[Diagnostic], threshold: "str | Severity"
) -> list[Diagnostic]:
    t = Severity.parse(threshold)
    return [d for d in diags if d.severity.rank >= t.rank]


def diagnostics_to_json(
    diags: Sequence[Diagnostic], *, meta: Optional[dict] = None
) -> dict:
    """The JSON diagnostic schema (DESIGN.md §8): a versioned envelope
    with per-severity counts and one record per finding."""
    out = {
        "version": 1,
        "counts": severity_counts(diags),
        "diagnostics": [d.to_json() for d in diags],
    }
    if meta:
        out["meta"] = dict(meta)
    return out
