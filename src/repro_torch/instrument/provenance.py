"""Run provenance: who/where/when a number came from.

``BENCH_smoke.json`` rows and exported traces are compared across runs,
machines, and PRs; a row without provenance is a number you cannot
trust a week later.  :func:`provenance` returns the stamp — git sha,
host, platform, python, wall-clock — that the benchmark harness attaches
to every row and the tracer embeds in ``otherData``.

The git sha is resolved once per process (``git rev-parse HEAD`` from
this file's repo, overridable via ``REPRO_GIT_SHA`` for environments
without a work tree) and never raises: a missing git binary degrades to
``"unknown"``, not a crashed benchmark run.
"""
from __future__ import annotations

import os
import platform
import subprocess
import sys
import time
from typing import Mapping, Optional

_GIT_SHA: Optional[str] = None


def git_sha() -> str:
    """The repo HEAD sha (cached; ``REPRO_GIT_SHA`` wins; ``"unknown"``
    when neither is available)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        sha = os.environ.get("REPRO_GIT_SHA", "").strip()
        if not sha:
            try:
                sha = subprocess.run(
                    ["git", "rev-parse", "HEAD"],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    capture_output=True, text=True, timeout=10,
                ).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                sha = ""
        _GIT_SHA = sha or "unknown"
    return _GIT_SHA


def provenance(extra: Optional[Mapping] = None) -> dict:
    """The provenance stamp: stable identity fields plus ``extra``
    (per-row measurements like compile wall time / pass timings)."""
    out = {
        "git_sha": git_sha(),
        "host": platform.node() or "unknown",
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "time_unix": round(time.time(), 3),
    }
    if extra:
        out.update(extra)
    return out
