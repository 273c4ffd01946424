"""Stream-skew / deadlock analysis over a :class:`StreamingPlan`.

For every reconvergent path (a fork whose branches re-join — residual
adds, conv+pool fusions feeding a common consumer), the branch that
produces its first element earlier must park data in its FIFO while the
long branch fills its line buffers.  :func:`repro_torch.core.streaming.fifo_slack`
derives that row-rate skew from the line-buffer geometry; here we check
the *charged* FIFO depth actually absorbs it:

* **SK1 (ERROR)** — an internal stream's depth is smaller than the
  skew it must absorb.  In hardware this is a deadlock: the short
  branch's FIFO fills, back-pressure stalls the fork, and the long
  branch never receives the elements it needs to produce its first
  output.  ``plan_streams`` sizes these FIFOs automatically
  (``_size_diamond_fifos``), so SK1 firing means the plan was built or
  edited outside that path — exactly the class of bug FIFO sizing
  papers (FIFOAdvisor et al.) exist for.
* **SK2 (INFO)** — a reconvergent join and the skew its skip FIFO
  absorbs: observability for how much BRAM the diamond costs.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.streaming import StreamingPlan, fifo_slack

from .diagnostics import Diagnostic, Severity


def analyze_stream_skew(
    plan: StreamingPlan, *, group: Optional[str] = None
) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    graph = plan.dfg.name
    for name, need in sorted(fifo_slack(plan).items()):
        s = plan.streams[name]
        if s.depth < need:
            diags.append(Diagnostic(
                rule="SK1",
                severity=Severity.ERROR,
                graph=graph,
                group=group,
                node=name,
                message=(
                    f"reconvergent branch {s.producer} -> {s.consumer}: "
                    f"data is ready {need} cycles before the join's "
                    f"slowest input but the FIFO holds only {s.depth} "
                    "elements — the pipeline deadlocks once it fills"
                ),
                hint=(
                    f"deepen the skip FIFO to >= {need} (plan_streams' "
                    "_size_diamond_fifos does this automatically)"
                ),
            ))
        else:
            diags.append(Diagnostic(
                rule="SK2",
                severity=Severity.INFO,
                graph=graph,
                group=group,
                node=name,
                message=(
                    f"reconvergent join at {s.consumer}: skip FIFO "
                    f"absorbs a {need}-cycle skew (depth {s.depth}, "
                    f"{s.buffer_bits} bits)"
                ),
            ))
    return diags
