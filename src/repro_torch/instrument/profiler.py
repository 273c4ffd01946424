"""Modeled-vs-measured profiler: close the loop on the resource model.

The compile pipeline *predicts* — per-group pipeline cycles out of the
DSE's analytical estimate (paper Sec. IV-C) — and the runtime
*measures* — per-group wall times from :func:`repro_torch.kernels.ops.
run_compiled` (collected via ``stats_out``, which synchronizes the
device after each group, so a wall covers the group's execution and not
only its enqueue).  This module reconciles the two: which groups does
the model get wrong, and by how much?

:func:`profile_artifact` runs a compiled artifact ``reps`` times
(after ``warmup`` discarded runs, so building and loading the kernels
never pollutes the measurement), takes the **min** wall per group (min,
not mean: wall noise on a shared host is one-sided), and joins against
the model:

* ``modeled_cycles`` — the group's DSE pipeline-cycle estimate;
* ``modeled_ms`` — those cycles at the nominal fabric clock
  (``clock_mhz``, default the 300 MHz the DRAM model assumes);
* ``implied_clock_mhz`` — the clock at which the modeled cycles would
  explain the measured wall (modeled_cycles / measured_wall);
* ``ratio`` — measured_ms / modeled_ms, the model-error ratio;
* ``roofline_util`` — modeled cycles vs. the edge target's
  compute/bandwidth roofline bound (:func:`edge_ideal_cycles`);
* per-layer attribution: each group's measured wall split across its
  :class:`~repro_torch.core.resource_model.NodeEstimate` rows by modeled
  cycle share.

The measured walls are those of the device the artifact ran on (the
CUDA card by default, the host's plain PyTorch versions with
``device="cpu"``), never of the FPGA the cycles model, so every group
shares one device-wide scaling.  Drift detection therefore flags groups
whose ratio deviates from the **median group ratio** by more than
``threshold``× in either direction — the shape of the error profile
transfers even when its scale does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _median(xs: list) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def edge_ideal_cycles(macs: int, dma_bytes: int, *, d_total: int,
                      elem_bits: int = 8) -> int:
    """The roofline cycle bound for one scheduled group on the edge
    target: the larger of the compute bound (all of the device's DSPs
    multiplying every cycle, integer-packing-aware via
    :func:`~repro_torch.core.resource_model.dsp_per_mult`) and the
    bandwidth bound (boundary-DMA bytes at the derated
    :data:`~repro_torch.core.resource_model.DRAM_BYTES_PER_CYCLE`).  A
    group whose *modeled* cycles sit at this bound is as good as the
    fabric allows; ideal/modeled is the ``roofline_util`` column."""
    # lazy: the instrument package loads before the core package does
    from repro_torch.core.resource_model import (
        DRAM_BYTES_PER_CYCLE,
        dsp_per_mult,
    )

    if d_total <= 0:
        raise ValueError(f"d_total must be > 0, got {d_total}")
    peak_macs_per_cycle = d_total / dsp_per_mult(elem_bits)
    compute = math.ceil(macs / peak_macs_per_cycle) if macs else 0
    memory = (math.ceil(dma_bytes / DRAM_BYTES_PER_CYCLE)
              if dma_bytes else 0)
    return max(compute, memory)


def _roofline_util(macs: int, dma_bytes: int, cycles: int,
                   d_total: int, elem_bits: int = 8) -> float:
    """Roofline utilization of one group: the ideal cycle count under
    the compute/bandwidth roofline divided by the modeled cycles (0.0
    for a group with no modeled cycles or no work)."""
    ideal = edge_ideal_cycles(macs, dma_bytes, d_total=d_total,
                              elem_bits=elem_bits)
    if cycles <= 0 or not ideal:
        return 0.0
    return min(1.0, ideal / cycles)


@dataclasses.dataclass
class ProfileReport:
    """The modeled-vs-measured join for one compiled artifact.

    ``groups``/``layers`` are lists of plain dicts (JSON-ready);
    ``flagged`` names the groups whose model-error ratio drifted past
    ``threshold``× the median."""

    model: str
    target: Optional[str]
    clock_mhz: float
    threshold: float
    reps: int
    #: the torch device type the walls were measured on: "cuda" | "cpu"
    device: str
    groups: list
    layers: list
    flagged: list
    total_modeled_cycles: int
    total_measured_ms: float

    def to_json(self) -> dict:
        return {
            "version": 1,
            "model": self.model,
            "target": self.target,
            "clock_mhz": self.clock_mhz,
            "threshold": self.threshold,
            "reps": self.reps,
            "device": self.device,
            "total_modeled_cycles": self.total_modeled_cycles,
            "total_measured_ms": round(self.total_measured_ms, 4),
            "flagged": list(self.flagged),
            "groups": self.groups,
            "layers": self.layers,
        }

    def format_table(self, *, layers: bool = True) -> str:
        """The human-facing per-group (and optional per-layer) table."""
        lines = [
            f"profile: {self.model}"
            + (f" @ {self.target}" if self.target else "")
            + f"  (clock {self.clock_mhz:g} MHz, {self.reps} reps, "
            + f"{self.device})",
            "",
            f"{'group':<14} {'modeled_cyc':>12} {'modeled_ms':>11} "
            f"{'measured_ms':>12} {'impl_MHz':>9} {'ratio':>8} "
            f"{'roofline':>9}  flag",
        ]
        for g in self.groups:
            roof = (f"{g['roofline_util']:.2f}"
                    if g.get("roofline_util") is not None else "-")
            lines.append(
                f"{g['group']:<14} {g['modeled_cycles']:>12,} "
                f"{g['modeled_ms']:>11.4f} {g['measured_ms']:>12.4f} "
                f"{g['implied_clock_mhz']:>9.2f} {g['ratio']:>8.2f} "
                f"{roof:>9}  {'DRIFT' if g['drift'] else ''}"
            )
        t_ms = self.total_modeled_cycles / (self.clock_mhz * 1e3)
        lines.append(
            f"{'total':<14} {self.total_modeled_cycles:>12,} "
            f"{t_ms:>11.4f} {self.total_measured_ms:>12.4f}"
        )
        if self.flagged:
            lines.append("")
            lines.append(
                f"drift (> {self.threshold:g}x off the median ratio): "
                + ", ".join(self.flagged)
            )
        if layers and self.layers:
            lines.append("")
            lines.append(
                f"{'layer':<22} {'group':<12} {'modeled_cyc':>12} "
                f"{'share':>6} {'attr_ms':>9} {'macs':>12} {'dsp':>6} "
                f"{'bram':>5}"
            )
            for n in self.layers:
                lines.append(
                    f"{n['name']:<22} {n['group']:<12} "
                    f"{n['modeled_cycles']:>12,} {n['share']:>6.2f} "
                    f"{n['attributed_ms']:>9.4f} {n['macs']:>12,} "
                    f"{n['dsp']:>6} {n['bram']:>5}"
                )
        return "\n".join(lines)


def profile_artifact(artifact, *, reps: int = 3, warmup: int = 1,
                     clock_mhz: float = 300.0, threshold: float = 2.0,
                     seed: int = 0, device=None) -> ProfileReport:
    """Profile one :class:`~repro_torch.api.artifact.CompiledArtifact`:
    execute it ``warmup + reps`` times on seeded random inputs and join
    per-group measured walls against the resource model (module
    docstring has the column definitions).  ``device=None`` means the
    CUDA card, as in :meth:`CompiledArtifact.run`, and raises without
    one; ``device="cpu"`` measures the plain PyTorch versions."""
    from repro_torch.device import resolve_device

    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if threshold <= 1.0:
        raise ValueError(f"threshold must be > 1, got {threshold}")
    if clock_mhz <= 0:
        raise ValueError(f"clock_mhz must be > 0, got {clock_mhz}")
    dev = resolve_device(device)
    design = artifact.design
    src = design.source

    walls: dict[str, list] = {g.name: [] for g in design.groups}
    for i in range(warmup + reps):
        artifact.run(seed=seed, device=dev)
        if i < warmup:
            continue
        stats = artifact.last_run_stats or {}
        for row in stats.get("groups", ()):
            if row.get("wall_ms") is not None:
                walls[row["group"]].append(row["wall_ms"])

    transitions = design.boundary_traffic()
    rows = []
    for idx, g in enumerate(design.groups):
        measured = min(walls[g.name]) if walls[g.name] else 0.0
        modeled_cycles = g.cycles
        modeled_ms = modeled_cycles / (clock_mhz * 1e3)
        w, r = transitions[idx] if idx < len(transitions) else (0, 0)
        measured_s = measured / 1e3
        implied = (modeled_cycles / measured_s / 1e6) if measured_s > 0 \
            else 0.0
        ratio = (measured / modeled_ms) if modeled_ms > 0 else 0.0
        rows.append({
            "group": g.name,
            "nodes": len(g.dfg.nodes),
            "modeled_cycles": modeled_cycles,
            "modeled_ms": round(modeled_ms, 6),
            "measured_ms": round(measured, 4),
            "implied_clock_mhz": round(implied, 3),
            "ratio": round(ratio, 4),
            "dma_write_bytes": w,
            "dma_read_bytes": r,
            "macs": g.dse.estimate.macs,
            "dsp": g.dsp,
            "bram": g.bram,
            "roofline_util": _roofline_util(
                g.dse.estimate.macs, w + r, modeled_cycles, design.d_total
            ),
            "drift": False,
        })

    # drift: ratio vs the median group ratio (scale-free, so a device
    # that is no FPGA still produces a meaningful error *profile*)
    ratios = [row["ratio"] for row in rows if row["ratio"] > 0]
    med = _median(ratios)
    flagged = []
    if med > 0 and len(rows) > 1:
        for row in rows:
            if row["ratio"] <= 0:
                continue
            if row["ratio"] > med * threshold or \
                    row["ratio"] < med / threshold:
                row["drift"] = True
                flagged.append(row["group"])

    layers = []
    for g, grow in zip(design.groups, rows):
        nodes = g.dse.estimate.nodes
        total = sum(n.cycles for n in nodes) or 1
        for n in nodes:
            share = n.cycles / total
            layers.append({
                "name": n.name,
                "group": g.name,
                "modeled_cycles": n.cycles,
                "share": round(share, 4),
                "attributed_ms": round(grow["measured_ms"] * share, 4),
                "macs": n.macs,
                "dsp": n.dsp,
                "bram": n.bram,
                "fill": n.fill,
            })

    return ProfileReport(
        model=src.name,
        target=getattr(design.target, "name", None),
        clock_mhz=clock_mhz,
        threshold=threshold,
        reps=reps,
        device=dev.type,
        groups=rows,
        layers=layers,
        flagged=flagged,
        total_modeled_cycles=design.total_cycles,
        total_measured_ms=round(sum(r["measured_ms"] for r in rows), 4),
    )
