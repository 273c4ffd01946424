"""`CompiledArtifact`: the session handle a compile returns.

hls4ml's ``convert → compile → predict`` one-call surface is the
adoption bar (PAPERS.md); this module is our equivalent.  One call —
:func:`compile_graph` — takes anything graph-shaped (a built
:class:`~repro_torch.core.ir.DFG`, a :class:`~repro_torch.api.builder.Sequential`,
or an open :class:`~repro_torch.api.builder.Graph`) plus one
:class:`~repro_torch.core.compile_driver.CompileOptions`, and hands back a
:class:`CompiledArtifact` that can

* ``emit_hls(outdir)``   — write the Vitis C++ kernels + host schedule,
* ``run(x)``             — execute on the CUDA card (``device="cpu"``
                           for the plain PyTorch versions), bit-exact
                           with the DFG interpreter,
* ``report()``           — the cycles/BRAM/DSP/spill table per group,
* ``save()`` / ``load()``— persist the compiled design (the benchmark
                           cache uses this to skip recompiles).

The artifact holds plain schedule-IR state only (no executables,
no tensors), so ``save``/``load`` is a straight pickle and a loaded
artifact re-lowers through the same executable cache as a fresh one.
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Mapping, Optional

import repro_torch.instrument as instrument
from repro_torch.core.compile_driver import (
    CompiledDesign,
    CompileOptions,
    compile_design,
)
from repro_torch.core.ir import DFG
from repro_torch.core.resource_model import transition_cycles

#: bumped when the pickled payload's schema changes; load() rejects
#: mismatches loudly instead of failing deep inside the schedule IR
_SAVE_VERSION = 1


@dataclass(frozen=True)
class GroupReport:
    """One row of :meth:`CompiledArtifact.report`."""

    name: str
    nodes: tuple[str, ...]
    cycles: int
    bram: int
    dsp: int
    spill_in_bytes: int
    spill_out_bytes: int
    weight_streamed: tuple[tuple[str, int], ...]


@dataclass(frozen=True)
class TransitionReport:
    """One group→group boundary: the DMA the host schedule overlaps."""

    left: str
    right: str
    write_bytes: int
    read_bytes: int
    cycles: int


@dataclass(frozen=True)
class Report:
    """Whole-design accounting, printable as a table.

    ``transitions`` itemizes the boundary DMA of a partitioned design
    (per cut: spill-write/fill-read bytes and the overlapped cycle
    cost) — previously only the aggregate ``spill_cycles`` was visible.

    ``telemetry`` carries measured, non-deterministic data —
    per-pass wall times, partition-DP search statistics, jit-cache
    counters, the artifact's last ``run()`` stats — and is excluded
    from equality: two compiles of the same graph produce equal
    Reports even though their wall times differ.
    """

    graph: str
    target: str
    feasible: bool
    groups: tuple[GroupReport, ...]
    total_cycles: int
    max_group_cycles: int
    spill_cycles: int
    max_bram: int
    b_total: int
    max_dsp: int
    d_total: int
    spill_bytes: int
    transitions: tuple[TransitionReport, ...] = ()
    telemetry: Optional[dict] = field(default=None, compare=False)

    def __str__(self) -> str:
        head = (
            f"{self.graph} @ {self.target}: "
            f"{self.total_cycles / 1e6:.3f} Mcycles total "
            f"({self.spill_cycles} boundary DMA), "
            f"peak BRAM {self.max_bram}/{self.b_total}, "
            f"peak DSP {self.max_dsp}/{self.d_total}, "
            f"{'feasible' if self.feasible else 'INFEASIBLE'}"
        )
        lines = [head, "group,nodes,cycles,bram,dsp,spill_in_B,spill_out_B,"
                       "weight_streamed"]
        trans = {t.left: t for t in self.transitions}
        for g in self.groups:
            ws = ";".join(f"{n}/{t}" for n, t in g.weight_streamed) or "-"
            lines.append(
                f"{g.name},{'+'.join(g.nodes)},{g.cycles},{g.bram},{g.dsp},"
                f"{g.spill_in_bytes},{g.spill_out_bytes},{ws}"
            )
            t = trans.get(g.name)
            if t is not None:
                lines.append(
                    f"  -- dma {t.left}->{t.right}: "
                    f"write {t.write_bytes} B, read {t.read_bytes} B, "
                    f"{t.cycles} cycles (overlapped)"
                )
        lines.extend(self._telemetry_lines())
        return "\n".join(lines)

    def _telemetry_lines(self) -> list[str]:
        tel = self.telemetry
        if not tel:
            return []
        lines = ["telemetry:"]
        passes = tel.get("passes")
        if passes:
            total = sum(p["wall_ms"] for p in passes)
            hot = ", ".join(
                f"{p['name']} {p['wall_ms']:.2f}ms"
                for p in sorted(passes, key=lambda p: -p["wall_ms"])[:4]
            )
            lines.append(f"  passes: {total:.2f} ms total ({hot})")
        dp = tel.get("partition")
        if dp:
            rej = dp.get("rejected_by_reason") or {}
            rej_s = " ".join(f"{k}:{v}" for k, v in sorted(rej.items()))
            lines.append(
                f"  partition: dp_states={dp.get('dp_states', 0)} "
                f"memo_hits={dp.get('dp_memo_hits', 0)} "
                f"ilp_solves={dp.get('ilp_solves', 0)} "
                f"streamed_resolves={dp.get('streamed_resolves', 0)} "
                f"rejected_cuts={len(dp.get('rejected_cuts', []))}"
                + (f" ({rej_s})" if rej_s else "")
            )
        cache = tel.get("exec_cache")
        if cache:
            lines.append(
                f"  jit cache: {cache.get('hits', 0)} hits / "
                f"{cache.get('misses', 0)} misses (cumulative)"
            )
        run = tel.get("last_run")
        if run:
            per_group = " ".join(
                f"{g['group']} {g['wall_ms']:.1f}ms({g['jit_cache']})"
                for g in run.get("groups", [])
            )
            lines.append(
                f"  last run: {run.get('samples', 1)} sample(s), "
                f"{run.get('wall_ms', 0.0):.1f} ms wall"
                + (f", groups: {per_group}" if per_group else "")
            )
        metrics = tel.get("metrics")
        if metrics:
            n_counters = len(metrics.get("counters", {}))
            n_gauges = len(metrics.get("gauges", {}))
            hists = metrics.get("histograms", {})
            obs = sum(
                row.get("count", 0)
                for h in hists.values() for row in h.get("values", [])
            )
            lines.append(
                f"  metrics: {n_counters} counter(s), {n_gauges} "
                f"gauge(s), {len(hists)} histogram(s) "
                f"({obs} observation(s))"
            )
        diag = tel.get("diagnostics")
        if diag:
            c = diag.get("counts", {})
            lines.append(
                f"  lint: {c.get('error', 0)} error(s), "
                f"{c.get('warning', 0)} warning(s), "
                f"{c.get('info', 0)} info"
            )
            for item in diag.get("items", []):
                if item.get("severity") in ("error", "warning"):
                    lines.append(
                        f"    {item['severity']}[{item['rule']}] "
                        f"{item.get('node') or item.get('group') or '-'}: "
                        f"{item['message']}"
                    )
        return lines


class CompiledArtifact:
    """A compiled design plus every way to consume it."""

    def __init__(self, design: CompiledDesign) -> None:
        self.design = design
        #: runtime counters of the most recent :meth:`run`:
        #: wall time, per-group latency + jit-cache outcome, exec-cache
        #: hit/miss delta, boundary-DMA bytes; ``None`` until a run
        self.last_run_stats: Optional[dict] = None

    @contextlib.contextmanager
    def _tracer_scope(self):
        """Install the compile-time tracer (``CompileOptions.trace``)
        for a consumer call, unless an enabled tracer is already
        ambient — runtime counters then land in the same trace as the
        compile spans.  Always yields a usable tracer (the no-op null
        tracer when nothing is attached)."""
        if instrument.current().enabled:
            yield instrument.current()
            return
        with instrument.use_tracer(self.design.tracer):
            yield instrument.current()

    @property
    def tracer(self):
        """The attached :class:`repro_torch.instrument.Tracer` (or None)."""
        return self.design.tracer

    def write_trace(self, path: str, *,
                    provenance: Optional[Mapping] = None) -> str:
        """Export the attached tracer's events as Chrome trace-event
        JSON (validated before writing; load it in ``chrome://tracing``
        or Perfetto).  Requires a traced compile
        (``CompileOptions(trace=...)``)."""
        tracer = self.design.tracer
        if tracer is None:
            raise ValueError(
                "no trace attached — compile with "
                "CompileOptions(trace=True) (or --trace PATH on the CLI)"
            )
        extra = dict(provenance) if provenance else {}
        extra.setdefault("graph", self.source.name)
        extra.setdefault("target", self.target_name)
        return tracer.write(path,
                            provenance=instrument.provenance(extra))

    # -- identity ------------------------------------------------------------

    @property
    def source(self) -> DFG:
        """The (post-pass-pipeline) graph the groups partition."""
        return self.design.source

    @property
    def options(self) -> Optional[CompileOptions]:
        return self.design.options

    @property
    def target_name(self) -> str:
        return self.design.target.name if self.design.target else "custom"

    @property
    def feasible(self) -> bool:
        return self.design.feasible

    @property
    def diagnostics(self) -> list:
        """Static-analysis findings (``repro_torch.analyze.Diagnostic``)
        collected at compile time under ``CompileOptions.lint``.
        ``getattr`` because older pickled designs lack the
        field."""
        return list(getattr(self.design, "diagnostics", None) or [])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<CompiledArtifact {self.source.name!r} @ {self.target_name} "
            f"groups={len(self.design.groups)} "
            f"cycles={self.design.total_cycles}>"
        )

    # -- backends ------------------------------------------------------------

    def emit_hls(self, outdir: str) -> list[str]:
        """Write one Vitis-style C++ kernel per group plus the host
        schedule into ``outdir``; returns the written paths."""
        from repro_torch.core.emit_hls import emit_design

        os.makedirs(outdir, exist_ok=True)
        paths = []
        with self._tracer_scope():
            files = emit_design(self.design)
        for fname, contents in files.items():
            path = os.path.join(outdir, fname)
            with open(path, "w") as f:
                f.write(contents)
            paths.append(path)
        return paths

    def run(
        self,
        inputs=None,
        params: Optional[Mapping] = None,
        *,
        device=None,
        seed: int = 0,
        batch_mode: str = "vmap",
    ):
        """Execute the compiled schedule; outputs come back as NumPy.

        ``inputs`` is a ``{name: array}`` mapping, or a bare array when
        the graph has exactly one input.  Passing *some* inputs of a
        multi-input graph is an error; passing *none* runs a smoke
        execution on the deterministic small-integer initialization of
        ``repro_torch.passes.interp.random_env(seed)``.  ``params`` binds
        constant values (weights/biases) — nothing else; unbound
        constants fall back to the same random init.  Returns the output
        array for single-output graphs, else ``{name: array}``.

        ``device=None`` means the CUDA card, and raises when there is
        none; ``device="cpu"`` runs the kernels' plain PyTorch versions
        on the host.  NumPy inputs and params move to the device at this
        boundary (tensors already there are used as they are); the
        outputs stay on the device until one conversion at the end,
        which also waits for the device to finish.
        :meth:`run_tensors` is the same call without that conversion.

        **Batching**: every input may carry one extra *leading* batch
        dimension over its compiled shape.  With the default
        ``batch_mode="vmap"`` the whole batch executes through the
        batched group executables
        (:func:`repro_torch.kernels.ops.run_compiled_batched`) — one
        kernel launch per conv for the whole batch: the batch is padded
        to a small set of bucket extents, outputs stay stacked on device
        and convert to NumPy once at the boundary.
        ``batch_mode="loop"`` keeps the per-sample loop through the
        compiled schedule (the bit-exactness reference and the serving
        benchmark's baseline).  Both modes produce bit-identical stacked
        outputs.  All inputs must agree on the batch extent; mixing
        batched and unbatched inputs is an error.
        """
        out = self.run_tensors(inputs, params, device=device,
                               seed=seed, batch_mode=batch_mode)
        # one host conversion at the boundary (it synchronizes the device)
        if isinstance(out, dict):
            return {k: v.cpu().numpy() for k, v in out.items()}
        return out.cpu().numpy()

    def run_tensors(
        self,
        inputs=None,
        params: Optional[Mapping] = None,
        *,
        device=None,
        seed: int = 0,
        batch_mode: str = "vmap",
    ):
        """:meth:`run` without the final host conversion: the outputs are
        ``torch.Tensor`` on ``device`` (work may still be in flight on a
        CUDA device)."""
        from repro_torch.device import env_to_device, resolve_device
        from repro_torch.kernels import ops
        from repro_torch.passes import interp

        import torch

        if batch_mode not in ("vmap", "loop"):
            raise ValueError(
                f"batch_mode must be 'vmap' or 'loop', got {batch_mode!r}"
            )
        dev = resolve_device(device)
        src = self.design.source
        if inputs is None:
            inputs = {}
        if not isinstance(inputs, Mapping):
            if len(src.graph_inputs) != 1:
                raise ValueError(
                    f"{src.name} has {len(src.graph_inputs)} inputs "
                    f"({src.graph_inputs}); pass a dict, not a bare array"
                )
            inputs = {src.graph_inputs[0]: inputs}
        for k in inputs:
            if k not in src.graph_inputs:
                raise KeyError(
                    f"{src.name}: {k!r} is not a graph input "
                    f"({src.graph_inputs})"
                )
        if inputs and set(inputs) != set(src.graph_inputs):
            # all-or-nothing: a partially bound multi-input graph would
            # silently run on random data for the forgotten input
            missing = sorted(set(src.graph_inputs) - set(inputs))
            raise ValueError(
                f"{src.name}: missing graph input(s) {missing} — bind "
                "every input, or none for a random smoke run"
            )
        constants = sorted(
            n for n, val in src.values.items() if val.is_constant
        )
        if params:
            for k in params:
                ok = k in src.graph_inputs or (
                    k in src.values and src.values[k].is_constant
                )
                if not ok:
                    raise KeyError(
                        f"{src.name}: param {k!r} is not a constant (or "
                        f"graph input) of the compiled graph — "
                        f"constants: {constants} (note: the pass "
                        "pipeline may have folded or renamed values of "
                        "the original graph)"
                    )
        batch = self._batch_extent(src, inputs)
        # random-fill only when something is actually unbound — a fully
        # parameterized call (the hot path) never pays the RNG work
        bound = set(inputs) | set(params or ())
        needed = set(src.graph_inputs) | {
            n for n, v in src.values.items() if v.is_constant
        }
        env: dict = {}
        if needed - bound:
            env.update(interp.random_env(src, seed=seed, device=dev))
        if params:
            env.update(params)
        env.update(inputs)
        # the one host→device move of this call (a no-op for tensors
        # that already live there, e.g. a serve engine's constants)
        env = env_to_device(env, dev)
        if batch is not None and batch_mode == "loop":
            stream = [k for k in src.graph_inputs]
            with self._tracer_scope() as tracer:
                t0 = time.perf_counter()
                per_sample = []
                per_sample_stats = []
                for i in range(batch):
                    with tracer.span(f"sample:{i}", cat="runtime"):
                        t_s = time.perf_counter()
                        rstats: dict = {}
                        sample_env = dict(env)
                        for k in stream:
                            sample_env[k] = env[k][i]
                        per_sample.append(ops.run_compiled(
                            self.design, sample_env, device=dev,
                            stats_out=rstats,
                        ))
                        ms = (time.perf_counter() - t_s) * 1e3
                    tracer.counter("sample_latency_ms", {"ms": ms})
                    per_sample_stats.append(
                        dict(rstats, sample=i, wall_ms=round(ms, 3))
                    )
                self.last_run_stats = {
                    "samples": batch,
                    "batch_mode": "loop",
                    "wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "per_sample_ms": [s["wall_ms"]
                                      for s in per_sample_stats],
                    "groups": per_sample_stats[-1].get("groups", []),
                    "exec_cache": {
                        "hits": sum(s["exec_cache"]["hits"]
                                    for s in per_sample_stats),
                        "misses": sum(s["exec_cache"]["misses"]
                                      for s in per_sample_stats),
                    },
                    "dma_write_bytes":
                        per_sample_stats[-1].get("dma_write_bytes", 0),
                    "dma_read_bytes":
                        per_sample_stats[-1].get("dma_read_bytes", 0),
                    "exec_cache_total": dict(ops.exec_cache_stats),
                }
            # stack on device
            stacked = {
                k: torch.stack([o[k] for o in per_sample])
                for k in src.graph_outputs
            }
            if len(src.graph_outputs) == 1:
                return stacked[src.graph_outputs[0]]
            return stacked
        if batch is not None:  # batch_mode == "vmap"
            rstats = {}
            with self._tracer_scope() as tracer:
                t0 = time.perf_counter()
                with tracer.span(f"run:{src.name}", cat="runtime") as sargs:
                    out = ops.run_compiled_batched(
                        self.design, env, batch,
                        device=dev, stats_out=rstats)
                    sargs.update({"batch": batch,
                                  "buckets": rstats.get("batch_buckets")})
                ms = (time.perf_counter() - t0) * 1e3
                tracer.counter("batch_latency_ms", {"ms": ms})
            rstats["samples"] = batch
            rstats["batch_mode"] = "vmap"
            rstats["exec_cache_total"] = dict(ops.exec_cache_stats)
            self.last_run_stats = rstats
            if len(src.graph_outputs) == 1:
                return out[src.graph_outputs[0]]
            return out
        rstats = {}
        with self._tracer_scope() as tracer:
            with tracer.span(f"run:{src.name}", cat="runtime"):
                out = ops.run_compiled(self.design, env, device=dev,
                                       stats_out=rstats)
        rstats["samples"] = 1
        rstats["exec_cache_total"] = dict(ops.exec_cache_stats)
        self.last_run_stats = rstats
        if len(src.graph_outputs) == 1:
            return out[src.graph_outputs[0]]
        return out

    @staticmethod
    def _batch_extent(src: DFG, inputs: Mapping) -> Optional[int]:
        """The shared leading batch extent when *every* bound input has
        exactly one extra leading dim over its compiled shape; ``None``
        for per-sample shapes; a loud error for anything mixed."""
        if not inputs:
            return None
        batches = set()
        for k, v in inputs.items():
            want = src.values[k].shape
            got = tuple(getattr(v, "shape", ()))
            if got == want:
                batches.add(None)
            elif len(got) == len(want) + 1 and got[1:] == want:
                batches.add(int(got[0]))
            else:
                raise ValueError(
                    f"{src.name}: input {k!r} has shape {got}; expected "
                    f"{want} or (B,) + {want} for a batched run"
                )
        if batches == {None}:
            return None
        if batches == {0}:
            raise ValueError(
                f"{src.name}: batched run with batch extent 0 — there "
                "is nothing to execute (and no dtype to shape an empty "
                "result with)"
            )
        if len(batches) != 1:
            saw = sorted(
                ("unbatched" if b is None else b for b in batches), key=str
            )
            raise ValueError(
                f"{src.name}: inconsistent batching across inputs — "
                f"every input must carry the same leading batch extent "
                f"(saw {saw})"
            )
        return batches.pop()

    # -- reporting -----------------------------------------------------------

    def report(self) -> Report:
        d = self.design
        src = d.source

        def _bytes(names) -> int:
            return sum(
                math.ceil(src.values[v].total_bits / 8) for v in names
            )

        groups = tuple(
            GroupReport(
                name=g.name,
                nodes=tuple(g.node_names),
                cycles=g.cycles,
                bram=g.bram,
                dsp=g.dsp,
                spill_in_bytes=_bytes(g.spill_in),
                spill_out_bytes=_bytes(g.spill_out),
                weight_streamed=tuple(sorted(g.weight_streamed.items())),
            )
            for g in d.groups
        )
        transitions = tuple(
            TransitionReport(
                left=left.name,
                right=right.name,
                write_bytes=w,
                read_bytes=r,
                cycles=transition_cycles(w, r),
            )
            for (left, right), (w, r) in zip(
                zip(d.groups, d.groups[1:]), d.boundary_traffic()
            )
        )
        return Report(
            graph=src.name,
            target=self.target_name,
            feasible=d.feasible,
            groups=groups,
            total_cycles=d.total_cycles,
            max_group_cycles=d.max_group_cycles,
            spill_cycles=d.spill_cycles,
            max_bram=d.max_bram,
            b_total=d.b_total,
            max_dsp=d.max_dsp,
            d_total=d.d_total,
            spill_bytes=sum(s.bytes for s in d.spills()),
            transitions=transitions,
            telemetry=self._telemetry(),
        )

    def _telemetry(self) -> Optional[dict]:
        """Measured compile/run telemetry: per-pass wall
        times, partition-DP search statistics, cumulative jit-cache
        counters, and the most recent run's counters.  ``None`` only
        for bare designs with nothing recorded."""
        import sys

        d = self.design
        tel: dict = {}
        if d.pass_result is not None:
            tel["passes"] = [
                {"name": p.name, "wall_ms": round(p.wall_ms, 3),
                 "changed": p.changed}
                for p in d.pass_result.passes
            ]
        if d.dp_stats is not None:
            tel["partition"] = d.dp_stats
        # the exec-cache counters live in repro_torch.kernels.ops; only
        # surface them when the kernel layer is already loaded, so a
        # model-only report() does not import the runtime
        ops = sys.modules.get("repro_torch.kernels.ops")
        if ops is not None:
            tel["exec_cache"] = dict(ops.exec_cache_stats)
        if self.last_run_stats is not None:
            tel["last_run"] = self.last_run_stats
        # live aggregated series: when a metrics registry is
        # ambient, its snapshot rides in the report like every other
        # measured (compare-excluded) section
        from repro_torch.instrument import metrics as _metrics

        reg = _metrics.current()
        if reg.enabled:
            tel["metrics"] = reg.snapshot()
        diags = self.diagnostics
        if diags:
            from repro_torch.analyze import severity_counts

            tel["diagnostics"] = {
                "counts": severity_counts(diags),
                "items": [x.to_json() for x in diags],
            }
        return tel or None

    # -- persistence (the benchmark cache) -----------------------------------

    def save(self, path: str) -> str:
        """Pickle the compiled design (schedule IR only — cheap)."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"version": _SAVE_VERSION, "design": self.design}, f)
        return path

    @classmethod
    def load(cls, path: str) -> "CompiledArtifact":
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) or "design" not in payload:
            raise ValueError(f"{path}: not a CompiledArtifact save file")
        if payload.get("version") != _SAVE_VERSION:
            raise ValueError(
                f"{path}: save version {payload.get('version')} != "
                f"{_SAVE_VERSION} — recompile instead of loading"
            )
        return cls(payload["design"])


def params_from_numpy(env: Mapping, device=None) -> dict:
    """Carry an env dict ``{value name: NumPy array}`` (weights, biases,
    inputs — e.g. the params of a model made for the reference package)
    onto ``device`` as ``{name: torch.Tensor}``, dtypes kept: int8 /
    uint8 / int16 / int32 / float32 as they are; 64-bit types narrow to
    32 bits.  NumPy has no bfloat16: pass such a value as float32 and
    cast the tensor (``.to(torch.bfloat16)``), which rounds to nearest
    even.  ``device=None`` means the CUDA card (and raises without
    one)."""
    from repro_torch.device import env_to_device, resolve_device

    return env_to_device(env, resolve_device(device))


def compile_graph(
    graph,
    options: Optional[CompileOptions] = None,
    **option_kwargs,
) -> CompiledArtifact:
    """The front door: graph (DFG | Sequential | Graph builder) +
    options → :class:`CompiledArtifact`.

    ``option_kwargs`` are sugar for ``CompileOptions(**option_kwargs)``
    (``compile_graph(net, target="zu3eg")``); mixing them with an
    explicit ``options`` bundle is an error.
    """
    if options is not None and option_kwargs:
        raise ValueError(
            "pass either options=CompileOptions(...) or keyword knobs, "
            "not both"
        )
    if options is None:
        options = CompileOptions(**option_kwargs)
    dfg = graph.build() if hasattr(graph, "build") else graph
    if not isinstance(dfg, DFG):
        raise TypeError(
            f"compile_graph needs a DFG or a builder with .build(), got "
            f"{type(graph).__name__}"
        )
    return CompiledArtifact(compile_design(dfg, options=options))
