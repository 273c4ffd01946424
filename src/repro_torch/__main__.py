"""``python -m repro_torch`` — the command-line front door.

Subcommands:

* ``list``
    Named graphs (the paper suite + showcases + zoo) and device targets.
* ``compile <graph | model.onnx | model.json> [--target kv260]
  [--strategy balanced] [--weight-streaming auto|off] [--max-unroll N]
  [--no-passes] [--emit DIR] [--save FILE] [--run] [--device D]
  [--trace PATH] [--quiet]``
    Build the named suite graph — or **import** an ONNX model / JSON
    model card (``repro_torch.frontends``) — compile it under one
    :class:`repro_torch.api.CompileOptions`, print the cycles/BRAM/DSP/spill
    report, and optionally emit the HLS C++ kernels, persist the
    artifact, or execute it (``--run``: on the CUDA card through the
    hand-written kernels, or with ``--device cpu`` through their plain
    PyTorch versions) as a numeric smoke check.  Imported weights ride
    along into ``--run``.
* ``zoo [--export DIR]``
    The bundled model zoo (LeNet-5, tiny-VGG, residual edge model);
    ``--export`` writes each model's JSON card (``examples/lenet5.json``
    is one of these).
* ``lint <graph | model.onnx | card.json> ... [--all] [--target T ...]
  [--json PATH] [--fail-on error|warning|info] [--quiet]``
    Static analysis: compile each graph (suite name or model
    file) for each target and print the ``repro_torch.analyze`` diagnostics
    — stream-skew/deadlock, integer overflow, schedule hazards, model
    hygiene.  ``--all`` lints the whole named suite (zoo included);
    ``--json`` writes the versioned diagnostics document (the CI
    artifact); ``--fail-on`` sets the severity that makes the exit
    status 1 (default ``error``).
* ``profile <graph | model.onnx | card.json> [--target T ...]
  [--reps N] [--warmup N] [--clock-mhz F] [--threshold F]
  [--device D] [--json PATH] [--no-layers] [--quiet]``
    Modeled-vs-measured profiling: compile the graph for each target,
    execute it (on the CUDA card unless ``--device cpu``), and print
    the per-group table joining the resource model's cycle predictions
    against measured wall times (implied clock, model-error ratio,
    roofline utilization), flagging groups whose ratio drifts past
    ``--threshold``× the median.
    ``--json`` writes the machine-readable document; on the card its
    provenance names the card, its power limit and the torch and CUDA
    versions.

``--run`` and ``profile`` execute on the CUDA card by default; with no
card they exit 1 and say so, and run on the host only when asked with
``--device cpu``.  ``list``, ``zoo``, ``lint`` and ``compile`` without
``--run`` touch no device.

Exit status: 0 on success, 1 on an infeasible design, failed run, a
missing device, or diagnostics at/above ``--fail-on``, 2 on bad
arguments (argparse convention).
"""
from __future__ import annotations

import argparse
import os
import sys


def _device_arg(text: str) -> str:
    """argparse ``type`` of ``--device``: any string ``torch.device``
    accepts (a malformed one is a bad argument, exit 2)."""
    import torch

    try:
        torch.device(text)
    except RuntimeError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return text


def _resolve(spec):
    """The ``torch.device`` to execute on (``None``: the CUDA card), or
    ``None`` after printing why it is not there."""
    from repro_torch.device import resolve_device

    try:
        return resolve_device(spec)
    except RuntimeError as e:
        print(f"error: {e} (on the command line: --device cpu)",
              file=sys.stderr)
        return None


def _card_provenance(dev) -> dict:
    """What names the card a profile ran on: its ``nvidia-smi``
    ``name, power.limit`` (``None`` where ``nvidia-smi`` cannot say) and
    the torch and CUDA versions."""
    import subprocess

    import torch

    uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid", ""))
    smi = None
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        rows = []
    for row in rows:
        card_uuid, _, rest = row.partition(",")
        if len(rows) == 1 or (uuid and card_uuid.strip().endswith(uuid)):
            smi = rest.strip()
            break
    return {"nvidia_smi": smi, "name": torch.cuda.get_device_name(dev),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _cmd_list() -> int:
    from repro_torch import api

    print("graphs:")
    for name in sorted(api.suite()):
        print(f"  {name}")
    print("targets:")
    for name, t in sorted(api.TARGETS.items()):
        print(f"  {name}  (DSP={t.d_total}, BRAM18K={t.b_total})")
    return 0


def _cmd_zoo(args: argparse.Namespace) -> int:
    from repro_torch.frontends import zoo

    print("zoo models (compile with `python -m repro_torch compile <name>`):")
    for name, make in sorted(zoo.ZOO.items()):
        dfg = make()
        consts = sum(
            v.num_elements for v in dfg.values.values() if v.is_constant
        )
        print(f"  {name:<18} {len(dfg.nodes):>2} layers, "
              f"{consts / 1024:.1f} Ki params, "
              f"input {dfg.values[dfg.graph_inputs[0]].shape}")
    if args.export:
        os.makedirs(args.export, exist_ok=True)
        for name in sorted(zoo.ZOO):
            path = os.path.join(args.export, f"{name}.json")
            with open(path, "w") as f:
                f.write(zoo.card_json(name))
            print(f"exported {path}")
    return 0


def _load_graph(spec: str, quiet: bool = False):
    """(dfg, params) for a suite name or an importable model file.

    Suite names win over same-named filesystem entries (a stray
    ``lenet5/`` directory in cwd must not shadow the zoo graph);
    model files are recognized by extension or an explicit path.
    """
    from repro_torch import api

    graphs = api.suite()
    ext = os.path.splitext(spec)[1].lower()
    if spec in graphs and ext not in (".onnx", ".json"):
        return graphs[spec](), {}
    if ext in (".onnx", ".json") or os.path.exists(spec):
        from repro_torch import frontends

        model = frontends.import_model(spec)
        missing = model.missing_params()
        if missing and not quiet:
            print(f"# note: {len(missing)} constant(s) have no imported "
                  f"weights (random init): {', '.join(missing[:6])}"
                  f"{', …' if len(missing) > 6 else ''}")
        return model.dfg, model.params
    raise ValueError(
        f"unknown graph {spec!r} — run `python -m repro_torch list`, or "
        "pass a .onnx / .json model file"
    )


def _cmd_compile(args: argparse.Namespace) -> int:
    from repro_torch import api

    dev = None
    if args.run:
        dev = _resolve(args.device)
        if dev is None:
            return 1
    try:
        dfg, params = _load_graph(args.graph, quiet=args.quiet)
    except OSError as e:
        # missing file, directory-instead-of-file, unreadable path, …:
        # all bad arguments (exit 2), never a raw traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    options = api.CompileOptions(
        target=args.target,
        strategy=args.strategy,
        weight_streaming=args.weight_streaming,
        max_unroll=args.max_unroll,
        passes=() if args.no_passes else None,
        trace=args.trace if args.trace else False,
    )
    art = api.compile_graph(dfg, options)
    if not args.quiet:
        print(art.report())
    if args.emit:
        for path in art.emit_hls(args.emit):
            print(f"emitted {path}")
    if args.save:
        print(f"saved {art.save(args.save)}")
    if args.run:
        out = art.run(params=params or None, device=dev)
        outs = out if isinstance(out, dict) else {"output": out}
        for name, arr in outs.items():
            print(f"ran OK: {name} shape {tuple(arr.shape)} dtype {arr.dtype}")
    if args.trace:
        # written last so pass/DP/DSE spans, emitter timing, and any
        # --run runtime counters all land in the one trace
        print(f"trace written {art.write_trace(args.trace)}")
    return 0 if art.feasible else 1


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch import analyze, api

    specs = list(args.graphs)
    if args.all:
        specs.extend(sorted(api.suite()))
    if not specs:
        print("error: pass at least one graph/model, or --all",
              file=sys.stderr)
        return 2
    targets = args.target or ["kv260"]

    all_diags: list = []
    meta: dict = {"targets": list(targets), "graphs": []}
    for spec in specs:
        try:
            dfg, _params = _load_graph(spec, quiet=True)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for target in targets:
            options = api.CompileOptions(target=target, lint="warn")
            design = api.compile_design(dfg, options=options)
            diags = list(design.diagnostics)
            meta["graphs"].append({
                "graph": dfg.name,
                "target": target,
                "counts": analyze.severity_counts(diags),
            })
            all_diags.extend(diags)
            if not args.quiet:
                worst = analyze.max_severity(diags)
                print(f"{dfg.name} @ {target}: {len(diags)} diagnostic(s)"
                      f"{f', worst {worst.value}' if worst else ''}")
                for d in diags:
                    print(f"  {target}: {d.format()}")

    if args.json:
        import json

        doc = analyze.diagnostics_to_json(all_diags, meta=meta)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"diagnostics written {args.json}")

    failing = analyze.at_or_above(all_diags, args.fail_on)
    if failing:
        print(f"lint: {len(failing)} diagnostic(s) at/above "
              f"{args.fail_on!r}", file=sys.stderr)
        return 1
    return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    from repro_torch import api
    from repro_torch.instrument import profile_artifact

    dev = _resolve(args.device)
    if dev is None:
        return 1
    try:
        dfg, _params = _load_graph(args.graph, quiet=args.quiet)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    targets = args.target or ["kv260"]
    reports = []
    for target in targets:
        art = api.compile_graph(dfg, target=target)
        rep = profile_artifact(
            art, reps=args.reps, warmup=args.warmup,
            clock_mhz=args.clock_mhz, threshold=args.threshold,
            device=dev,
        )
        reports.append(rep)
        if not args.quiet:
            print(rep.format_table(layers=not args.no_layers))
            print()
    if args.json:
        import json

        from repro_torch.instrument import provenance

        doc = {
            "version": 1,
            "graph": dfg.name,
            "provenance": provenance(
                extra={"device": _card_provenance(dev)}
                if dev.type == "cuda" else None),
            "profiles": [r.to_json() for r in reports],
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"profile written {args.json}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="MING reproduction CLI: build/import + compile + emit "
                    "through the public API",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="named graphs and device targets")
    z = sub.add_parser("zoo", help="the bundled model zoo")
    z.add_argument("--export", metavar="DIR",
                   help="write each zoo model's JSON card here")
    c = sub.add_parser("compile",
                       help="compile a named graph or model file")
    c.add_argument("graph",
                   help="suite graph name (see `list`), or a path to a "
                        ".onnx model / .json model card")
    c.add_argument("--target", default="kv260",
                   help="device preset (kv260 | zu3eg)")
    c.add_argument("--strategy", default="balanced",
                   choices=("balanced", "greedy"))
    c.add_argument("--weight-streaming", default="auto",
                   choices=("auto", "off"))
    c.add_argument("--max-unroll", type=int, default=None)
    c.add_argument("--no-passes", action="store_true",
                   help="skip the rewrite pipeline")
    c.add_argument("--emit", metavar="DIR",
                   help="write HLS C++ kernels + host schedule here")
    c.add_argument("--save", metavar="FILE",
                   help="persist the CompiledArtifact (pickle)")
    c.add_argument("--run", action="store_true",
                   help="execute it on --device with imported weights "
                        "when available")
    c.add_argument("--device", type=_device_arg, default=None,
                   help="where --run executes (default: the CUDA card; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    c.add_argument("--trace", metavar="PATH",
                   help="instrument the compile (and --emit/--run) and "
                        "write a Chrome trace-event JSON here "
                        "(chrome://tracing / Perfetto)")
    c.add_argument("--quiet", action="store_true",
                   help="suppress the report table")
    lt = sub.add_parser("lint",
                        help="static diagnostics for graphs / model files")
    lt.add_argument("graphs", nargs="*",
                    help="suite graph names or .onnx / .json model files")
    lt.add_argument("--all", action="store_true",
                    help="lint every named suite graph (zoo included)")
    lt.add_argument("--target", action="append", default=None,
                    help="device preset; repeatable (default: kv260)")
    lt.add_argument("--json", metavar="PATH",
                    help="write the JSON diagnostics document here")
    lt.add_argument("--fail-on", default="error",
                    choices=("error", "warning", "info"),
                    help="exit 1 when diagnostics at/above this severity "
                         "fire (default: error)")
    lt.add_argument("--quiet", action="store_true",
                    help="suppress per-diagnostic lines")
    pf = sub.add_parser("profile",
                        help="modeled-vs-measured per-group profiling")
    pf.add_argument("graph",
                    help="suite graph name (see `list`), or a path to a "
                         ".onnx model / .json model card")
    pf.add_argument("--target", action="append", default=None,
                    help="device preset; repeatable (default: kv260)")
    pf.add_argument("--reps", type=int, default=3,
                    help="measured repetitions after warmup (default 3)")
    pf.add_argument("--warmup", type=int, default=1,
                    help="discarded warmup runs (default 1)")
    pf.add_argument("--clock-mhz", type=float, default=300.0,
                    help="nominal fabric clock for modeled_ms "
                         "(default 300)")
    pf.add_argument("--threshold", type=float, default=2.0,
                    help="flag groups whose model-error ratio is this "
                         "many x off the median (default 2.0)")
    pf.add_argument("--device", type=_device_arg, default=None,
                    help="where to execute and measure (default: the "
                         "CUDA card; 'cpu' times the kernels' plain "
                         "PyTorch versions)")
    pf.add_argument("--json", metavar="PATH",
                    help="write the JSON profile document here")
    pf.add_argument("--no-layers", action="store_true",
                    help="suppress the per-layer attribution table")
    pf.add_argument("--quiet", action="store_true",
                    help="suppress the tables (useful with --json)")
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list()
    if args.cmd == "zoo":
        return _cmd_zoo(args)
    from repro_torch.passes import PartitionError

    try:
        if args.cmd == "lint":
            return _cmd_lint(args)
        if args.cmd == "profile":
            return _cmd_profile(args)
        return _cmd_compile(args)
    except PartitionError as e:
        # a valid command line whose design cannot be scheduled: exit 1
        # (infeasible), not 2 (bad arguments)
        print(f"infeasible: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
