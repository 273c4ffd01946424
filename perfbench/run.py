#!/usr/bin/env python3
"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It loads the cell's configuration, traffic and limits by name
(``perfbench/lib/cells.py``), builds the program (the port,
``src/repro_torch``) on weights drawn from the seed, warms up every shape
the traffic uses, measures whole steps for ``--seconds``, and
then checks what the timed path produced against the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a profiled part of
the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit, which also end
standard error.

It exits 3 without a result where there is no CUDA card or fewer than the
cell asks for, 2 where the checkout has no program, and 4 where the JAX
package or JAX itself was loaded.  Kernel builds go to ``build/`` inside
the checkout.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name, power limit and clocks as ``nvidia-smi`` reads
    them."""
    query = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu")
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return f"{query}: {r.stdout.strip() or r.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def _setup_env() -> None:
    """Every build and kernel cache of the program inside the checkout."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def execute(cell, seed: int, seconds: float, trace: bool, device, *,
            system: str = "program", t0: float = T0,
            log=_err) -> dict:
    """Run ``cell`` on ``device`` and return its result object (the last
    line's keys; ``checks`` last)."""
    import torch

    from perfbench.lib import cells, compare

    drv = cells.driver(cell)
    out = drv.run(cell, seed, seconds, trace, torch.device(device), t0, log,
                  system=system)
    correct, checks = compare.verdict(out["numbers"], cell.limits)
    correct = correct and out["failed"] == 0 and (
        out["attempted"] > 0 or system != "program")
    metrics = {}
    if not trace:
        # an end-to-end metric ``<quantity>.<kind>`` reports the driver's
        # ``<quantity>`` for the kind of cell it lists, under a bound of
        # its own
        read = dict(out["metrics"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            value = read.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    summary = out["summary"]
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace and summary is not None:
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(summary, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps}
        log(f"trace: {len(summary.units)} units, read in "
            f"{summary.read_s:.3f} s; kernel calls "
            f"{[u.calls for u in summary.units[:2]]}")
    log(f"numbers: {out['numbers']}")
    result["timing"] = {k: out.get(k) for k in ("setup_s", "window_s",
                                                "reference_s")}
    result["checks"] = {n: {k: v if math.isfinite(v) else str(v)
                            for k, v in c.items()} for n, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _err(f"no program under {ROOT / 'src' / 'repro_torch'}: the "
             "benchmark measures the port and runs nothing without it")
        return 2
    _setup_env()
    import torch

    from perfbench.lib import cells, port

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        _err("no CUDA card: torch.cuda.is_available() is False; the "
             "benchmark does not fall back to the CPU")
        return 3
    if torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} cards, this machine has "
             f"{torch.cuda.device_count()}")
        return 3
    print(f"card: {card_line()}", flush=True)
    seed = args.seed % 2 ** 63
    torch.cuda.reset_peak_memory_stats()
    result = execute(cell, seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        _err(f"loaded modules of JAX or the JAX package: {bad}")
        return 4
    print(f"peak memory: {result['device']['memory_peak_bytes']} bytes; "
          f"kernel calls: {port.kernel_calls()}", flush=True)
    print(f"card after the run: {card_line()}", flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        _err(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
