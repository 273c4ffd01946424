#!/usr/bin/env python3
"""Readings from which a cell's limits are set, in one process: the
program on many seeds, the control (the reference in float8 in the
program's place) and planted faults on a few, each compared with the
reference as a run compares it.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--fault half_batch --fault-seeds ...] \\
        [--seconds 0] --out <file.jsonl>

``--seconds 0`` runs the shortest window the traffic allows (one step).
Each reading is one JSON line of ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import run  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run._setup_env()
    import torch

    from perfbench.lib import cells, faults

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = cells.load_cell(args.workload)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    jobs = ([("program", s) for s in _seeds(args.seeds)]
            + [("control", s) for s in _seeds(args.control_seeds)]
            + [(args.fault, s) for s in _seeds(args.fault_seeds)])
    for system, seed in jobs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kind = "control" if system == "control" else "program"
        if system in faults.FAULTS:
            with faults.plant(system):
                r = run.execute(cell, seed, args.seconds, False, "cuda",
                                system=kind, t0=t0)
        else:
            r = run.execute(cell, seed, args.seconds, False, "cuda",
                            system=kind, t0=t0)
        line = {"workload": args.workload, "system": system, "seed": seed,
                "s": time.perf_counter() - t0, **r}
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
