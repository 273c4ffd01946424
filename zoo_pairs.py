#!/usr/bin/env python3
"""Time the zoo's conv calls and zoo serving of two checkouts of this repo
on one NVIDIA GPU, in alternating processes.

    python3 zoo_pairs.py --base DIR [--pairs 10]

``DIR`` is another checkout of the repo (its ``src/repro_torch`` is timed
as "base"; this file's checkout is "change").  Turns run base, change,
change, base, ... each in a fresh process that puts one checkout's
``src`` first on ``sys.path`` and runs this file's timing code, so both
packages are timed by the same code:

- each zoo row of ``chip_smoke.MAIN_SHAPES`` (batch 32), int32 and f32:
  ``ops.conv2d_stream`` by CUDA events (``ms``: the host's enqueue
  included, which is what bounds these rows), five rounds, and the card's
  time in the kernel by the profiler (``device_ms``);
- the planner's host time on the shape's first call (the uncached
  ``dse.plan_conv_rows``);
- ``ServeEngine`` on each zoo model, 256 requests at 2000 offered req/s
  (``chip_smoke.serve``'s load): req/s and p50 / p99 ms.

Prints one JSON line per turn, then a summary line: per number the
median of each side, the change's difference in per cent and each
side's spread (the distance between its quartiles).  Everything goes to
``chiprun_out/zoo_pairs.json`` as well.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "zoo_pairs.json")


def turn(src: str) -> dict:
    """One side's numbers, in this process, with ``src`` first on the
    path."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs_
    import repro_torch
    from repro_torch.core import dse
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import ops

    assert os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__))) == os.path.abspath(src)
    cs.LIBRARY.load()
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for name, b, h, w_, cin, cout, k, stride in cs_.MAIN_SHAPES:
        if b == 1:
            continue
        for dtype in (torch.int32, torch.float32):
            x = cs_._rand(gen, (b, h, w_, cin), dtype, torch)
            w = cs_._rand(gen, (k, k, cin, cout), dtype, torch)
            run = lambda: ops.conv2d_stream(x, w, stride=stride,
                                            epilogue="relu")
            rounds = [cs_.time_ms(run, warmup=50, reps=400)
                      for _ in range(5)]
            pads = ops._conv_pads(h, w_, k, k, stride, "SAME")
            shape = dict(h_out=(h + sum(pads[0]) - k) // stride + 1,
                         w_out=(w_ + sum(pads[1]) - k) // stride + 1,
                         c_in=cin, c_out=cout, kh=k, kw=k, stride=stride,
                         batch=b)
            plan = getattr(dse.plan_conv_rows, "__wrapped__",
                           dse.plan_conv_rows)
            t0 = time.perf_counter()
            for _ in range(20):
                plan(**shape)
            plan_ms = (time.perf_counter() - t0) * 1e3 / 20
            key = f"{name} {str(dtype)[6:]}"
            rows[key + " ms"] = sum(rounds) / len(rounds)
            rows[key + " device_ms"] = cs_.device_ms(
                run, reps=50, kernel="conv2d_stream_kernel")
            rows[key + " plan_host_ms"] = plan_ms
    suite = repro_torch.suite()
    arts = {m: repro_torch.compile_graph(suite[m](), target="kv260")
            for m in cs_.ZOO_MODELS}
    for eng in cs_.serve(torch, arts, models=cs_.ZOO_MODELS)["engines"]:
        for k in ("achieved_qps", "p50_ms", "p99_ms"):
            if k in eng:
                rows[f"serve {eng['model']} {k}"] = eng[k]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("zoo_pairs: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    if not args.base:
        ap.error("--base is required")
    sides = {"base": os.path.join(os.path.abspath(args.base), "src"),
             "change": os.path.join(ROOT, "src")}
    order = []
    for i in range(args.pairs):
        order += ["base", "change"] if i % 2 == 0 else ["change", "base"]
    turns = []
    for side in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             sides[side]], capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append({"side": side, "rows": rows})
        print(json.dumps({"turn": side, **rows}), flush=True)
    summary = {}
    for key in turns[0]["rows"]:
        vals = {s: [t["rows"][key] for t in turns
                    if t["side"] == s and t["rows"].get(key) is not None]
                for s in ("base", "change")}
        if not all(vals.values()):
            continue
        med = {s: statistics.median(v) for s, v in vals.items()}
        q = {s: statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
             for s, v in vals.items()}
        summary[key] = {"base": med["base"], "change": med["change"],
                        "change_pct": 100 * (med["change"] / med["base"] - 1),
                        "base_iqr": q["base"][2] - q["base"][0],
                        "change_iqr": q["change"][2] - q["change"][0],
                        "base_each": vals["base"],
                        "change_each": vals["change"]}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"order": order, "turns": turns, "summary": summary}, f,
                  indent=1)
    print(json.dumps({"summary": {
        k: {s: round(v[s], 5) for s in ("base", "change", "change_pct",
                                        "base_iqr")}
        for k, v in summary.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
