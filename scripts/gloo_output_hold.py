"""Does gloo hold a collective's output after the call returns?

``tp.gathered_bytes()`` counts a gathered leaf until its storage dies.
After a mesh step on CPU gloo ranks the count sometimes still holds the
step's last gathered buffer for a moment.  This script shows who holds
it, with no model and with gc off: each rank calls
``dist.all_gather_into_tensor`` ``--calls`` times on a fresh output and
reads the output storage's use count before the call and right after it
returns.  A count above its value before the call, with no Python
reference added, is the process group's own; the script then waits (at
most 1 s) until it drops and records how long that took.  ``--groups``
runs that many two-rank groups at once, to load the host's cores as a
parallel test run does.

Usage::

  PYTHONPATH=src python scripts/gloo_output_hold.py --groups 6
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

RANK = r"""
import datetime, gc, json, os, sys, time
import torch
import torch.distributed as dist

rank, out, calls = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
gc.disable()
use = torch._C._storage_Use_Count
held, waits = 0, []
for _ in range(calls):
    buf = torch.ones(8192)
    whole = buf.new_empty(2 * 8192)
    st = whole.untyped_storage()
    before = use(st._cdata)
    dist.all_gather_into_tensor(whole, buf)
    if use(st._cdata) != before:
        held += 1
        t0 = time.perf_counter()
        while use(st._cdata) != before and time.perf_counter() - t0 < 1:
            pass
        waits.append(time.perf_counter() - t0)
dist.destroy_process_group()
print(json.dumps({"calls": calls, "held_after_return": held,
                  "longest_hold_s": max(waits, default=0.0),
                  "never_released": sum(w >= 1 for w in waits)}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--calls", type=int, default=5000)
    args = ap.parse_args(argv)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for g in range(args.groups):
            out = os.path.join(tmp, str(g))
            os.makedirs(out)
            procs += [subprocess.Popen(
                [sys.executable, "-c", RANK, str(r), out, str(args.calls)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                env=env) for r in range(2)]
        ranks = [json.loads(p.communicate()[0].strip().splitlines()[-1])
                 for p in procs]
    print(json.dumps({
        "torch": __import__("torch").__version__, "groups": args.groups,
        "ranks": len(ranks), "calls": sum(r["calls"] for r in ranks),
        "held_after_return": sum(r["held_after_return"] for r in ranks),
        "longest_hold_s": max(r["longest_hold_s"] for r in ranks),
        "never_released": sum(r["never_released"] for r in ranks)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
