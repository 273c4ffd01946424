"""Multi-rank runs of the port on the CPU for the ``tests/test_torch_*``
files: ``world`` Python processes, each a gloo rank of one process group
started on a file store under the test's ``tmp_path`` (no port, so the
pytest-xdist workers never collide), each limited in threads and in wall
time, so that a hung rank fails its test instead of holding the suite.

The rank code sees ``RANK``, ``WORLD`` and ``OUT`` (the directory to
write results to, e.g. ``torch.save(obj, f"{OUT}/rank{RANK}.pt")``)."""
import os
import subprocess
import sys
import textwrap
import time

import torch

from _torch_port import REPO

#: the process group's own limit on a collective, and the wall-clock
#: limit of a whole multi-rank run
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 300

_HEADER = """\
import datetime, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if WORLD:
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(OUT, "store"),
        rank=RANK, world_size=WORLD,
        timeout=datetime.timedelta(seconds={timeout}))
"""


def run_ranks(code: str, world: int, out_dir, *,
              timeout: int = RUN_TIMEOUT_S) -> list:
    """Run ``code`` on ``world`` gloo ranks (``world`` 0: one process with
    no process group) → each rank's standard output; raises
    ``AssertionError`` with the failing ranks' errors if any rank fails or
    the run outlasts ``timeout`` seconds."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    src = _HEADER.format(timeout=GROUP_TIMEOUT_S) + textwrap.dedent(code)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(world), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(max(world, 1))]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{world} ranks outlasted {timeout} s")
    bad = [(r, p.returncode, err[-3000:])
           for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, bad
    return [out for out, _ in outs]


def load_rank(out_dir, rank: int):
    """What rank ``rank`` saved as ``rank{rank}.pt``."""
    return torch.load(os.path.join(str(out_dir), f"rank{rank}.pt"),
                      weights_only=False)
