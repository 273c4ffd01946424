"""Large-scale runnability on one host, on the PyTorch/CUDA port:
``examples/elastic_resilience.py`` through ``repro_torch``.

  1. train a small model on a (data 2, model 2) mesh with async
     checkpoints,
  2. kill it mid-run (injected node failure) — auto-restart resumes,
  3. *elastically re-mesh*: restore the same checkpoint onto a (4, 1)
     mesh (pure data parallelism) and then onto one device, continuing
     training each time,
  4. show the straggler watchdog flagging a slowed step.

The (2, 2) and (4, 1) meshes are four gloo ranks on the CPU, which the
script starts itself: spawned processes on a ``file://`` store in its
temporary directory (no port, no ``torchrun``), each with a wall-time
limit, so a hung rank fails the run instead of hanging it.  The single
device is ``--device``: on the CUDA card, the checkpoint the CPU ranks
wrote is restored onto a 1 × 1 NCCL mesh and trained there through the
hand-written flash-attention kernels.

Run:  PYTHONPATH=src python examples/elastic_resilience_torch.py               # the CUDA card
      PYTHONPATH=src python examples/elastic_resilience_torch.py --device cpu  # no card
"""
import argparse
import datetime
import multiprocessing
import os
import sys
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, single_device_mesh
from repro_torch.launch.train import train
from repro_torch.runtime.resilience import StragglerWatchdog

COMMON = dict(arch="qwen2-0.5b", smoke=True, batch=4, seq=64, lr=1e-3,
              ckpt_every=10, log_every=10, seed=0)
#: the gloo ranks of phases 1-2
WORLD = 4
#: a collective's limit, and the wall-clock limit of phases 1-2 together
GROUP_TIMEOUT_S = 300
RANKS_TIMEOUT_S = 900


def _rank_main(rank: int, world: int, tmp: str, ckpt: str,
               threads: int) -> None:
    """Phases 1-2 on one gloo rank (a spawned process): its printed lines
    and, if it fails, its traceback go to ``rank<r>.log`` and its results
    to ``rank<r>.pt`` in ``tmp``."""
    sys.stdout = sys.stderr = open(os.path.join(tmp, f"rank{rank}.log"), "w",
                                   buffering=1)
    torch.set_num_threads(threads)
    # the ranks share one host: keep gloo's pairs on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        say = print if rank == 0 else (lambda *a, **k: None)
        # 1+2: mesh (2, 2), crash at step 15, auto-restart
        say("== phase 1: (data=2, model=2) mesh, crash injected at 15 ==")
        t0 = time.perf_counter()
        out1 = train(steps=30, ckpt_dir=ckpt, fail_at=(15,),
                     mesh=make_host_mesh((2, 2), ("data", "model")),
                     device="cpu", **COMMON)
        t1 = time.perf_counter()
        # 3a: elastic re-mesh to pure data parallelism, (4, 1)
        say("== phase 2: SAME checkpoint restored on a (data=4) mesh ==")
        out2 = train(steps=45, ckpt_dir=ckpt,
                     mesh=make_host_mesh((4, 1), ("data", "model")),
                     device="cpu", **COMMON)
        t2 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    torch.save({"phase1": out1, "phase2": out2, "seconds": [t1 - t0, t2 - t1]},
               os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(tmp: str, ckpt: str) -> list:
    """Phases 1-2 on ``WORLD`` spawned gloo ranks → each rank's results;
    rank 0's printed lines are printed here.  Raises if a rank fails or
    the ranks outlast ``RANKS_TIMEOUT_S``."""
    ctx = multiprocessing.get_context("spawn")
    threads = max(1, torch.get_num_threads() // WORLD)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, tmp, ckpt, threads))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()

    def log(r: int) -> str:
        path = os.path.join(tmp, f"rank{r}.log")
        if not os.path.exists(path):          # failed before it began
            return f"rank {r} wrote no log"
        with open(path) as f:
            return f.read()

    if hung:
        raise TimeoutError(f"gloo ranks {hung} outlasted {RANKS_TIMEOUT_S} s")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"gloo rank(s) {bad} failed:\n"
                           + "\n".join(log(r)[-3000:] for r in bad))
    print(log(0), end="", flush=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def elastic(device) -> dict:
    """Phases 1-4, the single device ``device``; returns each gloo rank's
    results (``ranks``: ``phase1``, ``phase2``, ``seconds``), the ranks'
    wall time, their start included (``ranks_seconds``), phase 3's
    (``phase3``, ``phase3_seconds``) and the watchdog."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, ckpt)
        ranks_s = time.perf_counter() - t0
        out1, out2 = ranks[0]["phase1"], ranks[0]["phase2"]
        assert out1["final_step"] == 30
        assert out2["final_step"] == 45
        assert len(out2["losses"]) == 15, "must resume at 30, not restart"

        # 3b: down to a single device (a 1 × 1 mesh: a world of one)
        print(f"== phase 3: same checkpoint on a single device ({device}) ==",
              flush=True)
        started = not dist.is_initialized()
        t0 = time.perf_counter()
        try:
            out3 = train(steps=50, ckpt_dir=ckpt,
                         mesh=single_device_mesh(device), device=device,
                         **COMMON)
        finally:
            if started and dist.is_initialized():
                dist.destroy_process_group()
        phase3_s = time.perf_counter() - t0
        assert out3["final_step"] == 50

    # 4: watchdog demo
    wd = StragglerWatchdog(window=16, threshold=2.5)
    for i in range(12):
        wd.start(); time.sleep(0.003); wd.stop(i)
    wd.start(); time.sleep(0.05); wd.stop(12)     # the straggler
    print(f"watchdog flagged steps: {[s for s, _ in wd.flagged]} "
          f"(median {wd.median*1e3:.1f} ms)")
    assert wd.flagged, "straggler not flagged"
    print("OK — crash-restart, 2 elastic re-meshes, straggler detection")
    return {"ranks": ranks, "ranks_seconds": ranks_s, "phase3": out3,
            "phase3_seconds": phase3_s, "watchdog": wd}


def main(argv=None, out: Optional[dict] = None) -> int:
    """``out``, when given, receives :func:`elastic`'s results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of phase 3 (default: the CUDA card)")
    args = ap.parse_args(argv)
    res = elastic(resolve_device(args.device))     # no card → raises here
    if out is not None:
        out.update(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
