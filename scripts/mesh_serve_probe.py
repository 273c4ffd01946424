"""Where the time of a mesh serve call goes, on the card.

Serves llama3.2-1b (4 × 1024-token prompts, full width and depth,
seeded bf16 weights) on the 1 × 1 NCCL mesh (``single_device_mesh()``)
and with ``mesh=None`` in one process, then prints one JSON line:

1. the host µs a call of each forward collective takes at the path's
   shapes — ``tp.sum_partial`` of a prefill's (4, 1024, 2048) and a
   decode step's (4, 1, 2048) partial, ``tp.gather`` of the vocabulary
   logits, ``tp.gather_rows`` — and of a bare ``dist.all_reduce`` on the
   same tensors: enqueue (no synchronize) and end to end (a synchronize
   after each call), means of ``REPS`` warm calls;
2. one prefill and ``STEPS`` decode steps of each engine under
   ``torch.profiler`` (the second of two such passes): the CPU ops with
   the most self time, the host's self ms, the count of synchronising
   CUDA runtime calls, and the device's busy ms beside the wall ms;
3. the host ms of a mesh decode step's parts, each synchronised: the
   whole step, its ``ParamGather`` plan, the params' and the cache's
   local tensors, and the model's decode on them under the step's
   context (its per-superblock gathers along the data axes included).

``--collectives-only`` stops after (1); ``--env KEY=VALUE`` sets an
environment variable of this process before its process group starts
(e.g. the NCCL flight recorder's ``TORCH_FR_BUFFER_SIZE=0``).  The whole
result goes to ``chiprun_out/mesh_serve_probe[_<tag>].json``.

    python3 scripts/mesh_serve_probe.py [--collectives-only] [--env K=V]
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, PROMPT, NEW = "llama3.2-1b", 4, 1024, 32
REPS, STEPS, TOP = 50, 3, 30
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def host_us(torch, fn, *, sync: bool) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / REPS * 1e6


def collectives(torch, mesh) -> dict:
    import torch.distributed as dist

    from repro_torch.distributed import ctx, tp

    split = ctx.ModelSplit(mesh.get_group("model"), 0, 1)
    rows = ctx.RowSplit(mesh.get_group("data"), 0, 1, BATCH)
    bf = torch.bfloat16
    prefill = torch.randn(BATCH, PROMPT, 2048, device="cuda").to(bf)
    step = torch.randn(BATCH, 1, 2048, device="cuda").to(bf)
    logits = torch.randn(BATCH, 128256, device="cuda")
    f32 = prefill.float()
    calls = {
        "sum_partial.prefill": lambda: tp.sum_partial(prefill, split),
        "sum_partial.decode": lambda: tp.sum_partial(step, split),
        "gather.logits": lambda: tp.gather(logits, -1, split),
        "gather_rows.logits": lambda: tp.gather_rows(logits, rows),
        "all_reduce.prefill_f32": lambda: dist.all_reduce(
            f32, group=split.group),
        "all_reduce.decode_bf16": lambda: dist.all_reduce(
            step, group=split.group),
        "process_group.allreduce.decode_bf16":
            lambda: split.group.allreduce([step]).wait(),
        "float_to.prefill": lambda: prefill.float().to(bf),
        "add.decode": lambda: step.add(step),
    }
    return {name: {"enqueue_us": host_us(torch, fn, sync=False),
                   "synced_us": host_us(torch, fn, sync=True)}
            for name, fn in calls.items()}


def profiled(torch, eng, prompts) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import place_token

    with torch.inference_mode():
        logits, caches = eng.prefill(prompts)
        cache = eng._expand_cache(caches, BATCH, PROMPT)
        tok = logits.argmax(-1).to(torch.int32)
        for warm in (True, False):      # the first pass loads modules
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.prefill(prompts)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(STEPS):
                    logits, cache = eng._decode_step(
                        eng.model_params(), cache,
                        place_token(eng.mesh, tok), PROMPT + i)
                    tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
    events = prof.key_averages()
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:TOP]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in events
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA"))
    return {
        "prefill_wall_ms": (t1 - t0) * 1e3,
        "decode_wall_ms_per_step": (t2 - t1) * 1e3 / STEPS,
        "device_busy_ms": busy / 1e3,
        "host_self_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "sync_calls": {e.key: e.count for e in events
                       if e.key in SYNC_CALLS},
        "top_cpu": [{"op": e.key, "count": e.count,
                     "self_cpu_ms": e.self_cpu_time_total / 1e3}
                    for e in top],
    }


def decode_parts(torch, eng, mesh, prompts) -> dict:
    """Host ms of a mesh decode step's parts, each ending in a
    synchronize: the whole step, its ``ParamGather`` plan, the params'
    and the cache's local tensors, and the model's decode on them under
    the step's context (the per-superblock gathers included)."""
    from repro_torch.distributed import tp
    from repro_torch.launch import steps as ST

    with torch.inference_mode():
        logits, caches = eng.prefill(prompts)
        cache = eng._expand_cache(caches, BATCH, PROMPT)
        tok = logits.argmax(-1).to(torch.int32)
        placed = ST.place_token(mesh, tok)
        params = tp.to_local(eng.params)
        local = tp.to_local(cache)

        def model_only():
            with ST._serving_on(mesh, eng.cfg, eng.params, BATCH):
                ST.model_decode(params, eng.cfg, local, tok, PROMPT)

        parts = {
            "step": lambda: eng._decode_step(eng.model_params(), cache,
                                             placed, PROMPT),
            "param_gather_plan": lambda: ST.param_gather(
                mesh, eng.params, eng.cfg.param_dtype),
            "params_to_local": lambda: tp.to_local(eng.params),
            "cache_to_local": lambda: tp.to_local(cache),
            "model_decode": model_only,
        }
        return {name: host_us(torch, fn, sync=True) / 1e3
                for name, fn in parts.items()}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--collectives-only", action="store_true")
    ap.add_argument("--env", action="append", default=[])
    args = ap.parse_args()
    for kv in args.env:
        key, value = kv.split("=", 1)
        os.environ[key] = value
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_serve_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(ARCH)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    mesh = single_device_mesh()
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": smi.strip(), "env": args.env,
           "collectives": collectives(torch, mesh)}
    for name, m in () if args.collectives_only else (("none", None),
                                                      ("mesh", mesh)):
        eng = ServeEngine(cfg, mesh=m, max_len=PROMPT + NEW, seed=0)
        out[name] = profiled(torch, eng, prompts)
        if m is not None:
            out["mesh_decode_parts_ms"] = decode_parts(torch, eng, m,
                                                       prompts)
        del eng
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tag = "_".join(kv.split("=")[0] for kv in args.env)
    name = f"mesh_serve_probe{'_' + tag if tag else ''}.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
