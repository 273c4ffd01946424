"""Where the time of a mesh train step goes, on the card.

Trains ``ARCHS`` (full width and depth, seeded bf16 params, a 4 × 1024
batch) with the split train step on the 1 × 1 NCCL mesh
(``single_device_mesh()``) and with ``make_train_step`` (``mesh=None``)
in one process, and for each prints, in one JSON line:

1. one warm step of each path under ``torch.profiler`` (the second of
   two such passes): wall ms, the device's busy ms, the host's self ms,
   the CPU ops with the most self time, and the collectives the step
   called, by kind;
2. the host µs of the split step's pieces at one leaf — a data-axes
   gather (``tp.gather_data``) and its reduce-scatter, a bare
   ``dist.all_gather`` of the same leaf, a copy of it — each the mean
   of ``REPS`` warm calls, synchronised after each.

The whole result goes to ``chiprun_out/mesh_train_probe.json``.

    python3 scripts/mesh_train_probe.py [--arch NAME ...]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m")
ROWS, SEQ, REPS, TOP = 4, 1024, 50, 25
#: the profiler's names of c10d's collectives, counted a step
COLLECTIVES = ("c10d::allgather_", "c10d::allreduce_",
               "c10d::reduce_scatter_", "c10d::_allgather_base_",
               "c10d::_reduce_scatter_base_")


def host_us(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / REPS * 1e6


def profiled(torch, step, state, batch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):                 # the first pass loads modules
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(*state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:TOP]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in events
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA"))
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy / 1e3,
        "host_self_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "collectives": {e.key: e.count for e in events
                        if e.key in COLLECTIVES},
        "top_cpu": [{"op": e.key, "count": e.count,
                     "self_cpu_ms": e.self_cpu_time_total / 1e3}
                    for e in top],
    }


def pieces(torch, mesh, params) -> dict:
    """Host µs of the step's pieces at its largest block leaf."""
    import torch.distributed as dist

    from repro_torch.distributed import ctx, tp
    from repro_torch.launch import steps as ST
    from repro_torch.distributed.sharding import _leaves_with_path

    plan = ST.param_gather(mesh, params)
    keys = max((k for k in plan.dims if k[0] == "blocks"),
               key=lambda k: dict(_leaves_with_path(params))[k].numel())
    leaf = dict(_leaves_with_path(params))[keys].to_local()[0]
    dim = plan.dims[keys] - 1
    path = keys[:1]

    def gather():
        with ctx.gathering_params(plan):
            return tp.gather_data(_nest(keys[1:], leaf), path, layer=True)

    def gather_and_back():
        x = leaf.detach().requires_grad_(True)
        with ctx.gathering_params(plan):
            g = tp.gather_data(_nest(keys[1:], x), path, layer=True)
        _leaf_of(g).sum().backward()

    group = plan.group

    def bare():
        parts = [torch.empty_like(leaf) for _ in range(plan.count)]
        dist.all_gather(parts, leaf.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    return {"leaf": "/".join(keys), "shape": list(leaf.shape),
            "dtype": str(leaf.dtype).replace("torch.", ""),
            "gather_data_us": host_us(torch, gather),
            "gather_and_reduce_scatter_us": host_us(torch, gather_and_back),
            "bare_all_gather_us": host_us(torch, bare),
            "copy_us": host_us(torch, lambda: leaf.clone())}


def _nest(keys, leaf):
    out = leaf
    for k in reversed(keys):
        out = {k: out}
    return out


def _leaf_of(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_train_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    mesh = single_device_mesh()
    out = {"card": smi.strip(), "rows": ROWS, "seq": SEQ}
    for arch in args.arch or ARCHS:
        cfg = get_config(arch)
        opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
        params = ST.model_init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (ROWS, SEQ),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        p_shard = shd.make_param_shardings(mesh, params, cfg)
        opt = adamw.init(params, opt_cfg)
        meshed = (shd.distribute_tree(tree_map(torch.clone, params), p_shard),
                  shd.distribute_tree(adamw.init(params, opt_cfg),
                                      shd.make_opt_shardings(mesh, opt,
                                                             p_shard)))
        row = {"none": profiled(torch, ST.make_train_step(cfg, opt_cfg),
                                (params, opt), batch)}
        del params, opt
        torch.cuda.empty_cache()
        row["mesh"] = profiled(torch, ST.make_sharded_train_step(
            cfg, opt_cfg, mesh, global_batch=ROWS), meshed, batch)
        row["pieces"] = pieces(torch, mesh, meshed[0])
        out[arch] = row
        del meshed
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mesh_train_probe.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
