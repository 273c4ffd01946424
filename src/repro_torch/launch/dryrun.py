"""Multi-pod dry-run on the ``meta`` device: what one rank of a production
mesh computes, moves and holds, modeled for an H100 SXM (data sheet).

The port's counterpart of the reference's ``launch/dryrun.py``.  For
every (architecture × input shape × mesh) cell this module

  1. starts a fake process group of the mesh's size (``fake_world``: the
     counterpart of the reference's forced host device count), this
     process its rank 0;
  2. builds the step the port runs on a mesh —
     ``steps.make_sharded_train_step`` (AdamW, int8 second moments above
     30 B params), ``steps.make_prefill_step`` or
     ``steps.make_decode_step`` — with params, optimizer state and caches
     as ``meta`` trees placed by ``distributed/sharding.py``'s rules;
  3. runs it once on the rank's shards under a ``StepCounter``
     (``launch/graph_analysis.py``): the per-device FLOPs by dtype,
     bytes, collectives by kind and by mesh axis, the hand-written
     kernels' launches and work, and the peak of live memory;
  4. bounds them by the H100's roofline (``launch/roofline.py``): each
     product at its dtype's peak, bytes at HBM's rate, each mesh axis's
     collective bytes over its link (NVLink within a node of 8, the
     network across nodes);
  5. writes one JSON artifact per cell under ``--out``.

Every number is a count of shapes on meta tensors or a division of one
by a data-sheet rate: none is a measurement.  Meshes: ``single`` =
(data=16, model=16), 256 ranks; ``multi`` = (pod=2, data=16, model=16),
512 ranks (``REPRO_MESH_SHAPE`` / ``REPRO_MESH_SHAPE_MULTI`` override
them, as in ``launch/mesh.py``).  The per-device figures are rank 0's.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single --out runs/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (
    ModelConfig,
    SHAPES,
    ShapeConfig,
    count_params,
    shape_applicable,
)
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.launch.graph_analysis import (
    count_step,
    use_compiled_meta_kernels,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw

#: the peak a step's model FLOPs are shared against (``roofline_mfu``)
PEAK_FLOPS = roofline.TENSOR_CORE_BF16_OPS_PER_S


# ---------------------------------------------------------------------------
# per-cell runtime knobs (the reference's, unchanged)
# ---------------------------------------------------------------------------


def pick_grad_accum(cfg: ModelConfig, shape: ShapeConfig, dp: int,
                    budget: int = 4 << 30) -> int:
    """Microbatch count bounding per-device train memory.

    Two terms scale with the microbatch: the remat-saved layer-boundary
    activations (L × rows/ga × S × D × bf16) and the transient FFN/MoE
    working set (rows/ga × S × ff_eff × bf16 × ~6 fusion copies).  ga is
    the smallest power-of-2 divisor of the per-device rows keeping their
    sum under ``budget``."""
    rows = max(shape.global_batch // max(dp, 1), 1)
    ff_eff = max(
        cfg.d_ff,
        2 * cfg.d_model,
        (cfg.moe.top_k * cfg.d_ff) if cfg.moe else 0,
        cfg.ssm.d_inner(cfg.d_model) * 2 if cfg.ssm else 0,
    )
    ga = 1
    while ga < rows:
        mrows = rows / ga
        saved = cfg.num_layers * mrows * shape.seq_len * cfg.d_model * 2
        work = mrows * shape.seq_len * ff_eff * 2 * 6
        if cfg.moe:
            # capacity-padded expert buffers (≈4 live copies through the
            # expert FFN + backward)
            work += (mrows * shape.seq_len * cfg.moe.top_k
                     * cfg.moe.capacity_factor * cfg.d_model * 2 * 4)
        if saved + work <= budget:
            break
        ga *= 2
    return ga


def runtime_config(cfg: ModelConfig, shape: ShapeConfig,
                   baseline: bool = False) -> ModelConfig:
    """Shape-dependent knobs for the production step.

    ``baseline=True`` strips the beyond-paper optimizations (per-arch TP,
    vocab padding), as the reference's does.
    """
    kw: dict = {}
    # blockwise attention tiles: clamp to the sequence
    kw["attn_block_q"] = min(cfg.attn_block_q, shape.seq_len)
    kw["attn_block_k"] = min(cfg.attn_block_k, shape.seq_len)
    if shape.kind != "train":
        kw["remat"] = False
    if baseline:
        kw["pad_vocab_to"] = 0
        kw["tp_preference"] = 0
    elif shape.kind == "prefill" and shape.seq_len >= 32_768:
        # the reference's wider k-tile for long prefills (its blockwise
        # attention's carries round-trip once per (qi, ki) step)
        kw["attn_block_k"] = min(2048, shape.seq_len)
    return cfg.with_(**kw)


def pick_tp(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> int:
    """Shape-aware TP: start from the arch preference and widen until the
    DP group divides the global batch (a dp group larger than the batch
    replicates/pads every activation)."""
    tp = cfg.tp_preference or 16
    while tp < 16 and shape.global_batch % max(chips // tp, 1) != 0:
        tp *= 2
    return tp


# ---------------------------------------------------------------------------
# the fake world and the mesh
# ---------------------------------------------------------------------------


def fake_world(size: int, rank: int = 0) -> None:
    """This process as rank ``rank`` of a fake process group of ``size``
    ranks (``torch.testing``'s ``FakeStore``, backend ``"fake"``: every
    collective returns at once and moves nothing).  A world already
    there is taken down first.  Process-global, as is its switch to
    the compiled Meta kernels (``use_compiled_meta_kernels``): a caller
    that wants another world runs in its own process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    use_compiled_meta_kernels()
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)


def production_mesh(multi: bool, tp: int = 0, rank: int = 0):
    """``make_production_mesh``'s mesh over a fake world of its size."""
    if dist.is_initialized():
        dist.destroy_process_group()
    shape = make_production_mesh(multi_pod=multi, tp=tp).shape
    fake_world(math.prod(shape.values()), rank)
    return make_production_mesh(multi_pod=multi, tp=tp)


def axis_groups(mesh) -> dict:
    """Process group name → the mesh axis (or plane of axes) it spans."""
    out = {}
    for key in mesh._groups:
        out[mesh.get_group(key).group_name] = "×".join(key)
    return out


# ---------------------------------------------------------------------------
# tracing one cell
# ---------------------------------------------------------------------------


def _drawn(spec: torch.Tensor, device, gen: torch.Generator, vocab: int):
    """A tensor of ``spec``'s shape and dtype on ``device``: token ids in
    [0, ``vocab``) for an integer spec, N(0, 1) for a float one."""
    if spec.dtype.is_floating_point:
        return torch.randn(spec.shape, generator=gen, device=device).to(
            spec.dtype)
    return torch.randint(0, vocab, spec.shape, generator=gen, device=device,
                         dtype=spec.dtype)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               grad_accum: int = 1, opt_cfg: adamw.AdamWConfig | None = None,
               device="meta"):
    """(step, args): the step the port runs for ``shape`` on ``mesh`` and
    its arguments as this rank holds them — params (and the optimizer
    state, the decode caches) placed by the sharding rules, the batch
    (the rank's rows for the train step, the global batch a prefill
    takes), a decode step's token placed by ``make_batch_shardings`` and
    its position at the cache's last one.  On
    ``meta`` they are shapes only; on a device, params drawn from
    seed 0 as ``steps.model_init`` draws them, a batch of random tokens
    and zeroed caches: the step a card runs, to set beside its count."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(0)

    def fill(tree):
        if meta:
            return tree
        return {k: _drawn(v, device, gen, cfg.vocab_size)
                for k, v in tree.items()}

    params = S.params_specs(cfg) if meta else ST.model_init(gen, cfg)
    p_shard = shd.make_param_shardings(mesh, params, cfg)
    placed = shd.distribute_tree(params, p_shard)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        opt = adamw.init(params, opt_cfg)
        del params
        opt = shd.distribute_tree(
            opt, shd.make_opt_shardings(mesh, opt, p_shard))
        step = ST.make_sharded_train_step(cfg, opt_cfg, mesh,
                                          global_batch=shape.global_batch,
                                          grad_accum=grad_accum)
        batch = ST.local_batch(mesh, fill(S.train_input_specs(cfg, shape)),
                               grad_accum)
        return step, (placed, opt, batch)
    del params
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, mesh)
        return step, (placed, fill(S.prefill_input_specs(cfg, shape)))
    # decode: one token at the cache's last position
    step = ST.make_decode_step(cfg, mesh)
    d = S.decode_input_specs(cfg, shape)
    cache = d["cache"] if meta else ST.model_init_cache(
        cfg, shape.global_batch, shape.seq_len, device=device)
    cache = shd.distribute_tree(cache,
                                shd.make_cache_shardings(mesh, cache, cfg))
    token = ST.place_token(mesh, fill({"token": d["token"]})["token"])
    return step, (placed, cache, token, shape.seq_len - 1)


def trace_cell(arch: str, shape_name: str, mesh, *, baseline: bool = False):
    """Returns (stats, meta) for one (arch, shape, mesh): the step run
    once on this rank's meta shards under a ``StepCounter``; (None,
    {"skipped": True, "reason": ...}) for a cell ``shape_applicable``
    rules out."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": True, "reason": reason}
    cfg = runtime_config(cfg, shape, baseline=baseline)

    ga, opt_cfg = 1, None
    meta = {"entry": f"{shape.kind}_step"}
    if shape.kind == "train":
        ga = pick_grad_accum(cfg, shape,
                             shd.axis_size(mesh, shd.dp_axes(mesh)))
        # ≥30B params: int8 second moments (halves resident optimizer
        # bytes; jamba-398B needs it to fit beside bf16 params)
        opt_cfg = adamw.AdamWConfig(
            quantize_moments=not baseline and count_params(cfg) > 30e9)
        meta["grad_accum"] = ga
    step, args = build_step(cfg, shape, mesh, grad_accum=ga, opt_cfg=opt_cfg)
    _, stats = count_step(step, *args)
    return stats, meta


# ---------------------------------------------------------------------------
# roofline terms from the counts
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> tuple[float, int]:
    """(model FLOPs, tokens) of one step: 6·N·D train / 2·N·D inference
    per token, N the (MoE-active) params — the reference's formula.
    Enc-dec: the encoder stack sees seq_len frames but the decoder only
    seq_len/4 targets — each stack weighted by its own token count."""
    n_active = count_params(cfg, active_only=cfg.moe is not None)
    mult = 6.0 if shape.kind == "train" else 2.0
    if cfg.family == "encdec":
        frac = cfg.enc_layers / (cfg.enc_layers + cfg.dec_layers)
        if shape.kind == "train":
            dec_tokens = shape.global_batch * max(
                shape.seq_len // S.ENCDEC_DEC_FRAC, 16
            )
            enc_tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            enc_tokens = shape.global_batch * shape.seq_len
            dec_tokens = shape.global_batch
        else:
            enc_tokens = 0
            dec_tokens = shape.global_batch
        flops = mult * n_active * (
            frac * enc_tokens + (1 - frac) * dec_tokens
        )
        return flops, enc_tokens + dec_tokens
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch  # one token per sequence
    return mult * n_active * tokens, tokens


def cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Bytes of the whole decode cache (0 for train and prefill)."""
    if shape.kind != "decode":
        return 0
    cache = ST.model_init_cache(cfg, shape.global_batch, shape.seq_len,
                                device="meta")
    return sum(t.numel() * t.element_size() for _, t in
               shd._leaves_with_path(cache))


def _shape_key(dtype: str, dims) -> str:
    return f"{dtype}[{','.join(map(str, dims))}]"


def roofline_report(arch: str, shape_name: str, stats, meta: dict,
                    chips: int, groups: dict | None = None) -> dict:
    """The reference's report keys (less ``xla_cost_analysis``) from one
    step's counts, and the peak of live memory beside the card's 80 GB.
    ``groups`` names the mesh axis of each process group."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    groups = groups or {}
    flops = stats.flops
    hbm_bytes = stats.memory_bytes
    coll_bytes = stats.total_collective_bytes
    terms = {
        "compute_s": stats.compute_s(),
        "memory_s": stats.memory_s(),
        "collective_s": stats.collective_s(),
    }
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    n_active = count_params(cfg, active_only=cfg.moe is not None)
    model_total, _ = model_flops(cfg, shape)
    model_per_chip = model_total / chips
    mfu = model_per_chip / PEAK_FLOPS / bound_s if bound_s > 0 else 0.0
    by_axis: dict = {}
    for g, b in stats.collective_by_group.items():
        row = by_axis.setdefault(groups.get(g, f"group {g}"), {
            "bytes": 0.0,
            "link_bytes_per_s": roofline.link_rate(stats.group_ranks[g])})
        row["bytes"] += b
    return {
        "arch": arch,
        "shape": shape_name,
        "chips": chips,
        "entry": meta.get("entry"),
        "grad_accum": meta.get("grad_accum"),
        "params_total": count_params(cfg),
        "params_active": n_active,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": hbm_bytes,
        "collective_bytes_per_device": coll_bytes,
        "collective_by_kind": dict(stats.collective_bytes),
        "collective_counts": dict(stats.collective_counts),
        "collective_by_axis": by_axis,
        "traffic_by_shape": {
            _shape_key(dt, dims): b
            for (dt, dims), b in sorted(
                stats.traffic_by_shape.items(), key=lambda kv: -kv[1]
            )[:24]
        },
        "collective_by_shape": {
            f"{kind} {_shape_key(dt, dims)}": b
            for (kind, dt, dims), b in sorted(
                stats.collective_by_shape.items(), key=lambda kv: -kv[1]
            )[:16]
        },
        "product_flops_by_dtype": dict(stats.product_flops_by_dtype),
        "kernel_calls": {k: dict(v) for k, v in stats.kernel_calls.items()},
        **terms,
        "dominant": dominant,
        "bound_s": bound_s,
        "model_flops_total": model_total,
        "model_flops_per_chip": model_per_chip,
        "cache_bytes": cache_bytes(cfg, shape),
        "useful_flops_ratio": (model_per_chip / flops) if flops else 0.0,
        "roofline_mfu": mfu,
        "memory_analysis": {
            "argument_size_in_bytes": stats.argument_bytes,
            "output_size_in_bytes": stats.output_bytes,
            "temp_size_in_bytes": stats.peak_bytes - stats.argument_bytes,
        },
        "peak_bytes_per_device": stats.peak_bytes,
        "device_memory_bytes": roofline.DEVICE_MEMORY_BYTES,
        "modeled": roofline.MODELED,
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, baseline: bool = False, rank: int = 0) -> dict:
    multi = mesh_kind == "multi"
    if baseline or os.environ.get("REPRO_MESH_SHAPE"):
        tp = 0  # baseline mesh / explicit test meshes
    else:
        chips = 512 if multi else 256
        tp = pick_tp(get_config(arch), SHAPES[shape_name], chips)
        tp = 0 if tp == 16 else tp
    mesh = production_mesh(multi, tp, rank)
    chips = math.prod(mesh.shape.values())
    t0 = time.time()
    try:
        stats, meta = trace_cell(arch, shape_name, mesh, baseline=baseline)
    except Exception as e:
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_kind,
            "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
        _write(out_dir, arch, shape_name, mesh_kind, rec)
        return rec
    if stats is None:  # recorded skip
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_kind,
            "ok": True,
            **meta,
        }
        _write(out_dir, arch, shape_name, mesh_kind, rec)
        return rec
    rec = roofline_report(arch, shape_name, stats, meta, chips,
                          axis_groups(mesh))
    rec.update(
        {
            "mesh": mesh_kind,
            "mesh_shape": list(mesh.shape.values()),
            "rank": rank,
            "ok": True,
            "skipped": False,
            "compile_s": time.time() - t0,
        }
    )
    _write(out_dir, arch, shape_name, mesh_kind, rec)
    return rec


def _write(out_dir: str, arch: str, shape: str, mesh_kind: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    safe = arch.replace(".", "_").replace("/", "_")
    path = os.path.join(out_dir, f"{safe}__{shape}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--baseline", action="store_true",
                    help="strip beyond-paper optimizations (per-arch TP, "
                         "vocab padding), as the reference's flag does")
    args = ap.parse_args(argv)

    archs = all_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    torch.set_num_threads(1)
    print(f"[dryrun] per device, rank 0 of each mesh; {roofline.MODELED}",
          flush=True)
    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               baseline=args.baseline)
                if rec.get("skipped"):
                    status = f"SKIP ({rec['reason'][:48]}...)"
                elif rec["ok"]:
                    status = (
                        f"ok {rec['compile_s']:6.1f}s dom={rec['dominant']}"
                        f" mfu={rec['roofline_mfu']:.3f}"
                    )
                else:
                    status = f"FAIL {rec['error'][:90]}"
                    n_fail += 1
                print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_kind:6s} "
                      f"{status}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
