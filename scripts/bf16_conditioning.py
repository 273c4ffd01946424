"""How far bf16 moves the port's train gradients, on the CPU: per model
and depth, each gradient leaf's relative L2 distance from the f32
gradients of one microbatch — once with only the weights rounded to bf16
(all arithmetic in f32), once for the whole bf16 step — the worst leaf
and the median printed.  The first says how ill-conditioned the gradients
are at the reference's init; the second is what a bf16 card-against-CPU
check has to live with.  MoE layers take the bf16 run's expert choices in
every run, so routing does not move them.

    PYTHONPATH=src python scripts/bf16_conditioning.py
    PYTHONPATH=src python scripts/bf16_conditioning.py --arch mamba2-1.3b \\
        --layers 2,4,8

The default cuts are ``chip_smoke.py``'s card-against-CPU cuts (d_model
256, 2 × 256 tokens), at 8 layers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CUTS = {"llama3.2-1b": cs.TRAIN_CPU_CUT,
        "mamba2-1.3b": cs.SSM_TRAIN_CPU_CUT,
        cs.HYBRID_ARCH: cs.HYBRID_TRAIN_CPU_CUT}


def _grads(cfg, weights, routing, shape) -> dict:
    params = lm.lm_params_from_numpy(weights, cfg, device="cpu")
    batch = cs._train_batch(cfg, shape, 1, "cpu")
    mb = steps._split_microbatches(batch, cs.TRAIN_ACCUM)[0]
    with routing:
        _, g = steps._value_and_grad(cfg.with_(remat=False), params, mb)
    return {p: t.float() for p, t in cs._flat(g)}


def gaps(arch: str, layers: int, seq: int = cs.TRAIN_CPU_SEQ) -> dict:
    """{"weights": (worst, median), "bf16": (worst, median)} relative L2
    distances of ``arch`` cut to ``CUTS[arch]`` at ``layers`` layers."""
    cfg = get_config(arch).with_(**{**CUTS[arch], "num_layers": layers})
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=cs.TRAIN_CPU_ROWS)
    f32, b16 = cfg.with_(dtype="float32"), cfg.with_(dtype="bfloat16")
    tree = adamw.tree_map(lambda t: t.numpy(), steps.model_init(
        torch.Generator().manual_seed(1), f32))
    rounded = adamw.tree_map(lambda t: t.float().numpy(),
                             lm.lm_params_from_numpy(tree, b16,
                                                     device="cpu"))
    moe = cfg.moe is not None
    rec = cs._choices() if moe else contextlib.nullcontext()
    half = _grads(b16, tree, rec, shape)
    replay = (lambda: cs._ReplayingChoices(rec.calls)) if moe else \
        contextlib.nullcontext
    exact = _grads(f32, tree, replay(), shape)
    on_rounded = _grads(f32, rounded, replay(), shape)

    def summary(got):
        d = [float((got[p] - w).norm() / max(float(w.norm()), 1e-30))
             for p, w in exact.items()]
        return max(d), statistics.median(d)

    return {"weights": summary(on_rounded), "bf16": summary(half)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=sorted(CUTS),
                    help="repeatable; default: all three")
    ap.add_argument("--layers", default="8",
                    help="comma-separated depths (the hybrid takes 8)")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for arch in args.arch or list(CUTS):
        for n in (int(v) for v in args.layers.split(",")):
            g = gaps(arch, n)
            print(f"{arch} layers {n}: weights only worst "
                  f"{g['weights'][0]:.4f} median {g['weights'][1]:.4f}; "
                  f"bf16 worst {g['bf16'][0]:.4f} median {g['bf16'][1]:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
