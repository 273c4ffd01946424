"""Training steps: a fresh batch each step, keyed by (seed, step), through
the port's train step (``launch.steps.make_train_step``: microbatches,
the backward kernels, the chunked CE, then AdamW).

Set-up builds one step object with its weights and optimizer state and
drives it through the checked steps, whose readings the reference
follows: each step's loss, the first step's gradient as the optimizer
took it, and each leaf's change over those steps.  The same object then
runs the window: whole steps until ``seconds`` have passed.
``train_tokens_per_s`` is every position of the window's steps over the
time from the first one's start to the last one's end.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench.lib import compare, port, tokens, weights
from perfbench.lib.trace import Recorder
from perfbench.reference import adamw as RA
from perfbench.reference import lm as R

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: steps set-up drives and the reference follows: two, not three, so that
#: the reference takes less time than the window
CHECKED_STEPS = 2
#: window steps a traced run profiles
TRACE_STEPS = 1


def _batch(cell, seed: int, step: int, device) -> dict:
    t = cell.traffic
    b = tokens.lm_batch(seed, step, t["rows"], t["seq"],
                        cell.config["vocab_size"])
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in b.items()}


def _program(cell, seed, seconds, recorder, device, t0, log) -> dict:
    """The program's checked steps and window → readings and timings."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    t = cell.traffic
    opt = t["optimizer"]
    mc = port.model_config(cell.config)
    opt_cfg = adamw.AdamWConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
        warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
        min_lr_frac=opt["min_lr_frac"])
    log(f"set-up: imports done at {time.perf_counter() - t0:.3f} s")
    params = weights.draw(cell.config, seed, device)
    state = adamw.init(params, opt_cfg)
    step = steps.make_train_step(mc, opt_cfg, grad_accum=t["microbatches"])
    _sync(device)
    log(f"set-up: weights drawn at {time.perf_counter() - t0:.3f} s")
    start = params
    losses, grad = [], None
    for i in range(CHECKED_STEPS):
        params, state, m = step(params, state, _batch(cell, seed, i, device))
        losses.append(float(m["loss"]))
        log(f"set-up: checked step {i} done at "
            f"{time.perf_counter() - t0:.3f} s")
        if i == 0:
            grad = compare.leaf_norms(
                (p, g / (1 - opt["b1"]))
                for p, g in weights.leaves_with_path(state.mu))
    change = compare.leaf_norms(
        (p, a.float() - b.float()) for (p, a), (_, b) in zip(
            weights.leaves_with_path(params),
            weights.leaves_with_path(start)))
    del start
    _sync(device)
    ready = time.perf_counter()
    log(f"checked steps: losses {losses}")

    n, failed, i = 0, 0, CHECKED_STEPS
    w0 = time.perf_counter()
    while True:
        traced = n < TRACE_STEPS
        if traced:
            recorder.start()
        with recorder.unit("train", t["rows"], t["seq"],
                           t["rows"] // t["microbatches"]):
            params, state, m = step(params, state,
                                    _batch(cell, seed, i, device))
            loss = float(m["loss"])
            _sync(device)
        if traced and n + 1 == TRACE_STEPS:
            recorder.stop()
        failed += not loss == loss
        n, i = n + 1, i + 1
        if time.perf_counter() - w0 >= seconds:
            break
    w1 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    del params, state, step, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tokens_done = n * t["rows"] * t["seq"]
    return {"readings": {"losses": losses, "grad": grad, "change": change},
            "ready": ready, "attempted": n, "failed": failed,
            "metrics": {"train_tokens_per_s": tokens_done / (w1 - w0)},
            "window_s": w1 - w0, "memory_peak_bytes": peak}


def reference_steps(cell, seed: int, device, numerics=R.F32) -> dict:
    """The reference's readings of the checked steps, from the same
    weights and batches, in float32 (or ``numerics``)."""
    t, cfg = cell.traffic, cell.config
    tree = weights.draw(cfg, seed, device, as_float32=True)
    items = weights.leaves_with_path(tree)
    storage = {p: _DTYPES[d] for p, _, d, _ in weights.layout(cfg)}
    leaves = [x.requires_grad_(True) for _, x in items]
    start = [x.detach().to(storage[p], copy=True) for p, x in items]
    opt = RA.AdamW(t["optimizer"], leaves, [storage[p] for p, _ in items])
    mb = t["rows"] // t["microbatches"]
    losses, grad = [], None
    for i in range(CHECKED_STEPS):
        b = _batch(cell, seed, i, device)
        total = 0.0
        for r0 in range(0, t["rows"], mb):
            loss = R.loss(tree, cfg, b["tokens"][r0:r0 + mb],
                          b["labels"][r0:r0 + mb], numerics)
            (loss / t["microbatches"]).backward()
            total += loss.item() / t["microbatches"]
        clipped = opt.step(leaves, [x.grad for x in leaves])
        for x in leaves:
            x.grad = None
        losses.append(total)
        if i == 0:
            grad = compare.leaf_norms(
                (p, g) for (p, _), g in zip(items, clipped))
        del clipped
    change = compare.leaf_norms(
        (p, x.detach() - s.float()) for (p, x), s in zip(items, start))
    return {"losses": losses, "grad": grad, "change": change}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        log, system: str = "program") -> dict:
    """One run of the cell.  ``system``: ``program``, or ``control``: the
    reference in float8 put in the program's place for the checked steps
    (no window)."""
    device = torch.device(device)
    recorder = Recorder(trace, port.kernel_calls)
    if system == "program":
        out = _program(cell, seed, seconds, recorder, device, t0, log)
        out["setup_s"] = out.pop("ready") - t0
    else:
        R.no_tf32()
        got = reference_steps(cell, seed, device, R.Numerics("fp8"))
        out = {"readings": got, "attempted": CHECKED_STEPS,
               "failed": 0, "metrics": {}, "memory_peak_bytes": 0,
               "setup_s": 0.0}
    out["summary"] = recorder.summary()
    R.no_tf32()
    c0 = time.perf_counter()
    ref = reference_steps(cell, seed, device)
    out["reference_s"] = time.perf_counter() - c0
    out["numbers"] = compare.train_numbers(out.pop("readings"), ref)
    return out
