#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON object on a line of its own:

1. ``device``     card name and power limit as ``nvidia-smi`` gives them,
                  torch / CUDA / nvcc versions;
2. ``build``      ``nvcc`` builds ``libconv2d_stream.so``,
                  ``libflash_attention.so``, ``libfused_mlp.so`` and
                  ``libmamba2_ssd.so`` from the sources in the checkout,
                  all at once (seconds taken);
3. ``kernel_check``  the hand-written streaming-conv kernel against its plain
                  PyTorch version on the card: integer dtypes bit-exact
                  (int32 wrap-around included), f32 within atol 1e-4 /
                  rtol 1e-2 and bf16 within atol 1e-2 / rtol 1e-2 (the sums
                  are taken in another order), over dtype × kernel size,
                  odd shapes, stride 1-3 × SAME/VALID/explicit pads × both
                  epilogues × batch {1, 5, 32} × rows_per_block {1, 2,
                  planner's}, strided weight slices and the Dense-as-1×1
                  form; then timed by CUDA events at the main path's shapes
                  beside the plain version, the roofline bound and, for
                  float shapes, ``F.conv2d`` (cuDNN, TF32 off) as yardstick;
4. ``main_path``  compile the model zoo and the partitioned / weight-streamed
                  showcases for KV260, run each on the card, compare with
                  the port's own ``device="cpu"`` run (bit-exact: the data is
                  int32), and batched (``vmap``) against the per-sample loop, for int32
                  and for f32 data (bit-exact both);
5. ``serve``      ``ServeEngine`` answers 256 requests per zoo model (16 for
                  ``deep_cascade_224``) from the open-loop load generator;
                  every answer must equal the direct run;
6. ``attn_check`` the hand-written flash-attention kernel against its plain
                  PyTorch version on the card, f32 within atol = rtol =
                  2e-5 and bf16 within 3e-2 (the reference's tolerances),
                  over the llama3.2-1b / qwen2-0.5b prefill shapes (B 4,
                  S 1024), D 128 (yi-9b), causal and not, a query offset,
                  ragged lengths (100, 1000) and B 1 S 1; then timed at the
                  model shapes beside the plain version, the roofline bound
                  and ``F.scaled_dot_product_attention`` as yardstick;
7. ``mlp_check``  the hand-written fused-MLP kernel against its plain
                  PyTorch version on the card, f32 within atol = rtol = 5e-4
                  and bf16 within 1e-2, gated and ungated, the four
                  activations, M 1-4096, D 896-8192 (its limit; one past it
                  must raise); then timed at llama3.2-1b's prefill and
                  decode shapes beside the plain version, the roofline bound
                  and the dense MLP (three cuBLAS matmuls) as yardstick;
8. ``ssd_check``  the hand-written SSD kernel against its plain version on
                  the card, f32 within 1e-3 and bf16 within 1e-2 (final
                  state 1e-3), chunks 1-128, L 37-1024, B 1-4, the state
                  carried across two calls; then timed at mamba2-1.3b's
                  prefill shape (no library call computes an SSD scan);
9. ``lm_serve``   the LM server at full width: llama3.2-1b and qwen2-0.5b
                  (random bf16 weights from a seed, on the card) generate
                  32 tokens greedily for 4 prompts of 1024; prefill logits
                  are held against the same engine with
                  ``attn_impl="blockwise"``; five prefills under the
                  profiler split the card's time between attention,
                  matmuls and the rest, beside their own wall time;
                  llama3.2-1b also runs one prefill and 8 decode steps
                  with ``mlp_impl="streamed"`` (the fused-MLP kernel, one
                  launch per layer and call), logits held against the
                  dense engine;
10. ``ssm_serve`` mamba2-1.3b at full width and depth (random bf16 weights
                  from a seed) generates 32 tokens greedily for 4 prompts of
                  1024 (one SSD launch per layer of a prefill); one decode
                  step after a 1023-token prefill is held against a
                  1024-token prefill (the kernel's final state against the
                  recurrence), and at depth 2 the card's prefill logits
                  against the port's own CPU run on the same weights.

The conv kernel's launch counters are zeroed just before phase 4 and read
just after phase 5, the attention and fused-MLP kernels' just before and
after phase 9, the SSD kernel's just before and after phase 10; the run
fails if a kernel was never launched on its path, or if a plain version
ever ran on a CUDA tensor there.  Then the ``nvidia-smi`` line, the
``{"kernels": [...]}`` summary and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero; with no CUDA device the script
exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernel_check", "main_path", "serve",
          "attn_check", "mlp_check", "ssd_check", "lm_serve", "ssm_serve")

# data-sheet peaks of one H100 SXM used for the roofline bound
HBM_BYTES_PER_S = 3.35e12
#: CUDA-core rate: 67 TFLOP/s float32 outside the tensor cores.  The same
#: figure is used for int32 multiply-adds (no published integer peak; the
#: integer pipe is not faster, so the bound stays a lower bound on time).
CUDA_CORE_OPS_PER_S = 67e12
#: dense bf16 tensor-core rate — the least time bf16 attention could take
TENSOR_CORE_BF16_OPS_PER_S = 989e12

#: (name, batch, H, W, Cin, Cout, K, stride) — the main path's conv shapes
MAIN_SHAPES = (
    ("lenet5.conv0", 32, 32, 32, 1, 6, 5, 1),
    ("tiny_vgg_32.conv1", 32, 32, 32, 16, 16, 3, 1),
    ("resnet_mini_16.conv1", 32, 16, 16, 8, 16, 3, 2),
    ("deep_cascade_224.conv1", 1, 224, 224, 136, 136, 3, 1),
    ("fat_conv_16.conv0", 1, 16, 16, 288, 288, 3, 1),
)
HEADLINE_SHAPE = "deep_cascade_224.conv1"


WATCHDOG_S = 1000


def _timed_out(signum, frame):
    print(f"chip_smoke: no result after {WATCHDOG_S} s — giving up",
          file=sys.stderr, flush=True)
    os._exit(3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, *, reps: int, kernel):
    """Mean milliseconds the card spends inside ``kernel`` (a name, or a
    tuple of names whose times add up) per call, from
    ``torch.profiler``'s device trace — ``ms`` from :func:`time_ms` also
    holds the host's time to enqueue a call, which is what shows at small
    shapes.  ``None`` where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError:      # no device tracing on this machine
        return None
    names = (kernel,) if isinstance(kernel, str) else kernel
    total_us = 0.0
    for ev in events:
        if any(k in ev.key for k in names):
            total_us += (getattr(ev, "self_device_time_total", 0.0)
                         or getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / reps / 1e3 if total_us else None


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _rand(gen, shape, dtype, torch, *, big: bool = False):
    if dtype in (torch.float32, torch.bfloat16):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(dtype).cuda()
    if big:  # products overflow int32 and must wrap
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()
    lo, hi = {torch.int8: (-128, 128), torch.uint8: (0, 256),
              torch.int16: (-3000, 3000), torch.int32: (-4, 5)}[dtype]
    return torch.randint(lo, hi, shape, generator=gen,
                         dtype=torch.int64).to(dtype).cuda()


def _compare(out, exp, dtype, torch, what: str) -> float:
    if out.shape != exp.shape or out.dtype != exp.dtype:
        raise AssertionError(
            f"{what}: kernel gave {tuple(out.shape)} {out.dtype}, plain "
            f"version {tuple(exp.shape)} {exp.dtype}")
    if dtype in (torch.float32, torch.bfloat16):
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        err = (out - exp).abs()
        if not bool((err <= atol + 1e-2 * exp.abs()).all()):
            raise AssertionError(
                f"{what}: max |err| {float(err.max())} beyond atol {atol} "
                "rtol 1e-2")
        return float(err.max())
    if not torch.equal(out, exp):
        bad = int((out != exp).sum())
        raise AssertionError(f"{what}: {bad} integer outputs differ")
    return 0.0


def kernel_check(torch) -> dict:
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    n = 0
    worst = {"f32": 0.0, "bf16": 0.0}

    def check(x, w, *, stride=1, padding="SAME", epilogue=None, rows=None,
              what=""):
        nonlocal n
        _, h, ww, _ = x.shape
        kh, kw, _, _ = w.shape
        pads = ops._conv_pads(h, ww, kh, kw, stride, padding)
        out = ops.conv2d_stream(x, w, stride=stride, padding=padding,
                                epilogue=epilogue, rows_per_block=rows)
        exp = cs.conv2d_stream_plain(x, w, stride, pads, epilogue)
        torch.cuda.synchronize()
        err = _compare(out, exp, x.dtype, torch,
                       f"{what} x{tuple(x.shape)} w{tuple(w.shape)} "
                       f"{x.dtype} s{stride} {padding} {epilogue} rows={rows}")
        if x.dtype == torch.float32:
            worst["f32"] = max(worst["f32"], err)
        elif x.dtype == torch.bfloat16:
            worst["bf16"] = max(worst["bf16"], err)
        n += 1

    all_dtypes = (torch.int8, torch.uint8, torch.int16, torch.int32,
                  torch.float32, torch.bfloat16)
    for dtype in all_dtypes:                      # dtype x kernel size
        for k in (1, 3, 5):
            check(_rand(gen, (2, 12, 12, 4), dtype, torch),
                  _rand(gen, (k, k, 4, 8), dtype, torch), what="dtype-k")
    for h, w_ in ((8, 8), (16, 8), (9, 13), (32, 32)):   # odd shapes
        check(_rand(gen, (1, h, w_, 3), torch.int8, torch),
              _rand(gen, (3, 3, 3, 16), torch.int8, torch), what="shape")
    # int8 -> int32 accumulation beyond int16, and int32 wrap-around
    check(torch.full((1, 8, 8, 64), 127, dtype=torch.int8).cuda(),
          torch.full((3, 3, 64, 4), 127, dtype=torch.int8).cuda(),
          what="int8-acc")
    for epi in (None, "relu", "squared_relu"):
        check(_rand(gen, (2, 9, 11, 5), torch.int32, torch, big=True),
              _rand(gen, (3, 3, 5, 7), torch.int32, torch, big=True),
              epilogue=epi, what="int32-wrap")
    # stride x padding x kernel x epilogue x batch x rows_per_block
    paddings = ("SAME", "VALID", ((1, 2), (0, 3)))
    for dtype in (torch.int32, torch.float32):
        for batch in (1, 5, 32):
            for k in (1, 3, 5):
                x = _rand(gen, (batch, 13, 12, 3), dtype, torch)
                w = _rand(gen, (k, k, 3, 6), dtype, torch)
                for stride in (1, 2, 3):
                    for padding in paddings:
                        for epi in (None, "relu", "squared_relu"):
                            for rows in (1, 2, None):
                                check(x, w, stride=stride, padding=padding,
                                      epilogue=epi, rows=rows, what="sweep")
    # a Cout slice of a streamed weight is a strided view
    wfull = _rand(gen, (3, 3, 8, 24), torch.int32, torch)
    xs = _rand(gen, (1, 16, 16, 8), torch.int32, torch)
    for t in range(3):
        check(xs, wfull.narrow(3, t * 8, 8), epilogue="relu", what="w-slice")
    # Dense layers run as 1x1 convs over a (1, 1, M, K) frame
    for m, kdim, nout in ((32, 4096, 10), (512, 128, 256), (1, 1024, 120)):
        for dtype in (torch.int32, torch.float32):
            a = _rand(gen, (3, m, kdim), dtype, torch)
            wd = _rand(gen, (kdim, nout), dtype, torch)
            got = ops.mac_reduce("ac,cb->ab", [a, wd], [True, False])
            if dtype == torch.float32:
                exp = a @ wd
            else:
                exp = cs._int_product(a, wd)
            torch.cuda.synchronize()
            worst["f32"] = max(worst["f32"], _compare(
                got, exp, dtype, torch, f"dense {m}x{kdim}x{nout} {dtype}"))
            n += 1

    # timing at the main path's shapes
    torch.backends.cudnn.allow_tf32 = False       # the yardstick stays f32
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F

    shapes = []
    for name, b, h, w_, cin, cout, k, stride in MAIN_SHAPES:
        for dtype in (torch.int32, torch.float32):
            x = _rand(gen, (b, h, w_, cin), dtype, torch)
            w = _rand(gen, (k, k, cin, cout), dtype, torch)
            pads = ops._conv_pads(h, w_, k, k, stride, "SAME")
            big = cin >= 128
            run = lambda: ops.conv2d_stream(x, w, stride=stride,
                                            epilogue="relu")
            plain = lambda: cs.conv2d_stream_plain(x, w, stride, pads, "relu")
            out, exp = run(), plain()
            torch.cuda.synchronize()
            err = _compare(out, exp, dtype, torch, f"{name} {dtype}")
            n += 1
            if dtype == torch.float32:
                worst["f32"] = max(worst["f32"], err)
            ms = time_ms(run, warmup=3, reps=10 if big else 100)
            plain_ms = time_ms(plain, warmup=1, reps=2 if big else 20)
            dev_ms = device_ms(run, reps=5 if big else 20,
                               kernel="conv2d_stream_kernel")
            n_bytes = (x.numel() * x.element_size()
                       + w.numel() * w.element_size()
                       + out.numel() * out.element_size())
            macs = out.numel() * k * k * cin
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * macs / CUDA_CORE_OPS_PER_S * 1e3
            library_ms = None
            if dtype == torch.float32:
                xn = x.permute(0, 3, 1, 2)        # NHWC storage, NCHW view
                wn = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                (pt, pb), (pl, pr) = pads

                def lib():
                    xin = xn
                    if pt != pb or pl != pr:
                        xin = F.pad(xn, (pl, pr, pt, pb))
                        pad = 0
                    else:
                        pad = (pt, pl)
                    return F.relu(F.conv2d(xin, wn, stride=stride,
                                           padding=pad))

                ref_out = lib().permute(0, 2, 3, 1)
                torch.cuda.synchronize()
                _compare(out, ref_out, dtype, torch, f"{name} vs F.conv2d")
                library_ms = time_ms(lib, warmup=3, reps=10 if big else 100)
            shapes.append({
                "shape": name, "dtype": str(dtype).replace("torch.", ""),
                "x": [b, h, w_, cin], "w": [k, k, cin, cout],
                "stride": stride, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "macs": macs, "library_ms": library_ms,
                "max_abs_err": err,
            })
    return {"comparisons": n, "max_abs_err_f32": worst["f32"],
            "max_abs_err_bf16": worst["bf16"], "max_abs_err_int": 0,
            "shapes": shapes}


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

ZOO_MODELS = ("lenet5", "tiny_vgg_32", "edge_residual_32", "resnet_mini_16")
SHOWCASES = ("deep_cascade_224", "residual_block_224", "fat_cascade_16")


def _numpy_env(src, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    inputs = {k: rng.integers(-4, 5, size=src.values[k].shape,
                              dtype=np.int32) for k in src.graph_inputs}
    params = {n: rng.integers(-4, 5, size=v.shape, dtype=np.int32)
              for n, v in src.values.items() if v.is_constant}
    return inputs, params


def _check_output(name, out, src):
    import numpy as np

    want = tuple(src.values[src.graph_outputs[0]].shape)
    if tuple(out.shape)[-len(want):] != want:
        raise AssertionError(f"{name}: output shape {out.shape}, want {want}")
    if not np.isfinite(out.astype(np.float64)).all():
        raise AssertionError(f"{name}: non-finite output")


def main_path(torch) -> tuple[dict, dict]:
    import numpy as np

    import repro_torch
    from repro_torch.kernels import conv2d_stream as cs

    suite = repro_torch.suite()
    arts = {}
    rows = []
    for name in ZOO_MODELS + SHOWCASES:
        t0 = time.perf_counter()
        art = repro_torch.compile_graph(suite[name](), target="kv260")
        compile_s = time.perf_counter() - t0
        arts[name] = art
        src = art.source
        inputs, params = _numpy_env(src, seed=1)
        before = cs.launches
        t0 = time.perf_counter()
        got = art.run(inputs, params)                 # on the card
        run_ms = (time.perf_counter() - t0) * 1e3
        launched = cs.launches - before
        want = art.run(inputs, params, device="cpu")  # plain versions, host
        _check_output(name, got, src)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{name}: card run != device='cpu' run")
        row = {"model": name, "groups": len(art.design.groups),
               "compile_s": round(compile_s, 3), "first_run_ms": run_ms,
               "launches_per_run": launched, "equals_cpu": True}
        if name in ZOO_MODELS:
            rng = np.random.default_rng(2)
            xb = {k: rng.integers(-4, 5, size=(32,) + tuple(v.shape),
                                  dtype=np.int32) for k, v in inputs.items()}
            before = cs.launches
            vm = art.run(xb, params, batch_mode="vmap")
            row["launches_per_batch32"] = cs.launches - before
            lp = art.run(xb, params, batch_mode="loop")
            if not np.array_equal(vm, lp):
                raise AssertionError(f"{name}: batched (vmap) != loop")
            if not np.array_equal(vm[:4], art.run(
                    {k: v[:4] for k, v in xb.items()}, params, device="cpu")):
                raise AssertionError(f"{name}: batched card run != cpu run")
            row["vmap_equals_loop"] = True
            # floats too: same kernel, same summation order whatever the
            # batch, so batched == loop bit for bit on the card
            rng = np.random.default_rng(4)
            xf = {k: rng.standard_normal((8,) + tuple(v.shape)).astype(
                np.float32) for k, v in inputs.items()}
            pf = {n: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                  for n, v in params.items()}
            fv = art.run(xf, pf, batch_mode="vmap")
            if fv.dtype != np.float32 or not np.isfinite(fv).all():
                raise AssertionError(f"{name}: float run not finite f32")
            if not np.array_equal(fv, art.run(xf, pf, batch_mode="loop")):
                raise AssertionError(f"{name}: float batched (vmap) != loop")
            row["float_vmap_equals_loop"] = True
        rows.append(row)
    return {"models": rows}, arts


def serve(torch, arts) -> dict:
    import numpy as np

    from repro_torch.serve import ServeConfig, ServeEngine, run_load

    class Recording:
        """Engine proxy that keeps every future the load generator gets."""

        def __init__(self, engine):
            self._engine = engine
            self.futures = []

        def __getattr__(self, name):
            return getattr(self._engine, name)

        def submit(self, inputs):
            fut = self._engine.submit(inputs)
            self.futures.append(fut)
            return fut

    plan = [(m, 32, 256, 2000.0) for m in ZOO_MODELS]
    plan.append(("deep_cascade_224", 8, 16, 200.0))
    rows = []
    for name, max_batch, requests, qps in plan:
        art = arts[name]
        src = art.source
        _, params = _numpy_env(src, seed=1)
        rng = np.random.default_rng(3)
        pool = [{k: rng.integers(-4, 5, size=src.values[k].shape,
                                 dtype=np.int32) for k in src.graph_inputs}
                for _ in range(16)]
        direct = [art.run(x, params) for x in pool]
        cfg = ServeConfig(max_batch=max_batch, latency_budget_ms=5.0)
        with ServeEngine(art, cfg, params=params) as eng:
            rec = Recording(eng)
            report = run_load(rec, offered_qps=qps, requests=requests,
                              seed=0, inputs=pool)
            snap = eng.metrics()
        if len(rec.futures) != requests or report.rejected:
            raise AssertionError(f"{name}: {report.rejected} rejected")
        for i, fut in enumerate(rec.futures):
            if not np.array_equal(fut.result(), direct[i % len(pool)]):
                raise AssertionError(f"{name}: request {i} != direct run")
        stages = {}
        for row in snap["histograms"]["serve_stage_ms"]["values"]:
            if row["count"]:
                stages[row["labels"]["stage"]] = row["sum"] / row["count"]
        rows.append(dict(report.row(), model=name, max_batch=max_batch,
                         stage_mean_ms=stages, all_equal_direct=True))
    return {"engines": rows}


# ---------------------------------------------------------------------------
# phase 6: the flash-attention kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset) — checked in f32 and bf16
ATTN_CASES = (
    ("llama3.2-1b.prefill", 4, 32, 8, 1024, 1024, 64, True, 0),
    ("qwen2-0.5b.prefill", 4, 14, 2, 1024, 1024, 64, True, 0),
    ("yi-9b.d128", 2, 32, 4, 1024, 1024, 128, True, 0),
    ("llama3.2-1b.noncausal", 4, 32, 8, 1024, 1024, 64, False, 0),
    ("offset.sq256.sk1024", 2, 32, 8, 256, 1024, 64, True, 768),
    ("ragged.s100", 3, 14, 2, 100, 100, 64, True, 0),
    ("ragged.s1000", 2, 14, 2, 1000, 1000, 64, True, 0),
    ("ragged.s1000.noncausal.d40", 1, 8, 2, 1000, 1000, 40, False, 0),
    ("b1.s1", 1, 32, 8, 1, 1, 64, True, 0),
    ("b1.s1.offset", 1, 32, 8, 1, 77, 128, True, 76),
)
#: timed shapes: the prefill attention of the two served models
ATTN_TIMED = ("llama3.2-1b.prefill", "qwen2-0.5b.prefill", "yi-9b.d128")
ATTN_HEADLINE = ("llama3.2-1b.prefill", "bfloat16")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through — the work this input
    needs, not the most it could."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, r + q_offset + 1)) for r in range(sq))


def attn_check(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, b, hq, hkv, sq, sk, d, causal, q_offset in ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            q = (torch.randn(b * hq, sq, d, generator=gen)
                 * d ** -0.5).to(dtype).cuda()
            k = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            v = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            kw = dict(heads_q=hq, heads_kv=hkv, causal=causal,
                      q_offset=q_offset)
            run = lambda: fa.flash_attention(q, k, v, **kw)
            plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
            out, exp = run(), plain()
            torch.cuda.synchronize()
            what = f"{name} {dt_name}"
            if out.shape != exp.shape or out.dtype != exp.dtype:
                raise AssertionError(f"{what}: {out.shape} {out.dtype} vs "
                                     f"{exp.shape} {exp.dtype}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{what}: non-finite output")
            tol = ATTN_TOL[dt_name]
            diff = (out.float() - exp.float()).abs()
            if not bool((diff <= tol + tol * exp.float().abs()).all()):
                raise AssertionError(
                    f"{what}: max |err| {float(diff.max())} beyond atol = "
                    f"rtol = {tol}")
            err = float(diff.max())
            worst[dt_name] = max(worst[dt_name], err)
            n += 1
            if name not in ATTN_TIMED:
                continue
            ms = time_ms(run, warmup=3, reps=20)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=10, kernel="flash_attention_kernel")
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (q, k, v, out))
            flops = 4 * b * hq * d * _visible_pairs(sq, sk, causal, q_offset)
            peak = (TENSOR_CORE_BF16_OPS_PER_S if dtype == torch.bfloat16
                    else CUDA_CORE_OPS_PER_S)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            # yardstick: one PyTorch call for the same function (Sq == Sk,
            # no offset, so its causal convention is the kernel's)
            q4 = q.view(b, hq, sq, d)
            k4, v4 = k.view(b, hkv, sk, d), v.view(b, hkv, sk, d)
            lib = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=1.0, enable_gqa=True)
            lib_err = float((lib().float() - out.float().view(b, hq, sq, d))
                            .abs().max())
            if lib_err > tol + tol * float(exp.float().abs().max()):
                raise AssertionError(f"{what}: SDPA differs by {lib_err}")
            library_ms = time_ms(lib, warmup=3, reps=20)
            shapes.append({
                "shape": name, "dtype": dt_name,
                "q": [b, hq, sq, d], "kv": [b, hkv, sk, d],
                "causal": causal, "q_offset": q_offset,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "flops": flops, "library_ms": library_ms,
                "library_vs_kernel_max_abs": lib_err, "max_abs_err": err,
            })
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 7: the fused-MLP kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, M, D, F, gated, act) — checked in f32 and bf16
MLP_CASES = (
    ("llama3.2-1b.prefill", 4096, 2048, 8192, True, "silu"),
    ("llama3.2-1b.decode", 4, 2048, 8192, True, "silu"),
    ("qwen2-0.5b.prefill", 4096, 896, 4864, True, "silu"),
    ("qwen2-0.5b.m100", 100, 896, 4864, True, "silu"),
    ("yi-9b.m1", 1, 4096, 11008, True, "silu"),
    ("d4096.m100.ungated", 100, 4096, 2048, False, "gelu"),
    ("d8192.limit", 4, 8192, 1024, True, "silu"),
    ("odd.d895.f999", 37, 895, 999, True, "gelu"),   # element-wise loads
) + tuple(
    (f"{act}.{'gated' if gated else 'ungated'}.f1000", 100, 896, 1000,
     gated, act)
    for act in ("silu", "gelu", "relu", "squared_relu")
    for gated in (True, False))
#: timed shapes: the streamed MLP of llama3.2-1b at prefill and decode
MLP_TIMED = ("llama3.2-1b.prefill", "llama3.2-1b.decode")
MLP_HEADLINE = ("llama3.2-1b.prefill", "bfloat16")
#: f32: the reference's 5e-4 (tests/test_kernels.py:159); bf16: the
#: output is rounded to bf16 (one step is 2^-8 relative), 1e-2 allows it
MLP_TOL = {"float32": 5e-4, "bfloat16": 1e-2}


def _mlp_dense(torch, x, wg, wu, wd, act):
    """The yardstick: ``mlp_impl="dense"``'s three cuBLAS products plus
    the activation, in the input dtype — several calls, not one."""
    from repro_torch.kernels import ref

    up = x @ wu
    h = ref._act(act, x @ wg) * up if wg is not None else ref._act(act, up)
    return h @ wd


def mlp_check(torch) -> dict:
    from repro_torch.core import dse
    from repro_torch.kernels import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, m, d, f, gated, act in MLP_CASES:
        x32 = torch.randn(m, d, generator=gen)
        w32 = [torch.randn(d, f, generator=gen) * d ** -0.5 if gated
               else None,
               torch.randn(d, f, generator=gen) * d ** -0.5,
               torch.randn(f, d, generator=gen) * f ** -0.5]
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x = x32.to(dtype).cuda()
            wg, wu, wd = (None if w is None else w.to(dtype).cuda()
                          for w in w32)
            run = lambda: fm.fused_mlp(x, wg, wu, wd, act=act)
            plain = lambda: fm.fused_mlp_plain(x, wg, wu, wd, act=act)
            out, exp = run(), plain()
            torch.cuda.synchronize()
            what = f"{name} {dt_name}"
            if out.shape != exp.shape or out.dtype != exp.dtype:
                raise AssertionError(f"{what}: {out.shape} {out.dtype} vs "
                                     f"{exp.shape} {exp.dtype}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{what}: non-finite output")
            tol = MLP_TOL[dt_name]
            diff = (out.float() - exp.float()).abs()
            if not bool((diff <= tol + tol * exp.float().abs()).all()):
                raise AssertionError(
                    f"{what}: max |err| {float(diff.max())} beyond atol = "
                    f"rtol = {tol}")
            err = float(diff.max())
            worst[dt_name] = max(worst[dt_name], err)
            n += 1
            if name not in MLP_TIMED:
                continue
            plan = dse.plan_mlp_blocks(m=m, d=d, f=f)
            ms = time_ms(run, warmup=2, reps=10)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=5, kernel=("fused_mlp_kernel",
                                                    "sum_partials_kernel"))
            lib = lambda: _mlp_dense(torch, x, wg, wu, wd, act)
            lib_err = float((lib().float() - exp.float()).abs().max())
            library_ms = time_ms(lib, warmup=2, reps=10)
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (x, wg, wu, wd, out) if t is not None)
            flops = 2 * m * d * f * (3 if gated else 2)
            peak = (TENSOR_CORE_BF16_OPS_PER_S if dtype == torch.bfloat16
                    else CUDA_CORE_OPS_PER_S)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            shapes.append({
                "shape": name, "dtype": dt_name, "m": m, "d": d, "f": f,
                "gated": gated, "act": act, "plan": plan.blocks,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "flops": flops,
                "library_ms": library_ms,
                "library_is": "dense MLP: 3 cuBLAS matmuls + activation",
                "library_vs_plain_max_abs": lib_err, "max_abs_err": err,
            })
    # weights that are contiguous views one element into their storage:
    # pairs of elements are not aligned, the kernel loads them one by one
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        m, d, f = 5, 256, 320
        stores = [(torch.randn(d * f + 1, generator=gen) * 0.06).to(
            dtype).cuda() for _ in range(3)]
        wg, wu = stores[0][1:].view(d, f), stores[1][1:].view(d, f)
        wd = stores[2][1:].view(f, d)
        x = torch.randn(m, d, generator=gen).to(dtype).cuda()
        out = fm.fused_mlp(x, wg, wu, wd, act="relu")
        exp = fm.fused_mlp_plain(x, wg, wu, wd, act="relu")
        torch.cuda.synchronize()
        tol = MLP_TOL[dt_name]
        diff = (out.float() - exp.float()).abs()
        if not bool((diff <= tol + tol * exp.float().abs()).all()):
            raise AssertionError(f"offset views {dt_name}: max |err| "
                                 f"{float(diff.max())}")
        worst[dt_name] = max(worst[dt_name], float(diff.max()))
        n += 1
    # the register accumulator's limit: one D past it raises, never runs
    too_wide = torch.zeros(1, dse.MLP_MAX_D + 256).cuda()
    w_up = torch.zeros(dse.MLP_MAX_D + 256, 64).cuda()
    try:
        fm.fused_mlp(too_wide, None, w_up, w_up.T.contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("fused_mlp took a D past its limit")
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "d_limit": dse.MLP_MAX_D,
            "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 8: the SSD kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, B, L, H, P, N, chunk) — checked in f32 and bf16 (x, b, c; dt and
#: a f32, as the model passes them)
SSD_CASES = (
    ("mamba2-1.3b.prefill", 4, 1024, 64, 64, 128, 64),
    ("chunk1.prime.l37", 1, 37, 8, 64, 128, 1),
    ("chunk8.l200", 4, 200, 8, 64, 128, 8),
    ("chunk33.l1023", 1, 1023, 8, 64, 128, 33),
    ("chunk64.l1024.b1", 1, 1024, 8, 64, 128, 64),
    ("chunk128.l512", 4, 512, 8, 64, 128, 128),
    ("smoke.p16.n16", 2, 64, 8, 16, 16, 8),
    ("test.p8.n8.h3", 3, 32, 3, 8, 8, 4),
)
SSD_TIMED = ("mamba2-1.3b.prefill",)
SSD_HEADLINE = ("mamba2-1.3b.prefill", "bfloat16")
#: f32: the reference's 1e-3 (tests/test_kernels.py:212); bf16: y is
#: rounded to bf16 (2^-8 relative) from the same bf16 inputs, 1e-2
SSD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


def _ssd_inputs(torch, gen, b, l, h, p, n):
    """The reference test's distributions: dt = softplus(N(0, 1)), a =
    -exp(0.3 N(0, 1)), b and c 0.5 N(0, 1)."""
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen))
    a = -torch.exp(torch.randn(h, generator=gen) * 0.3)
    bm = torch.randn(b, l, n, generator=gen) * 0.5
    cm = torch.randn(b, l, n, generator=gen) * 0.5
    return x, dt, a, bm, cm


def _ssd_work(b, l, h, p, n, q):
    """Operations of one scan with tiles of ``q`` positions: per tile the
    causal half of c.b^T once (shared by the heads), and per head the
    causal intra term, the carried-state term and the state update."""
    flops = 0
    for l0 in range(0, l, q):
        qv = min(q, l - l0)
        tri = qv * (qv + 1) // 2
        flops += 2 * b * (tri * n + h * (tri * p + 2 * qv * n * p))
    return flops


def _close(out, exp, tol, what):
    import torch

    if out.shape != exp.shape or out.dtype != exp.dtype:
        raise AssertionError(f"{what}: {tuple(out.shape)} {out.dtype} vs "
                             f"{tuple(exp.shape)} {exp.dtype}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - exp.float()).abs()
    if not bool((diff <= tol + tol * exp.float().abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(diff.max())} beyond "
                             f"atol = rtol = {tol}")
    return float(diff.max())


def ssd_check(torch) -> dict:
    from repro_torch.core import dse
    from repro_torch.kernels import mamba2_ssd as ms

    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    shapes = []
    for name, b, l, h, p, n, chunk in SSD_CASES:
        x32, dt, a, bm32, cm32 = _ssd_inputs(torch, gen, b, l, h, p, n)
        dt, a = dt.cuda(), a.cuda()
        s0 = torch.zeros(b, h, p, n).cuda()
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x, bm, cm = (v.to(dtype).cuda() for v in (x32, bm32, cm32))
            run = lambda: ms.mamba2_ssd(x, dt, a, bm, cm, s0, chunk=chunk)
            plain = lambda: ms.mamba2_ssd_plain(x, dt, a, bm, cm, s0,
                                                chunk=chunk)
            (y, sf), (ye, se) = run(), plain()
            torch.cuda.synchronize()
            tol = SSD_TOL[dt_name]
            err = max(_close(y, ye, tol, f"{name} {dt_name} y"),
                      _close(sf, se, SSD_TOL["float32"],
                             f"{name} {dt_name} state"))
            n_cmp += 1
            if l % (2 * chunk) == 0 and l >= 2 * chunk:
                # the state carries across two calls as through one
                half = l // 2
                y1, s1 = ms.mamba2_ssd(x[:, :half], dt[:, :half], a,
                                       bm[:, :half], cm[:, :half], s0,
                                       chunk=chunk)
                y2, s2 = ms.mamba2_ssd(x[:, half:], dt[:, half:], a,
                                       bm[:, half:], cm[:, half:], s1,
                                       chunk=chunk)
                torch.cuda.synchronize()
                err = max(err, _close(torch.cat([y1, y2], 1), ye, tol,
                                      f"{name} {dt_name} carried y"),
                          _close(s2, se, SSD_TOL["float32"],
                                 f"{name} {dt_name} carried state"))
                n_cmp += 1
            worst[dt_name] = max(worst[dt_name], err)
            if name not in SSD_TIMED:
                continue
            ms_ = time_ms(run, warmup=2, reps=20)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=10, kernel=("mamba2_ssd_kernel",))
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (x, dt, a, bm, cm, s0, y, sf))
            flops = _ssd_work(b, l, h, p, n, dse.SSD_BLOCK_L)
            peak = (TENSOR_CORE_BF16_OPS_PER_S if dtype == torch.bfloat16
                    else CUDA_CORE_OPS_PER_S)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            shapes.append({
                "shape": name, "dtype": dt_name, "b": b, "l": l, "h": h,
                "p": p, "n": n, "chunk": chunk, "ms": ms_,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": n_bytes, "flops": flops, "library_ms": None,
                "max_abs_err": err,
            })
    return {"comparisons": n_cmp, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 9: the LM server at full width
# ---------------------------------------------------------------------------

LM_MODELS = ("llama3.2-1b", "qwen2-0.5b")
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
#: prefill logits, "cuda" vs "blockwise" attention, bf16 through every
#: layer: the two sum in another order, so a few bf16 outputs of
#: attention differ in the last bit and the difference grows layer by
#: layer — allowed: 2 % of the largest |logit| plus 0.02
LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL = 0.02, 0.02


#: the dense model that also serves with ``mlp_impl="streamed"`` (the
#: fused-MLP kernel): one prefill and STREAMED_STEPS decode steps, logits
#: held against the ``"dense"`` engine by the rule above
STREAMED_ARCH, STREAMED_STEPS = "llama3.2-1b", 8


#: substrings of cuBLAS' kernel names (``nvjet_*`` on Hopper with CUDA 12.8)
MATMUL_KERNELS = ("nvjet", "gemm", "xmma", "cutlass", "gemv")


def _prefill_breakdown(torch, eng, prompts, *, reps: int = 5,
                       classes=(("attention", "flash_attention_kernel"),)
                       ) -> dict:
    """Where a warm prefill's time goes: the card's time in each class of
    hand-written kernel (``classes``: (name, kernel-name piece) pairs), in
    matmuls and in everything else, and the wall time of the
    same ``reps`` prefills, all under the profiler; the gap between busy
    and wall time is the card's idle share (negative where the busy time
    exceeds the wall, which is then flagged, not hidden).  The wall of
    ``reps`` unprofiled prefills stands beside it, to show what the
    profiler adds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.prefill(prompts)
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    walls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.prefill(prompts)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    parts = {name: 0.0 for name, _ in classes}
    parts.update(matmul=0.0, other=0.0)
    kernels = []
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "self_cuda_time_total", 0.0))
        if not us:
            continue
        kernels.append((us / reps, ev.key))
        key = ev.key.lower()
        cls = next((name for name, piece in classes if piece in key), None)
        if cls is not None:
            parts[cls] += us
        elif any(t in key for t in MATMUL_KERNELS):
            parts["matmul"] += us
        else:
            parts["other"] += us
    out = {f"{k}_ms": v / 1e3 / reps for k, v in parts.items()}
    busy = sum(parts.values()) / 1e3 / reps
    wall_ms = sum(walls) / reps
    out.update({
        "reps": reps, "device_busy_ms": busy, "wall_ms": wall_ms,
        "wall_ms_each": walls, "unprofiled_wall_ms": unprofiled_ms,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "busy_exceeds_wall": busy > wall_ms,
        "top_kernels": [[name[:80], us / 1e3]
                        for us, name in sorted(kernels, reverse=True)[:6]],
    })
    return out


def lm_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ServeEngine

    rows = []
    for arch in LM_MODELS:
        cfg = get_config(arch)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                               dtype=np.int32)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0

        before = fa.launches
        out, cold = eng.generate(prompts, max_new=LM_NEW)
        per_prefill = fa.launches - before
        if per_prefill != cfg.num_layers:
            raise AssertionError(
                f"{arch}: {per_prefill} flash launches in one prefill, want "
                f"{cfg.num_layers} (one per layer)")
        if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch}: tokens {out.shape} out of range")
        out2, warm = eng.generate(prompts, max_new=LM_NEW)
        if not np.array_equal(out, out2):
            raise AssertionError(f"{arch}: greedy generate not repeatable")

        logits, _ = eng.prefill(prompts)
        blockwise = ServeEngine(cfg.with_(attn_impl="blockwise"),
                                max_len=LM_PROMPT + LM_NEW,
                                params=eng.params)
        ref_logits, _ = blockwise.prefill(prompts)
        torch.cuda.synchronize()
        if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} "
                                 "not finite of the expected shape")
        err = float((logits - ref_logits).abs().max())
        scale = float(ref_logits.abs().max())
        allowed = LM_LOGIT_RTOL_OF_MAX * scale + LM_LOGIT_ATOL
        if err > allowed:
            raise AssertionError(
                f"{arch}: prefill logits cuda vs blockwise differ by {err} "
                f"(allowed {allowed})")
        same_first = float((logits.argmax(-1) == ref_logits.argmax(-1))
                           .float().mean())
        breakdown = _prefill_breakdown(torch, eng, prompts)
        streamed = (_streamed_mlp(torch, eng, cfg, prompts)
                    if arch == STREAMED_ARCH else None)
        rows.append({
            "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
            "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
            "init_s": init_s,
            "cold": dataclasses.asdict(cold), "warm": dataclasses.asdict(warm),
            "flash_launches_per_prefill": per_prefill,
            "logits_max_abs_vs_blockwise": err, "logits_max_abs": scale,
            "logits_allowed": allowed, "argmax_agreement": same_first,
            "prefill_breakdown": breakdown, "streamed_mlp": streamed,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        })
        del eng, blockwise, logits, ref_logits
        torch.cuda.empty_cache()
    return {"models": rows}


def _logit_gap(a, b, rtol_of_max, atol, what):
    """max |a - b| against ``rtol_of_max`` × max |b| + ``atol``; raises
    beyond it or on non-finite logits."""
    import torch

    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: logits {tuple(a.shape)} not finite "
                             f"of the shape {tuple(b.shape)}")
    err = float((a.float() - b.float()).abs().max())
    scale = float(b.float().abs().max())
    allowed = rtol_of_max * scale + atol
    if err > allowed:
        raise AssertionError(f"{what}: logits differ by {err} (allowed "
                             f"{allowed})")
    return {"max_abs": err, "max_logit": scale, "allowed": allowed}


def _prefill_ms(torch, eng, prompts, reps: int = 3) -> float:
    eng.prefill(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.prefill(prompts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _streamed_mlp(torch, eng, cfg, prompts) -> dict:
    """``mlp_impl="streamed"`` on the engine's weights: one prefill and
    STREAMED_STEPS decode steps, fused-MLP launches counted per call,
    logits held against the ``"dense"`` engine step by step (both fed the
    dense engine's greedy tokens), and warm prefill / decode-step times
    beside the dense ones."""
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.launch.serve import ServeEngine

    st = ServeEngine(cfg.with_(mlp_impl="streamed"),
                     max_len=LM_PROMPT + LM_NEW, params=eng.params)
    bsz, plen = prompts.shape
    gaps = []
    with torch.inference_mode():
        before = fm.launches
        ls, cs_ = st.prefill(prompts)
        torch.cuda.synchronize()
        per_prefill = fm.launches - before
        ld, cd = eng.prefill(prompts)
        gaps.append(_logit_gap(ls, ld, LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL,
                               "streamed prefill"))
        cache_s = st._expand_cache(cs_, bsz, plen)
        cache_d = eng._expand_cache(cd, bsz, plen)
        tok = ld.argmax(-1).to(torch.int32)
        per_step, step_ms = [], {"streamed": [], "dense": []}
        for i in range(STREAMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = fm.launches
            ls, cache_s = st._decode_step(st.params, cache_s, tok, plen + i)
            torch.cuda.synchronize()
            per_step.append(fm.launches - before)
            t1 = time.perf_counter()
            ld, cache_d = eng._decode_step(eng.params, cache_d, tok, plen + i)
            torch.cuda.synchronize()
            step_ms["streamed"].append((t1 - t0) * 1e3)
            step_ms["dense"].append((time.perf_counter() - t1) * 1e3)
            gaps.append(_logit_gap(ls, ld, LM_LOGIT_RTOL_OF_MAX,
                                   LM_LOGIT_ATOL, f"streamed decode {i}"))
            tok = ld.argmax(-1).to(torch.int32)
    if per_prefill != cfg.num_layers or per_step != [cfg.num_layers] * \
            STREAMED_STEPS:
        raise AssertionError(
            f"streamed MLP: {per_prefill} fused-MLP launches per prefill, "
            f"{per_step} per decode step; want {cfg.num_layers} each")
    return {
        "fused_mlp_launches_per_prefill": per_prefill,
        "fused_mlp_launches_per_step": per_step,
        "logit_gaps_vs_dense": gaps,
        "prefill_ms": {"streamed": _prefill_ms(torch, st, prompts),
                       "dense": _prefill_ms(torch, eng, prompts)},
        "decode_step_ms": step_ms,
    }


# ---------------------------------------------------------------------------
# phase 10: the Mamba-2 server at full width
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
#: one decode step after an (L-1)-token prefill against an L-token
#: prefill, bf16 through all 48 layers: the recurrent step and the scan
#: round in other places, and the gap grows layer by layer — allowed: 5 %
#: of the largest |logit| plus 0.05
SSM_DECODE_RTOL_OF_MAX, SSM_DECODE_ATOL = 0.05, 0.05
#: the card against the port's own CPU run, same weights, at full width
#: and this depth and batch (bf16 on both; the CPU's products sum in
#: another order): the rule of the dense models' blockwise check
SSM_CPU_LAYERS, SSM_CPU_BATCH = 2, 2


def ssm_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mamba2_ssd as ms
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(SSM_ARCH)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    before = ms.launches
    out, cold = eng.generate(prompts, max_new=LM_NEW)
    per_prefill = ms.launches - before
    if per_prefill != cfg.num_layers:
        raise AssertionError(
            f"{SSM_ARCH}: {per_prefill} SSD launches in one generate, want "
            f"{cfg.num_layers} (one per layer of the prefill)")
    if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"{SSM_ARCH}: tokens {out.shape} out of range")
    out2, warm = eng.generate(prompts, max_new=LM_NEW)
    if not np.array_equal(out, out2):
        raise AssertionError(f"{SSM_ARCH}: greedy generate not repeatable")

    # the kernel's final state against the recurrence: decode the last
    # prompt token after an (L-1)-token prefill (chunk 33, a ragged tile)
    with torch.inference_mode():
        full, _ = eng.prefill(prompts)
        short, caches = eng.prefill(prompts[:, :-1])
        cache = eng._expand_cache(caches, LM_BATCH, LM_PROMPT - 1)
        last = torch.as_tensor(prompts[:, -1], dtype=torch.int32,
                               device=eng.device)
        stepped, _ = eng._decode_step(eng.params, cache, last, LM_PROMPT - 1)
    torch.cuda.synchronize()
    if tuple(full.shape) != (LM_BATCH, cfg.vocab_size):
        raise AssertionError(f"{SSM_ARCH}: logits {tuple(full.shape)}")
    decode_gap = _logit_gap(stepped, full, SSM_DECODE_RTOL_OF_MAX,
                            SSM_DECODE_ATOL, f"{SSM_ARCH} decode vs prefill")
    decode_gap["argmax_agreement"] = float(
        (stepped.argmax(-1) == full.argmax(-1)).float().mean())

    breakdown = _prefill_breakdown(torch, eng, prompts,
                                   classes=(("ssd", "mamba2_ssd_kernel"),))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng, full, short, caches, cache, stepped
    torch.cuda.empty_cache()

    # full width, depth 2: the card against the port's own CPU run
    cfg2 = cfg.with_(num_layers=SSM_CPU_LAYERS)
    sub = prompts[:SSM_CPU_BATCH]
    card = ServeEngine(cfg2, max_len=LM_PROMPT, seed=1)
    card_logits, _ = card.prefill(sub)
    cpu_params = _tree_to(card.params, "cpu")
    t0 = time.perf_counter()
    host = ServeEngine(cfg2, device="cpu", max_len=LM_PROMPT,
                       params=cpu_params)
    cpu_logits, _ = host.prefill(sub)
    cpu_s = time.perf_counter() - t0
    cpu_gap = _logit_gap(card_logits.cpu(), cpu_logits, LM_LOGIT_RTOL_OF_MAX,
                         LM_LOGIT_ATOL, f"{SSM_ARCH} depth 2 card vs cpu")
    agree = card_logits.argmax(-1).cpu() == cpu_logits.argmax(-1)
    if not bool(agree.all()):
        raise AssertionError(f"{SSM_ARCH} depth 2: argmax differs between "
                             f"the card and the CPU ({agree.tolist()})")
    s = cfg.ssm
    return {
        "arch": SSM_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "ssm": {"heads": s.num_heads(cfg.d_model), "head_dim": s.head_dim,
                "state_dim": s.state_dim, "chunk": s.chunk},
        "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
        "init_s": init_s, "cold": dataclasses.asdict(cold),
        "warm": dataclasses.asdict(warm),
        "ssd_launches_per_prefill": per_prefill,
        "decode_vs_prefill": decode_gap,
        "depth2_card_vs_cpu": dict(cpu_gap, batch=SSM_CPU_BATCH,
                                   cpu_seconds=cpu_s, argmax_agrees=True),
        "prefill_breakdown": breakdown, "peak_mem_gb": peak,
    }


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' register / shared-memory report")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phase(s) {sorted(unknown)}")

    # a hang must fail the run inside its time limit, not outlast it
    signal.signal(signal.SIGALRM, _timed_out)
    signal.alarm(WATCHDOG_S)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one CUDA device and takes no CPU path", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mamba2_ssd as ms

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    if "device" in phases:
        nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()
        emit({"device": {"nvidia_smi": smi, "kind": kind,
                         "count": torch.cuda.device_count(),
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda,
                         "nvcc": nvcc[-2:] if nvcc else None}})
    # always from the checkout's sources, whatever a build directory
    # holds: one nvcc per kernel, all started together
    libraries = (cs.LIBRARY, fa.LIBRARY, fm.LIBRARY, ms.LIBRARY)
    t0 = time.perf_counter()
    build.build_libraries(libraries, verbose=args.ptxas)
    build_s = time.perf_counter() - t0
    for lib in libraries:
        lib.load()
    if "build" in phases:
        emit({"build": {"seconds": build_s,
                        "libraries": {
                            lib.name: {"seconds": lib.build_seconds,
                                       "path": os.path.relpath(
                                           str(lib.path), ROOT)}
                            for lib in libraries},
                        "flags": list(build.NVCC_FLAGS)}})
    checked = None
    if "kernel_check" in phases:
        checked = kernel_check(torch)
        emit({"kernel_check": checked})

    cs.reset_counts()                  # counts: zero before the main path
    arts = None
    if "main_path" in phases or "serve" in phases:
        result, arts = main_path(torch)
        emit({"main_path": result})
    if "serve" in phases:
        emit({"serve": serve(torch, arts)})
    launches, plain_cuda = cs.launches, cs.plain_cuda_calls   # read after
    if arts is not None:
        if launches < 1:
            raise AssertionError("the main path never launched conv2d_stream")
        if plain_cuda:
            raise AssertionError(
                f"the plain version ran {plain_cuda} time(s) on a CUDA "
                "tensor on the main path")

    attn = mlp = ssd = None
    if "attn_check" in phases:
        attn = attn_check(torch)
        emit({"attn_check": attn})
    if "mlp_check" in phases:
        mlp = mlp_check(torch)
        emit({"mlp_check": mlp})
    if "ssd_check" in phases:
        ssd = ssd_check(torch)
        emit({"ssd_check": ssd})

    def read_after(mod, name: str, path: str) -> int:
        """The counts of ``mod`` after ``path`` ran; fails if its kernel
        never launched there or its plain version ran on a CUDA tensor."""
        if mod.launches < 1:
            raise AssertionError(f"the {path} path never launched {name}")
        if mod.plain_cuda_calls:
            raise AssertionError(
                f"{name}'s plain version ran {mod.plain_cuda_calls} time(s) "
                f"on a CUDA tensor on the {path} path")
        return mod.launches

    fa.reset_counts()                  # counts: zero before the LM path
    fm.reset_counts()
    if "lm_serve" in phases:
        emit({"lm_serve": lm_serve(torch)})
        fa_launches = read_after(fa, "flash_attention", "LM")   # after
        fm_launches = read_after(fm, "fused_mlp", "LM")
    ms.reset_counts()                  # counts: zero before the SSM path
    if "ssm_serve" in phases:
        emit({"ssm_serve": ssm_serve(torch)})
        ms_launches = read_after(ms, "mamba2_ssd", "SSM")       # after

    if set(phases) != set(PHASES):
        emit({"partial": phases,
              "seconds": round(time.perf_counter() - t_all, 1)})
        return 0
    head = next(s for s in checked["shapes"]
                if s["shape"] == HEADLINE_SHAPE and s["dtype"] == "int32")
    ahead = next(s for s in attn["shapes"]
                 if (s["shape"], s["dtype"]) == ATTN_HEADLINE)
    mhead = next(s for s in mlp["shapes"]
                 if (s["shape"], s["dtype"]) == MLP_HEADLINE)
    shead = next(s for s in ssd["shapes"]
                 if (s["shape"], s["dtype"]) == SSD_HEADLINE)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "conv2d_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_stream.cu",
        "replaces": "src/repro/kernels/conv2d_stream.py:70",
        "launches": launches,
        "max_abs_err": max(checked["max_abs_err_f32"],
                           checked["max_abs_err_bf16"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": f"{HEADLINE_SHAPE} int32 (no library call computes an "
                    "int32 conv; float shapes carry library_ms below)",
        "comparisons": checked["comparisons"],
        "shapes": checked["shapes"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": fa_launches,
        "max_abs_err": max(attn["max_abs_err_f32"], attn["max_abs_err_bf16"]),
        "ms": ahead["ms"], "plain_ms": ahead["plain_ms"],
        "bound_ms": ahead["bound_ms"], "bound_by": ahead["bound_by"],
        "library_ms": ahead["library_ms"],
        "timed_at": f"{ATTN_HEADLINE[0]} {ATTN_HEADLINE[1]} (library: "
                    "F.scaled_dot_product_attention, GQA, causal)",
        "comparisons": attn["comparisons"],
        "shapes": attn["shapes"],
    }, {
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:37",
        "launches": fm_launches,
        "max_abs_err": max(mlp["max_abs_err_f32"], mlp["max_abs_err_bf16"]),
        "ms": mhead["ms"], "plain_ms": mhead["plain_ms"],
        "bound_ms": mhead["bound_ms"], "bound_by": mhead["bound_by"],
        "library_ms": mhead["library_ms"],
        "timed_at": f"{MLP_HEADLINE[0]} {MLP_HEADLINE[1]} (library: "
                    "mlp_impl='dense', three cuBLAS matmuls + activation, "
                    "not one call)",
        "comparisons": mlp["comparisons"],
        "shapes": mlp["shapes"],
    }, {
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:26",
        "launches": ms_launches,
        "max_abs_err": max(ssd["max_abs_err_f32"], ssd["max_abs_err_bf16"]),
        "ms": shead["ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_ms"], "bound_by": shead["bound_by"],
        "library_ms": None,
        "timed_at": f"{SSD_HEADLINE[0]} {SSD_HEADLINE[1]} (no PyTorch call "
                    "computes an SSD scan)",
        "comparisons": ssd["comparisons"],
        "shapes": ssd["shapes"],
    }], "seconds": round(time.perf_counter() - t_all, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
