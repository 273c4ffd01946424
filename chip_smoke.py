#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON object on a line of its own:

1. ``device``     card name and power limit as ``nvidia-smi`` gives them,
                  torch / CUDA / nvcc versions;
2. ``build``      ``nvcc`` builds ``libconv2d_stream.so`` from the source in
                  the checkout (seconds taken);
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
                  every answer must equal the direct run.

The launch counters are zeroed just before phase 4 and read just after
phase 5; the run fails if the kernel was never launched there, or if its
plain version ever ran on a CUDA tensor in those phases.  Then the
``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; with no
CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernel_check", "main_path", "serve")

# data-sheet peaks of one H100 SXM used for the roofline bound
HBM_BYTES_PER_S = 3.35e12
#: CUDA-core rate: 67 TFLOP/s float32 outside the tensor cores.  The same
#: figure is used for int32 multiply-adds (no published integer peak; the
#: integer pipe is not faster, so the bound stays a lower bound on time).
CUDA_CORE_OPS_PER_S = 67e12

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


def device_ms(fn, *, reps: int, kernel: str):
    """Mean milliseconds the card spends inside ``kernel`` per call, from
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
    total_us = 0.0
    for ev in events:
        if kernel in ev.key:
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
    from repro_torch.kernels import conv2d_stream as cs

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    if "device" in phases:
        nvcc = subprocess.run([cs._nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()
        emit({"device": {"nvidia_smi": smi, "kind": kind,
                         "count": torch.cuda.device_count(),
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda,
                         "nvcc": nvcc[-2:] if nvcc else None}})
    # always from the checkout's source, whatever a build directory holds
    cs.build_library(verbose=args.ptxas)
    cs.load_library()
    if "build" in phases:
        emit({"build": {"seconds": cs.build_seconds,
                        "library": os.path.relpath(
                            str(cs.build_dir() / "libconv2d_stream.so"), ROOT),
                        "flags": list(cs.NVCC_FLAGS)}})
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

    if set(phases) != set(PHASES):
        emit({"partial": phases,
              "seconds": round(time.perf_counter() - t_all, 1)})
        return 0
    head = next(s for s in checked["shapes"]
                if s["shape"] == HEADLINE_SHAPE and s["dtype"] == "int32")
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
    }], "seconds": round(time.perf_counter() - t_all, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
