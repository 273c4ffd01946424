"""A short first check of the fused MLP's backward on the card.

Builds only ``csrc/fused_mlp_bwd.cu`` (printing ptxas' registers, spills
and any warning line of its kernels), holds the bf16 backward against its
plain version at seven small shapes — gated and ungated, ragged M, odd D
and F — with two calls giving the same bits, then times one call at
llama3.2-1b's train microbatch (M 16384, D 2048, F 8192, gated, silu):
CUDA events, and each kernel's device ms and TFLOP/s of tensor-core work
(lo planes counted, ``chip_smoke.mlp_bwd_mma_work``) from the profiler.
The full check is ``chip_smoke.py --phases device,build,mlp_bwd_check``.

    python3 scripts/mlp_bwd_quick.py        # on a machine with a card
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (M, D, F, gated, act)
SHAPES = ((128, 64, 64, True, "silu"), (37, 64, 256, True, "silu"),
          (1, 256, 320, False, "relu"), (100, 256, 1000, True, "gelu"),
          (100, 256, 1000, False, "squared_relu"),
          (1000, 896, 4864, True, "silu"), (37, 895, 999, True, "gelu"))
HEADLINE = (16384, 2048, 8192)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as fm

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_libraries([fm.BWD_LIBRARY], verbose=True)
    log = fm.BWD_LIBRARY.build_log
    for row in cs.ptxas_report(log):
        print(row, flush=True)
    for line in log.splitlines():
        if "warning" in line.lower() or "C7515" in line:
            print(line[:300])

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ok = True
    for m, d, f, gated, act in SHAPES:
        x = torch.randn(m, d, generator=gen)
        w = [torch.randn(d, f, generator=gen) * d ** -0.5 if gated else None,
             torch.randn(d, f, generator=gen) * d ** -0.5,
             torch.randn(f, d, generator=gen) * f ** -0.5]
        dy = torch.randn(m, d, generator=gen)
        ins = tuple(None if t is None else t.bfloat16().cuda()
                    for t in (x, *w, dy))
        got = fm.fused_mlp_bwd(*ins, act=act)
        again = fm.fused_mlp_bwd(*ins, act=act)
        want = fm.fused_mlp_bwd_plain(*ins, act=act)
        torch.cuda.synchronize()
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        needs = {n: cs._mlp_bwd_need(g, v, "bfloat16")
                 for n, g, v in zip(cs.MLP_BWD_GRADS, got, want)
                 if v is not None}
        held = same and all(v <= cs.MLP_TOL["bfloat16"]
                            for v in needs.values())
        ok &= held
        print((m, d, f, gated, act), fm.bwd_plan(*ins).route,
              "held" if held else "FAILED", "same bits" if same else
              "bits differ", json.dumps(needs), flush=True)

    m, d, f = HEADLINE
    ins = [torch.randn(m, d, device="cuda").bfloat16(),
           *((torch.randn(d, f, device="cuda") * d ** -0.5).bfloat16()
             for _ in range(2)),
           (torch.randn(f, d, device="cuda") * f ** -0.5).bfloat16(),
           torch.randn(m, d, device="cuda").bfloat16()]
    run = lambda: fm.fused_mlp_bwd(*ins, act="silu")
    got = run()
    want = fm.fused_mlp_bwd_plain(*ins, act="silu")
    print("headline need", {n: cs._mlp_bwd_need(g, v, "bfloat16")
                            for n, g, v in zip(cs.MLP_BWD_GRADS, got, want)})
    del want
    print("ms", cs.time_ms(run, warmup=1, reps=5), flush=True)
    each = cs.device_ms_each(run, reps=3, kernels=cs.MLP_BWD_KERNELS)
    work = cs.mlp_bwd_mma_work(m, d, f, True)
    print("device ms", each, "TFLOP/s",
          {k: work[k] / (each[k] * 1e-3) / 1e12 for k in work if each[k]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
