"""A short check of the attention backward (B2′) on the card.

Builds only ``csrc/flash_attention_bwd.cu`` (printing ptxas' registers,
spills and any warning line of its kernels), holds the bf16 backward
against its plain version at a few small shapes — ragged lengths, GQA, an
offset, rows that see no key, heads of 64, 128 and 40, a q two bytes off
16 — with two calls giving the same bits, each naming its route, then
times one call at llama3.2-1b's train shape (B 4, 32 / 8 heads of 64, S
4096, causal) and at a head of 128: CUDA events, and the delta, dK/dV and
dQ kernels' device ms from the profiler, with the TFLOP/s of the products
each does (dK/dV four of 2·D flops a visible (query, key) pair, dQ three)
and delta's GB/s.  ``--root`` runs another checkout's package (unpacked,
say, under ``build/parent``) with this script's shapes and clocks, so a
change and its parent can be timed in turns in one process each.  The
full check is ``chip_smoke.py --phases device,build,attn_bwd_check``.

    python3 scripts/attn_bwd_quick.py [--root DIR] [--no-check]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

#: (name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset), checked in bf16
SHAPES = (
    ("tile", 1, 4, 2, 128, 128, 64, True, 0),
    ("ragged.s100", 2, 8, 2, 100, 100, 64, True, 0),
    ("ragged.offset", 1, 4, 1, 77, 300, 64, True, 223),
    ("d128.g1", 2, 4, 4, 256, 256, 128, True, 0),
    ("d128.g8", 1, 16, 2, 512, 512, 128, True, 0),
    ("noncausal.sq1000.sk777", 1, 8, 2, 1000, 777, 64, False, 0),
    ("noncausal.d128", 1, 4, 2, 200, 333, 128, False, 0),
    ("no-visible-key", 1, 4, 2, 64, 64, 64, True, -3),
    ("offset.sq256.sk1024", 2, 8, 2, 256, 1024, 64, True, 768),
    ("d40", 1, 8, 2, 1000, 777, 40, False, 0),
    ("unaligned.q", 1, 4, 2, 128, 128, 64, True, 0),
)
TIMED = (("llama3.2-1b.train", 4, 32, 8, 4096, 4096, 64, True, 0),
         ("jamba.train.cut", 4, 8, 1, 4096, 4096, 128, True, 0))
KERNELS = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")


def _inputs(torch, gen, b, hq, hkv, sq, sk, d, *, unaligned=False):
    dt = torch.bfloat16
    q = (torch.randn(b * hq, sq, d, generator=gen) * d ** -0.5).to(dt).cuda()
    if unaligned:       # one element into a buffer: 2 bytes off 16
        buf = torch.empty(q.numel() + 1, dtype=dt, device="cuda")
        buf[1:].copy_(q.reshape(-1))
        q = buf[1:].view(q.shape)
    k = torch.randn(b * hkv, sk, d, generator=gen).to(dt).cuda()
    v = torch.randn(b * hkv, sk, d, generator=gen).to(dt).cuda()
    dout = torch.randn(b * hq, sq, d, generator=gen).to(dt).cuda()
    return q, k, v, dout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--no-check", action="store_true",
                    help="time only")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(root, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_libraries([fa.BWD_LIBRARY], verbose=True)
    log = fa.BWD_LIBRARY.build_log
    for row in cs.ptxas_report(log):
        print(row, flush=True)
    for line in log.splitlines():
        if "warning" in line.lower() or "C7515" in line:
            print(line[:300])

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ok = True
    for name, b, hq, hkv, sq, sk, d, causal, off in (
            () if args.no_check else SHAPES):
        q, k, v, dout = _inputs(torch, gen, b, hq, hkv, sq, sk, d,
                                unaligned=name == "unaligned.q")
        kw = dict(heads_q=hq, heads_kv=hkv, causal=causal, q_offset=off)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        bkw = dict(kw, scale=d ** -0.5)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **bkw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **bkw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **bkw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        needs = {n: cs._row_need(g, w) for n, g, w in
                 zip(("dq", "dk", "dv"), got, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        hidden = off < 0 and bool(got[0][:, :-off].any())
        held = (same and finite and not hidden
                and all(v_ <= cs.ATTN_BWD_TOL["bfloat16"][1]
                        for v_ in needs.values()))
        ok &= held
        route = (fa.bwd_plan(q, k, v, dout, heads_q=hq, heads_kv=hkv).route
                 if hasattr(fa, "bwd_plan") else "mma")
        print(name, route, "held" if held else "FAILED",
              "same bits" if same else "bits differ",
              json.dumps({n: float(f"{x:.3g}") for n, x in needs.items()}),
              flush=True)

    for name, b, hq, hkv, sq, sk, d, causal, off in TIMED:
        q, k, v, dout = _inputs(torch, gen, b, hq, hkv, sq, sk, d)
        kw = dict(heads_q=hq, heads_kv=hkv, causal=causal, q_offset=off)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        run = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                             scale=d ** -0.5, **kw)
        run()
        ms = cs.time_ms(run, warmup=1, reps=5)
        each = cs.device_ms_each(run, reps=3, kernels=KERNELS)
        pairs = b * hq * cs.visible_pairs(sq, sk, causal, off)
        work = {"attn_bwd_dkdv": 4 * 2 * d * pairs,
                "attn_bwd_dq": 3 * 2 * d * pairs}
        rate = {k_: work[k_] / (each[k_] * 1e-3) / 1e12
                for k_ in work if each.get(k_)}
        gbs = (2 * q.numel() * 2 / (each["attn_bwd_delta"] * 1e-3) / 1e9
               if each.get("attn_bwd_delta") else None)
        print(name, "ms", round(ms, 4), "device ms",
              {k_: None if x is None else round(x, 4)
               for k_, x in each.items()},
              "TFLOP/s", {k_: round(x, 1) for k_, x in rate.items()},
              "delta GB/s", gbs and round(gbs, 1), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
