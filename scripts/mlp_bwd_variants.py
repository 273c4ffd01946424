"""Time variants of the fused MLP backward's wgmma route on the card.

Each variant is ``csrc/fused_mlp_bwd.cu`` with some of its tile and stage
constants rewritten, built beside the package's own library under
``build/mlp_bwd_variants/<name>/`` (one ``nvcc`` each, all at once) and
launched through the package's C interface at llama3.2-1b's train
microbatch (M 16384, D 2048, F 8192, gated, silu, bf16).  Every variant
must give the same bits as the package's library — the tiles change which
block owns an output, never the order of its sums — and each kernel's
device ms comes from the profiler (``chip_smoke.device_ms_each``).
``PROBES`` switch parts of the hidden kernel off to show where its time
goes (their bits differ by design); ``a+b`` applies both edit sets.

    python3 scripts/mlp_bwd_variants.py            # on a machine with a card
    python3 scripts/mlp_bwd_variants.py wait1      # the package and one variant
    python3 scripts/mlp_bwd_variants.py probe_hidden_no_epilogue \
        probe_hidden_loads_only probe_hidden_no_loads   # where its time goes

Writes ``chiprun_out/mlp_bwd_variants.json`` and prints one line a variant.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: name → {the source's text: its replacement}
VARIANTS = {
    # the hidden kernel with 3 slots; at 128 x 128 with 32-deep chunks
    # (64-byte swizzle, 5 slots) or 64-deep ones (2 slots fit)
    "hidden_stages3": {"constexpr int H_STAGES = 4;":
                       "constexpr int H_STAGES = 3;"},
    "hidden_n128_k32_s5": {"constexpr int HWM = 128, HWN = 64;":
                           "constexpr int HWM = 128, HWN = 128;",
                           "constexpr int HBK = 64;":
                           "constexpr int HBK = 32;",
                           "constexpr int H_STAGES = 4;":
                           "constexpr int H_STAGES = 5;"},
    "hidden_n128_k64_s2": {"constexpr int HWM = 128, HWN = 64;":
                           "constexpr int HWM = 128, HWN = 128;",
                           "constexpr int H_STAGES = 4;":
                           "constexpr int H_STAGES = 2;"},
    "gemm_stages2": {"constexpr int G_STAGES = 3;":
                     "constexpr int G_STAGES = 2;"},
    # one committed group left in flight: a chunk's slot released once the
    # next chunk's products are issued
    "wait1": {"""    wg::wgmma_wait<0>();
    wg::fence_regs(au);
    wg::fence_regs(ag);
    wg::fence_regs(ad);
    release_slot<H_STAGES>(empty, c);
  }""": """    wg::wgmma_wait<1>();
    wg::fence_regs(au);
    wg::fence_regs(ag);
    wg::fence_regs(ad);
    if (c > 0) release_slot<H_STAGES>(empty, c - 1);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(au);
  wg::fence_regs(ag);
  wg::fence_regs(ad);""",
              """    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    release_slot<G_STAGES>(empty, c);
  }""": """    wg::wgmma_wait<1>();
    wg::fence_regs(acc);
    if (c > 0) release_slot<G_STAGES>(empty, c - 1);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);"""},
}
#: timing probes of the hidden kernel — parts of it switched off by a
#: condition that never holds at run time, so the rest compiles as it is —
#: and changes of its arithmetic: their bits differ from the package's by
#: design (each row carries its need of the bf16 rule, as
#: ``chip_smoke.mlp_bwd_check`` takes it)
PROBES = {
    # the mainloop alone: no activation, no planes staged or stored
    "probe_hidden_no_epilogue": {
        "\n  // h, du, dg as hi and lo planes, staged":
        "\n  if (p.M > 0) return;\n  // h, du, dg as hi and lo planes, staged"},
    # the TMA ring alone: no products
    "probe_hidden_loads_only": {
        "    for (int kk = 0; kk < HBK / 16; ++kk) {":
        "    for (int kk = 0; kk < HBK / 16 * (p.M < 0); ++kk) {"},
    # the epilogue without its TMA stores of the planes
    "probe_hidden_no_store": {
        "        wg::tma_store_3d(T.planes,":
        "        if (p.M < 0) wg::tma_store_3d(T.planes,"},
    # the epilogue without the activation and its derivative
    "probe_hidden_no_math": {
        "        hidden_of(p, ag[4 * j":
        "        if (p.M < 0) hidden_of(p, ag[4 * j"},
    # the sigmoid of silu by the fast intrinsics (≈ 2 ulp) instead of expf
    # and a correctly rounded division
    "sigmoid_fast": {"  return 1.f / (1.f + expf(-v));":
                     "  return __fdividef(1.f, 1.f + __expf(-v));"},
    "sigmoid_rcp": {"  return 1.f / (1.f + expf(-v));":
                    "  return __frcp_rn(1.f + __expf(-v));"},
    # the products alone: every slot marked full without a load
    "probe_hidden_no_loads": {
        "        wg::mbar_expect_tx(bar, bytes);\n        wg::tma_load_2d(st, T.x,":
        "        wg::mbar_arrive(bar);\n        if (p.M < 0) {\n"
        "        wg::tma_load_2d(st, T.x,",
        "        wg::tma_load_2d(st + 2 * H_X + 2 * H_W, T.wd, bar, k0, f0);\n":
        "        wg::tma_load_2d(st + 2 * H_X + 2 * H_W, T.wd, bar, k0, f0);\n"
        "        }\n"},
}
M, D, F = 16384, 2048, 8192


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as fm

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs = {"package": fm.BWD_LIBRARY}
    src = (build.CSRC / "fused_mlp_bwd.cu").read_text()
    edits_of = {**VARIANTS, **PROBES}
    chosen = sys.argv[1:] or list(VARIANTS)
    for name in chosen:
        # "a+b": the edits of a, then those of b
        edits = [e for part in name.split("+")
                 for e in edits_of[part].items()]
        out = build.build_dir() / "mlp_bwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        # each edit applies to the one file of the source and its headers
        # that holds its text, once
        files = {"fused_mlp_bwd.cu": src,
                 **{h.name: h.read_text() for h in build.CSRC.glob("*.cuh")}}
        for old, new in edits:
            holders = [f for f, t in files.items() if t.count(old) == 1]
            if len(holders) != 1 or sum(t.count(old)
                                        for t in files.values()) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in the source")
            files[holders[0]] = files[holders[0]].replace(old, new)
        for f, text in files.items():
            (out / f).write_text(text)
        libs[name] = build.CudaLibrary(f"fused_mlp_bwd_{name}",
                                       fm._declare_bwd,
                                       source=out / "fused_mlp_bwd.cu")
    build.build_libraries(list(libs.values()), verbose=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(M, D, device="cuda", generator=g).bfloat16()
    wg, wu = ((torch.randn(D, F, device="cuda", generator=g) * D ** -0.5)
              .bfloat16() for _ in range(2))
    wd = (torch.randn(F, D, device="cuda", generator=g) * F ** -0.5).bfloat16()
    dy = torch.randn(M, D, device="cuda", generator=g).bfloat16()
    plan = fm.bwd_plan(x, wg, wu, wd, dy)
    assert plan.route == "wgmma", plan
    hidden = torch.empty(plan.hidden_bytes, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    mdf = M * D * F
    work = {"mlp_bwd_hidden": 6 * mdf, "mlp_bwd_wgrad": 12 * mdf,
            "mlp_bwd_dx": 8 * mdf}
    want = fm.fused_mlp_bwd_plain(x, wg, wu, wd, dy, act="silu")
    rows, base = {}, None
    for name, lib in libs.items():
        handle = lib.load()
        outs = [torch.empty_like(t) for t in (x, wg, wu, wd)]

        def run():
            rc = handle.fused_mlp_bwd_launch(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                dy.data_ptr(), *(t.data_ptr() for t in outs),
                hidden.data_ptr(), 1, fm.BWD_ROUTE_CODES["wgmma"], M, D, F,
                fm.ACT_CODES["silu"], 1, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        run()
        torch.cuda.synchronize()
        got = [t.clone() for t in outs]
        if base is None:
            base = got
        same = all(torch.equal(a, b) for a, b in zip(got, base))
        each = cs.device_ms_each(run, reps=3, kernels=cs.MLP_BWD_KERNELS)
        rows[name] = {
            "same_bits_as_package": same,
            "need": max(cs._mlp_bwd_need(g, w, "bfloat16")
                        for g, w in zip(got, want)),
            "ms": cs.time_ms(run, warmup=1, reps=5),
            "device_ms_each": each,
            "tflops_each": {k: work[k] / (each[k] * 1e-3) / 1e12
                            for k in work if each.get(k)},
            "ptxas": [r for r in cs.ptxas_report(lib.build_log)
                      if "wgmma" in r["kernel"]],
            # ptxas' C7515: wgmma serialised in a kernel
            "serialised": lib.build_log.count("C7515"),
        }
        print(name, json.dumps({k: rows[name][k] for k in
                                ("same_bits_as_package", "need", "ms",
                                 "tflops_each", "serialised")}), flush=True)
        probe = any(part in PROBES for part in name.split("+"))
        rows[name]["probe"] = probe
        if not same and not probe:
            print(f"{name}: bits differ from the package's", file=sys.stderr)
    doc = {"device": smi, "shape": {"M": M, "D": D, "F": F},
           "variants": {k: [edits_of[part] for part in k.split("+")]
                        for k in chosen}, "rows": rows}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mlp_bwd_variants.json").write_text(json.dumps(doc, indent=1))
    print(smi)
    return 0 if all(r["same_bits_as_package"] or r.get("probe")
                    for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
