"""Quickstart on the PyTorch/CUDA port: the public API end to end —
build → compile → report → emit → run → save.

The same front door as ``examples/quickstart.py``, through
``repro_torch`` (re-exported at the package top level):

  1. Declare a CNN with the layer-builder frontend (``Sequential`` /
     ``Conv2D`` / ``ReLU`` / ``Residual`` / ``AvgPool``) — shapes are
     inferred and validated.
  2. Compile it under one validated ``CompileOptions`` bundle — pass
     pipeline → streaming transform → ILP DSE → cycle-balanced layer
     groups, all behind ``compile_graph``.
  3. Read the ``CompiledArtifact.report()`` table
     (cycles / BRAM / DSP / spills per group).
  4. ``emit_hls`` the Vitis-style C++ kernels + host schedule.
  5. ``run`` the same schedule on the device — on the CUDA card every
     conv is a launch of the streaming-conv kernel
     (``kernels/csrc/conv2d_stream.cu``) — and check it bit for bit
     against the DFG interpreter run on the CPU.
  6. ``save``/``load`` the artifact — the benchmark-cache hook.

Run:  PYTHONPATH=src python examples/quickstart_torch.py               # the CUDA card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

``--outdir DIR`` keeps the emitted HLS and the saved artifact in ``DIR``
(default: a temporary directory, removed at the end).
"""
import argparse
import os
import tempfile
from typing import Optional

import numpy as np

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.passes import interp


def build_net() -> "repro_torch.Sequential":
    return repro_torch.Sequential(
        [
            repro_torch.Conv2D(16),
            repro_torch.ReLU(),
            repro_torch.Residual([repro_torch.Conv2D(16), repro_torch.ReLU(),
                                  repro_torch.Conv2D(16)]),
            repro_torch.ReLU(),
            repro_torch.AvgPool(2),
        ],
        input_shape=(1, 32, 32, 16),
        name="quickstart_net",
    )


OPTIONS = dict(target="kv260", strategy="balanced")


def quickstart(outdir: str, device) -> dict:
    """Steps 1-6 into ``outdir`` on ``device``; returns what they made:
    ``art``, ``env`` (the CPU tensors the run was given), ``got`` (the
    run's output), ``want`` (the interpreter's), ``paths`` (the emitted
    files) and ``saved``."""
    # 1. build ---------------------------------------------------------------
    net = build_net()
    dfg = net.build()
    print(f"built {dfg.name!r}: {len(dfg.nodes)} nodes, "
          f"{len(dfg.intermediate_values())} intermediate tensor(s)")

    # 2. compile -------------------------------------------------------------
    art = repro_torch.compile_graph(net, repro_torch.CompileOptions(**OPTIONS))

    # 3. report --------------------------------------------------------------
    print("\nreport:")
    print(art.report())

    # 4. emit HLS ------------------------------------------------------------
    paths = art.emit_hls(outdir)
    for path in paths:
        print(f"emitted {path} ({os.path.getsize(path)} bytes)")

    # 5. run on the device + oracle check (the interpreter on the CPU) -------
    env = interp.random_env(art.design.original, seed=0, device="cpu")
    (want,) = interp.graph_outputs(art.design.original, env,
                                   device="cpu").values()
    got = art.run({"x": env["x"]}, params=env, device=device, seed=0)
    np.testing.assert_array_equal(got, want.numpy())
    print(f"\nran OK: output {tuple(got.shape)} {got.dtype} on {device} — "
          "bit-exact with the DFG interpreter")

    # 6. save / load ---------------------------------------------------------
    saved = art.save(os.path.join(outdir, "quickstart.artifact"))
    again = repro_torch.CompiledArtifact.load(saved)
    assert again.report() == art.report()
    print(f"saved + reloaded {saved} — identical report")
    return {"art": art, "env": env, "got": got, "want": want.numpy(),
            "paths": paths, "saved": saved}


def main(argv=None, out: Optional[dict] = None) -> int:
    """``out``, when given, receives :func:`quickstart`'s results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--outdir", default=None,
                    help="keep the emitted files here (default: a "
                         "temporary directory, removed at the end)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # no card → raises here
    if args.outdir is not None:
        res = quickstart(args.outdir, device)
    else:
        with tempfile.TemporaryDirectory(prefix="quickstart_hls_") as d:
            res = quickstart(d, device)
    if out is not None:
        out.update(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
