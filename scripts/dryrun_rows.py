"""One row a dry-run cell: what a device of the production mesh computes,
holds and moves, for the cells where the attention's head split matters.

Each cell runs ``repro_torch.launch.dryrun.run_cell`` in its own
process (its fake process group is process-global) on the ``src/`` of
``--root`` (default: this checkout), so that two trees can be set side
by side.  The numbers are modeled for an H100 SXM from its data sheet
(``launch/roofline.py``), for rank ``--rank`` (default 0) of the 16 × 16
mesh, or of ``--mesh-shape`` (``REPRO_MESH_SHAPE``); no card is needed.

    PYTHONPATH=src python scripts/dryrun_rows.py                # every cell
    python scripts/dryrun_rows.py --root ../parent --cells llama3.2-1b:prefill_32k
    python scripts/dryrun_rows.py --json rows.json --jobs 3
    python scripts/dryrun_rows.py --cells granite-moe-1b-a400m:prefill_32k \
        --rank 255
    python scripts/dryrun_rows.py --cells seamless-m4t-medium:decode_32k \
        --mesh-shape 4,2

Prints a Markdown table and, with ``--json``, writes every row.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

#: the configs whose query heads divide ``model`` = 16 and whose kv heads
#: do not, at the shapes that attend
CELLS = tuple(f"{arch}:{shape}" for arch in (
    "llama3.2-1b", "yi-9b", "nemotron-4-15b", "jamba-1.5-large-398b",
    "qwen2-vl-72b") for shape in ("prefill_32k", "train_4k", "decode_32k"))

_CELL = """
import json, sys, tempfile
from repro_torch.launch import dryrun
rec = dryrun.run_cell({arch!r}, {shape!r}, "single", tempfile.mkdtemp(),
                      rank={rank})
print(json.dumps(rec))
"""


def run_cell(root: str, cell: str, rank: int = 0,
             mesh_shape: str | None = None) -> dict:
    """``run_cell``'s record of ``cell`` (``arch:shape``) on ``root``'s
    tree for ``rank`` of the mesh (``mesh_shape``: ``REPRO_MESH_SHAPE``),
    in a subprocess."""
    arch, shape = cell.split(":")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    if mesh_shape:
        env["REPRO_MESH_SHAPE"] = mesh_shape
    r = subprocess.run([sys.executable, "-c",
                        _CELL.format(arch=arch, shape=shape, rank=rank)],
                       env=env, capture_output=True, text=True, cwd=root)
    if r.returncode:
        return {"arch": arch, "shape": shape, "ok": False,
                "error": r.stderr[-2000:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def row(rec: dict) -> dict:
    """The numbers a row shows, from a cell's record."""
    if not rec.get("ok") or rec.get("skipped", True):
        return {"cell": f"{rec['arch']} {rec['shape']}",
                "error": rec.get("error") or rec.get("reason")}
    calls = rec["kernel_calls"]
    attn = calls.get("flash_attention", {})
    bwd = calls.get("flash_attention_bwd", {})
    model = rec["collective_by_axis"].get("model", {}).get("bytes", 0.0)
    return {
        "cell": f"{rec['arch']} {rec['shape']}",
        "mesh": rec["mesh_shape"],
        "flops": rec["hlo_flops_per_device"],
        "bytes": rec["hlo_bytes_per_device"],
        "argument_bytes": rec["memory_analysis"]["argument_size_in_bytes"],
        "model_flops_per_chip": rec["model_flops_per_chip"],
        "ratio": rec["hlo_flops_per_device"] / rec["model_flops_per_chip"],
        "b2_flops": attn.get("flops", 0.0),
        "b2_launches": attn.get("launches", 0),
        "b2p_flops": bwd.get("flops", 0.0),
        "peak_gb": rec["peak_bytes_per_device"] / 1e9,
        "collectives": rec["collective_counts"],
        "model_axis_mb": model / 1e6,
        "collective_mb": rec["collective_bytes_per_device"] / 1e6,
        "dominant": rec["dominant"],
        "bound_s": rec["bound_s"],
    }


def table(rows: list) -> str:
    out = ["| cell | FLOPs a device (× model) | B2 FLOPs (launches) | B2′ FLOPs "
           "| bytes | argument bytes | peak GB | collectives "
           "| `model` MB / all MB | bound s (by) |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in rows:
        if "error" in r:
            out.append(f"| {r['cell']} | failed: {r['error']!r} |"
                       + " |" * 8)
            continue
        coll = ", ".join(f"{n} {k}" for k, n in sorted(
            r["collectives"].items()))
        out.append(
            f"| {r['cell']} | {r['flops']:.4g} ({r['ratio']:.2f}×) "
            f"| {r['b2_flops']:.4g} ({r['b2_launches']}) "
            f"| {r['b2p_flops']:.4g} | {r['bytes']:.0f} "
            f"| {r['argument_bytes']} | {r['peak_gb']:.4g} | {coll} "
            f"| {r['model_axis_mb']:.4g} / {r['collective_mb']:.4g} "
            f"| {r['bound_s']:.4g} ({r['dominant'].removesuffix('_s')}) |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose src/ runs")
    ap.add_argument("--cells", nargs="*", default=list(CELLS),
                    help="arch:shape, e.g. llama3.2-1b:prefill_32k")
    ap.add_argument("--jobs", type=int, default=2,
                    help="cells at once (each takes a few GB of host memory)")
    ap.add_argument("--json", default=None, help="write every row here")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model, e.g. 4,2 (default: 16 × 16)")
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(args.jobs) as pool:
        recs = list(pool.map(lambda c: run_cell(
            args.root, c, args.rank, args.mesh_shape), args.cells))
    rows = [row(r) for r in recs]
    print(table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return int(any("error" in r for r in rows))


if __name__ == "__main__":
    sys.exit(main())
