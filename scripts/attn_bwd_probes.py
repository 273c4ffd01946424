"""Timing probes of the attention backward's ``"wgmma"`` kernels (B2′).

Copies the package under ``build/probe_<name>/`` with one part of
``csrc/flash_attention_bwd.cu`` switched off — the results are wrong, the
time is what is read — and times each copy in turns with the package
itself through ``scripts/attn_bwd_quick.py --no-check`` (one process
each: package, every probe, package):

  noexp   P taken as its exponent: no exp2 on the special-function unit
  nocvt   P and dS passed to the products as raw f32 bits: no bf16 packing

    python3 scripts/attn_bwd_probes.py [noexp nocvt]   # on a machine with a card
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CU = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
HEADER = "src/repro_torch/kernels/csrc/wgmma_bf16.cuh"

#: probe → [(file, text, replacement)], each text present in the source
PROBES = {
    "noexp": [(CU, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = x;")],
    "nocvt": [(HEADER, f"a[{i}] = bf16x2(d[8 * i{f' + {2 * i}' if i else ''}]"
               f", d[8 * i + {2 * i + 1}]);",
               f"a[{i}] = __float_as_uint(d[8 * i{f' + {2 * i}' if i else ''}]);")
              for i in range(4)],
}


def make_copy(name: str) -> pathlib.Path:
    """build/probe_<name>: the package and chip_smoke.py with the probe's
    replacements made (each must be found)."""
    dst = ROOT / "build" / f"probe_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dst / "src")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for rel, old, new in PROBES[name]:
        path = dst / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {rel}")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    names = sys.argv[1:] or list(PROBES)
    roots = [ROOT] + [make_copy(n) for n in names] + [ROOT]
    quick = str(ROOT / "scripts" / "attn_bwd_quick.py")
    rc = 0
    for root in roots:
        rc |= subprocess.run([sys.executable, quick, "--root", str(root),
                              "--no-check"], timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
