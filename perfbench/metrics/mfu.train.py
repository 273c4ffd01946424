"""The traced train window's model FLOPs over its seconds at 989 TFLOP/s, in % (lib/flops.py)."""
from perfbench.lib import flops


def read(summary, cell):
    return flops.mfu(summary, cell.config, "train")
