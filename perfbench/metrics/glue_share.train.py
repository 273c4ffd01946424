"""The share of the traced train window's device time in kernels neither hand-written nor cuBLAS, in %."""
from perfbench.lib import trace


def read(summary, cell):
    return trace.glue_share(summary, "train")
