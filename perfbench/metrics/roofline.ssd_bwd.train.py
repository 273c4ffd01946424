"""ssd_bwd's share of its roofline in the traced train window, in %: the
least time the window's calls of it need (each call's operations over
the peak or bytes over 3.35 TB/s, whichever is larger, at its shapes)
over its device time (lib/flops.py)."""
from perfbench.lib import flops


def read(summary, cell):
    share = flops.roofline(summary, cell.config, "ssd_bwd", "train")
    return None if share is None else share[0]
