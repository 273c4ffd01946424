"""The device's idle share of the traced train window, in %: 1 − busy / window, busy the union of the device operations' intervals."""
from perfbench.lib import trace


def read(summary, cell):
    return trace.idle_share(summary, "train")
