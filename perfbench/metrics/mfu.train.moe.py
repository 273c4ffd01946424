"""``mfu.train`` of a mixture-of-experts cell, reported beside its own
throughput metric, ``train_tokens_per_s.moe``."""
from perfbench.lib import flops


def read(summary, cell):
    return flops.mfu(summary, cell.config, "train")
