"""``glue_share.train`` of a mixture-of-experts cell, reported beside its
own throughput metric, ``train_tokens_per_s.moe``."""
from perfbench.lib import trace


def read(summary, cell):
    return trace.glue_share(summary, "train")
