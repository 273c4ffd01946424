"""The H100's roofline for the dry-run, in one place: the card's
data-sheet peaks, its memory and links, and the work of each hand-written
kernel (kept beside the kernels, ``kernels/work.py``, and read from here).

Every number here is **modeled for an H100 SXM (data sheet)**, none is a
measurement.  The dry-run (``launch/dryrun.py``) divides a step's counts
by these rates into ``compute_s``, ``memory_s`` and ``collective_s``;
``chip_smoke.py``'s bound rows read the same kernel work.
"""
from __future__ import annotations

from repro_torch.kernels.work import (  # noqa: F401  (one count, re-read)
    CUDA_CORE_INT32_OPS_PER_S,
    CUDA_CORE_OPS_PER_S,
    HBM_BYTES_PER_S,
    SSD_WORK_TILE,
    TENSOR_CORE_BF16_OPS_PER_S,
    Work,
    attention_bwd_work,
    attention_work,
    conv_work,
    mlp_bwd_mma_work,
    mlp_bwd_work,
    mlp_work,
    peak_rate,
    ssd_bwd_design_bytes,
    ssd_bwd_flops,
    ssd_bwd_work,
    ssd_flops,
    ssd_work,
    visible_pairs,
)

#: the words every output of the model carries
MODELED = "modeled for an H100 SXM (data sheet)"

#: device memory of one H100 SXM
DEVICE_MEMORY_BYTES = 80e9
#: NVLink 4 between the eight cards of one HGX node, each way
NVLINK_BYTES_PER_S = 450e9
#: one 400 Gb/s NDR InfiniBand port per card, between nodes
NETWORK_BYTES_PER_S = 400e9 / 8
#: cards of one node: a group within one block of this many consecutive
#: ranks talks over NVLink
NODE_RANKS = 8


def link_rate(ranks) -> float:
    """Bytes a second each way of a collective over ``ranks`` (global
    ranks): NVLink where they all lie in one node of :data:`NODE_RANKS`
    consecutive ranks, else the network."""
    nodes = {r // NODE_RANKS for r in ranks}
    return NVLINK_BYTES_PER_S if len(nodes) <= 1 else NETWORK_BYTES_PER_S
