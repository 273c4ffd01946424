"""Cells of the benchmark cut to a size a CPU test can run: the same
files, each width and length shrunk, the limits as committed.  The
program runs in float32 by default: at this width a bf16 rounding that
moves one of a token's two expert choices moves its output by half."""
from __future__ import annotations

import dataclasses

from perfbench.lib import cells

SMOKE_CONFIG = {"num_layers": 2, "d_model": 64, "vocab_size": 250,
                "loss_chunk": 16}
SMOKE_MOE = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 32}


def smoke_cell(name: str, dtype: str = "float32",
               layers: int = 2) -> cells.Cell:
    cell = cells.load_cell(name)
    cfg = dict(cell.config, dtype=dtype, **dict(SMOKE_CONFIG,
                                                num_layers=layers))
    if cfg["family"] == "moe":
        cfg.update(SMOKE_MOE, moe=dict(cfg["moe"], num_experts=8, top_k=2))
    else:
        cfg["ssm"] = dict(cfg["ssm"], state_dim=16, head_dim=16, chunk=8)
    traffic = dict(cell.traffic, rows=4, seq=32)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)
