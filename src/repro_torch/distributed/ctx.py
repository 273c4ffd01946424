"""Activation-sharding context, in PyTorch: the port of the reference's
``distributed/ctx.py``.

Model code stays mesh-agnostic: it calls ``shard_activation(x, kind)``
at layer boundaries; the sharded train step installs a hook
(``sharding.activation_hook``).  With no hook installed it is the
identity.

Beside the hook the step installs its :class:`RowSplit`: how the rows of
the batch lie across the data-parallel ranks.  Compute runs on each
rank's own rows, so a layer that mixes rows — the MoE layer's capacity
and buffer positions, reckoned over the whole batch in the reference —
reads it to see the global batch (``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

_HOOK: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None
_ROWS: Optional["RowSplit"] = None


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The rows of one microbatch across the data-parallel ranks: this
    rank holds block ``index`` of ``count`` equal blocks, ``rows`` rows,
    in global row order; ``group`` is the process group of the ranks
    holding the blocks (its group rank is the block index)."""

    group: Any
    index: int
    count: int
    rows: int


def shard_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """kind ∈ {'hidden', 'tokens', 'logits', 'kv_cache', 'expert_buf'}."""
    if _HOOK is None:
        return x
    return _HOOK(x, kind)


@contextlib.contextmanager
def activation_sharding(hook: Optional[Callable]):
    global _HOOK
    prev = _HOOK
    _HOOK = hook
    try:
        yield
    finally:
        _HOOK = prev


def row_split() -> Optional[RowSplit]:
    """The split installed by :func:`data_rows`, or ``None``: every row of
    the batch is on this rank."""
    return _ROWS


@contextlib.contextmanager
def data_rows(split: Optional[RowSplit]):
    global _ROWS
    prev = _ROWS
    _ROWS = split
    try:
        yield
    finally:
        _ROWS = prev
