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

A mesh server also installs its :class:`ModelSplit`: the ``model`` axis
along which the layers split heads, ``d_ff``, experts and the vocabulary
(``distributed/tp.py``).  With no split installed every rank holds every
column, and the layers run as on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

_HOOK: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None
_ROWS: Optional["RowSplit"] = None
_MODEL: Optional["ModelSplit"] = None


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


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """The ``model`` axis of a mesh: ``group`` is its process group, this
    rank is ``index`` of ``count`` along it.  ``kv_seq``: the decode
    caches' positions lie in ``count`` blocks along it (the rules'
    fallback where the kv heads do not divide it,
    ``sharding.make_cache_shardings``) — set by the decode step, which
    sees the caches' placements."""

    group: Any
    index: int
    count: int
    kv_seq: bool = False


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


def model_split() -> Optional[ModelSplit]:
    """The split installed by :func:`model_shards`, or ``None``: this rank
    holds every column and computes every head."""
    return _MODEL


@contextlib.contextmanager
def model_shards(split: Optional[ModelSplit]):
    global _MODEL
    prev = _MODEL
    _MODEL = split
    try:
        yield
    finally:
        _MODEL = prev
