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

A mesh server and the mesh train step also install their
:class:`ModelSplit`: the ``model`` axis along which the layers split
heads, ``d_ff``, experts and the vocabulary (``distributed/tp.py``).
With no split installed every rank holds every column, and the layers
run as on one device.

The mesh train step and the mesh serve steps install their
:class:`ParamGather` too: which leaves of the params they hand the model
are this rank's block along the data axes, and along which dimension.
The model gathers a superblock's leaves when it runs
(``tp.gather_data``), as the reference's ``lax.scan`` over superblocks
lets GSPMD gather them inside the loop body: a rank holds one
superblock's gathered leaves at a time.  With none installed every leaf
is whole along those axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

_HOOK: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None
_ROWS: Optional["RowSplit"] = None
_MODEL: Optional["ModelSplit"] = None
_GATHER: Optional["ParamGather"] = None


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


@dataclasses.dataclass(frozen=True)
class ParamGather:
    """The params of a mesh step (train, prefill or decode) as this rank
    holds them along the data axes (``pod`` × ``data``): ``dims`` maps a
    leaf's path in the params tree (a tuple of keys; a ``QTensor``'s
    ``q`` and ``scale`` are leaves of their own) to the dimension that
    those axes shard — in the leaf's stacked layout — over ``group``,
    ``count`` ranks whose group rank is the block index; a leaf not in it
    is whole along them.  ``dequantize``: the dtype each ``QTensor`` is
    dequantized to right after its gather, so that no layer sees one
    (the serve steps: ``cfg.param_dtype``); ``None``: none is (the train
    step)."""

    group: Any
    count: int
    dims: dict
    dequantize: Optional[torch.dtype] = None


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


def param_gather() -> Optional[ParamGather]:
    """The plan installed by :func:`gathering_params`, or ``None``: every
    leaf the model sees is whole along the data axes."""
    return _GATHER


@contextlib.contextmanager
def gathering_params(plan: Optional[ParamGather]):
    global _GATHER
    prev = _GATHER
    _GATHER = plan
    try:
        yield
    finally:
        _GATHER = prev
