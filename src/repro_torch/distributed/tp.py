"""Tensor-parallel serving along a mesh's ``model`` axis: the parameters
and caches as a rank computes with them, and the forward's collectives.

The reference's ``jit`` lets GSPMD split the compute along the
placements of ``make_param_shardings``.  The port splits it by hand:
:func:`local_shards` gathers each DTensor leaf along the data axes only,
so that a rank holds its ``model`` shard — heads, ``d_ff`` columns,
experts, vocabulary rows — as a plain tensor, and the layers compute on
it, joined by three collectives over the ``model`` group of the
installed ``ctx.ModelSplit``:

* :func:`sum_partial` — the sum of row-parallel partial outputs (the
  ``wo`` and ``wd`` products, the experts' combine, the embedding rows);
* :func:`gather` — a tensor split along ``model`` made whole (the
  vocabulary shards of the logits; the leaves of a layer every rank
  computes whole);
* :func:`combine_softmax` — the (max, sum, out) triples of a softmax
  taken in blocks of positions, one block a rank.

Which leaves lie on ``model`` is the rules' decision, and
:func:`split_along` makes it again from a dimension's global extent:
the installed split where the extent divides its count, else ``None``
(the rules replicate the leaf; every rank computes it whole).  No
function branches on the axis size: on one rank every collective runs
over a group of one and leaves the values as they are.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from . import ctx
from .ctx import ModelSplit, RowSplit

#: cache leaves whose dimension 3 is positions (k / v: (L, B, Hkv, S, hd))
KV_LEAVES = ("k", "v", "ck", "cv")


def split_along(n: int) -> Optional[ModelSplit]:
    """The installed split when an extent of ``n`` divides its count (the
    rules then put the dimension on ``model``), else ``None``."""
    split = ctx.model_split()
    if split is None or n % split.count:
        return None
    return split


def local_extent(n: int) -> int:
    """What this rank holds of a dimension of global extent ``n``."""
    split = split_along(n)
    return n if split is None else n // split.count


def vocab_rows(cfg) -> int:
    """Rows of the embedding and columns of the head: the padded
    vocabulary of a decoder-only LM, the vocabulary of the
    encoder–decoder."""
    return cfg.vocab_size if cfg.family == "encdec" else cfg.padded_vocab


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------


def local_shards(params: Any, mesh) -> Any:
    """Each DTensor leaf of ``params`` (a ``QTensor``'s ``q`` and
    ``scale`` too) gathered along the data axes only — every mesh axis
    but ``model`` — as a plain tensor holding this rank's ``model``
    shard; other leaves as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    from .sharding import _map_with_path

    def one(_, x):
        if not isinstance(x, DTensor):
            return x
        keep = [p if name == "model" else Replicate()
                for name, p in zip(mesh.axis_names, x.placements)]
        return x.redistribute(x.device_mesh, keep).to_local()

    return _map_with_path(one, params)


def to_local(tree: Any) -> Any:
    """The local tensors of a tree of DTensors (aliases: writing them
    writes the DTensors); plain tensors as they are."""
    from torch.distributed.tensor import DTensor

    from .sharding import _map_with_path

    return _map_with_path(
        lambda _, x: x.to_local() if isinstance(x, DTensor) else x, tree)


def positions_on_model(cache: Any, mesh) -> bool:
    """Whether the attention caches of ``cache`` (DTensors placed by
    ``make_cache_shardings``) hold their positions in blocks along
    ``model``; raises if the leaves disagree."""
    from torch.distributed.tensor import DTensor, Shard

    from .sharding import _leaves_with_path

    axis = mesh.axis_names.index("model")
    seen = {isinstance(x, DTensor) and x.placements[axis] == Shard(3)
            for keys, x in _leaves_with_path(cache)
            if keys[-1] in KV_LEAVES and x.ndim == 5}
    if len(seen) > 1:
        raise ValueError("attention caches split along model in two ways")
    return seen == {True}


def _block(shape: tuple, spec: tuple, mesh) -> tuple:
    """(local shape, offset of the local block) of a leaf of ``shape``
    placed by ``spec`` on ``mesh``, for this rank: a dimension over an
    axis group is cut into one block a rank, row-major over the group."""
    coord = mesh.coordinate()
    local, offset = list(shape), [0] * len(shape)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        index, count = 0, 1
        for a in names:
            index, count = index * mesh.shape[a] + coord[a], \
                count * mesh.shape[a]
        local[d] = shape[d] // count
        offset[d] = index * local[d]
    return tuple(local), tuple(offset)


def cache_from_prefill(prefill: Any, shapes: Any, shardings: Any,
                       mesh) -> Any:
    """The bounded decode cache as DTensors placed by ``shardings``
    (``make_cache_shardings`` of ``shapes``, the zeroed cache on
    ``meta``), filled from ``prefill``, the tight caches a mesh prefill
    step returns.  Those hold this rank's rows and, under a head split,
    its heads; along the rest they hold every index — an attention
    cache's ``plen`` positions, the Mamba leaves' columns, which the
    mixer computes whole — and the rank takes its block there: positions
    ``[offset, offset + S/count)`` of the zero-padded prompt, the
    columns of its ``model`` shard."""
    from torch.distributed.tensor import DTensor

    from .sharding import _leaves_with_path, _map_with_path

    by_path = dict(_leaves_with_path(shardings))
    src_at = dict(_leaves_with_path(prefill))

    def one(keys, meta):
        sh, src = by_path[keys], src_at[keys]
        spec = tuple(sh.spec) + (None,) * (meta.ndim - len(sh.spec))
        local, offset = _block(tuple(meta.shape), spec, mesh)
        positional = keys[-1] in KV_LEAVES and meta.ndim == 5
        for d, axes in enumerate(spec):
            on_model = axes == "model" or (
                isinstance(axes, tuple) and "model" in axes)
            if (d == 3) if positional else on_model:
                start = min(offset[d], src.shape[d])
                src = src.narrow(d, start,
                                 min(local[d], src.shape[d] - start))
        if any(s > n for s, n in zip(src.shape, local)) or any(
                s != n for d, (s, n) in enumerate(zip(src.shape, local))
                if not (positional and d == 3)):
            raise ValueError(f"{'/'.join(keys)}: a prefill leaf of "
                             f"{tuple(src.shape)} for a local block of "
                             f"{local}")
        dst = torch.zeros(local, dtype=meta.dtype, device=src.device)
        dst[tuple(slice(0, s) for s in src.shape)] = src
        return DTensor.from_local(dst, mesh.device_mesh, sh.placements(),
                                  run_check=False, shape=meta.shape,
                                  stride=meta.stride())

    return _map_with_path(one, shapes)


# ---------------------------------------------------------------------------
# the forward's collectives
# ---------------------------------------------------------------------------


def sum_partial(t: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The sum over ``split``'s group of each rank's partial ``t``, taken
    in f32 and rounded once to ``t``'s dtype (an f32 ``t`` is summed in
    place); ``t`` itself with no split."""
    if split is None:
        return t
    acc = t.float()
    dist.all_reduce(acc, group=split.group)
    return acc.to(t.dtype)


def gather(t: torch.Tensor, dim: int,
           split: Optional[ModelSplit]) -> torch.Tensor:
    """``t``'s blocks along ``dim`` over ``split``'s group, in rank
    order, joined; ``t`` itself with no split."""
    if split is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(split.count)]
    dist.all_gather(parts, t, group=split.group)
    return torch.cat(parts, dim=dim)


def own_block(t: torch.Tensor, dim: int,
              split: Optional[ModelSplit]) -> torch.Tensor:
    """This rank's block of a whole ``t`` along ``dim`` (a view); ``t``
    itself with no split."""
    if split is None:
        return t
    size = t.shape[dim] // split.count
    return t.narrow(dim, split.index * size, size)


def combine_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    split: ModelSplit) -> torch.Tensor:
    """softmax · V from its blocks: each rank's running max ``m`` (...),
    sum ``l`` (...) of ``exp(s − m)`` and unnormalised ``o`` (..., D),
    all f32, rescaled to the group's max and summed → (..., D) f32.  A
    rank that saw no position holds ``m`` = -1e30, ``l`` = 0, ``o`` = 0
    and adds nothing."""
    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=split.group)
    scale = torch.exp(m - top)
    l = sum_partial(l * scale, split)
    o = sum_partial(o * scale[..., None], split)
    return o / l[..., None]


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                split: ModelSplit) -> torch.Tensor:
    """Rows ``ids`` of a vocabulary-parallel embedding: this rank holds
    rows ``[index·n, (index+1)·n)`` of the table (``table``, n rows);
    ids outside them give zeros, and the rows are summed over the
    group."""
    n = table.shape[0]
    local = ids - split.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return sum_partial(torch.where(inside[..., None], rows,
                                   rows.new_zeros(())), split)


def gather_rows(t: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """A batch-major ``t`` of this rank's rows made the global batch's:
    the blocks of ``split``'s group in rank order, the first
    ``split.count`` of them (one, when every rank holds every row)."""
    t = t.contiguous()
    size = dist.get_world_size(split.group)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=split.group)
    return torch.cat(parts[:split.count], dim=0)
