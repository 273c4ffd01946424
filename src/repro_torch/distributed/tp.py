"""Tensor parallelism along a mesh's ``model`` axis, for serving and
training: the parameters and caches as a rank computes with them, and
the collectives that join the ranks' shards, each differentiable.

The reference's ``jit`` lets GSPMD split the compute along the
placements of ``make_param_shardings``.  The port splits it by hand.  A
rank holds its ``model`` shard of each leaf — heads, ``d_ff`` columns,
experts, vocabulary rows — as a plain tensor.  The mesh server and the
mesh train step alike gather the leaves along the data axes one
superblock at a time where the model uses them (:func:`gather_data`:
the superblock's leaves packed into one buffer, one all-gather, and in
the train step's backward one reduce-scatter), as the reference's
scanned ``jit`` does.  The layers compute on the shards, joined over the
``model`` group of the installed ``ctx.ModelSplit`` by:

* :func:`enter` — in front of a column-parallel product (``wq`` / ``wk``
  / ``wv``, ``wu`` / ``wg``, the experts, the vocabulary-parallel head),
  and on a whole leaf of which a rank computes only its share (``wk`` /
  ``wv`` where only the query heads split): the identity, whose backward
  sums the rank's partial gradient;
* :func:`sum_partial` — the sum of row-parallel partial outputs (the
  ``wo`` and ``wd`` products, the experts' combine, the embedding rows,
  the chunked CE's sums), whose backward passes the gradient on;
* :func:`gather` — a tensor split along ``model`` made whole (the
  vocabulary shards of the logits; a decode step's query heads; the
  leaves of a layer every rank computes whole), whose backward keeps
  this rank's block;
* :func:`gather_shared` — the same forward, for a tensor that every
  rank then uses in its own way (the Mamba mixer's ``B`` and ``C``,
  shared by every head): its backward sums every rank's gradient and
  keeps this rank's block (a reduce-scatter);
* :func:`sum_shared` — :func:`sum_partial`'s forward, for a sum that
  every rank uses in its own way (the Mamba gated norm's statistic over
  ``d_inner``): its backward sums the gradient over the group too;
* :func:`max_over` — the group's maximum (the chunked CE's softmax
  shift; no gradient);
* :func:`combine_softmax` — the (max, sum, out) triples of a softmax
  taken in blocks of positions, one block a rank (decode only: it
  refuses a gradient).

Which leaves lie on ``model`` is the rules' decision, and
:func:`split_along` makes it again from a dimension's global extent:
the installed split where the extent divides its count, else ``None``
(the rules replicate the leaf; every rank computes it whole).  No
function branches on the axis size: on one rank every collective runs
over a group of one and leaves the values as they are.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import ctx
from .ctx import ModelSplit, RowSplit

#: the data-axes gather's bytes alive now and the most alive at once
#: since :func:`reset_gathered`
_GATHERED = {"live": 0, "peak": 0}
#: guards ``_GATHERED``: a storage may die on the process group's worker
#: thread, which runs its finalizer there
_GATHERED_LOCK = threading.Lock()

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
    its heads — the Mamba mixer's conv columns and SSM heads too, in the
    mixer's column order (``sharding.column_order``) — and are kept as
    they are there.  Along the rest they hold every index — an attention
    cache's ``plen`` positions; the Mamba leaves' columns and heads where
    the mixer computes them whole (``mamba2._whole_leaves``) — and the
    rank takes its block: positions ``[offset, offset + S/count)`` of the
    zero-padded prompt, the columns of its ``model`` shard."""
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
            if (d == 3) if positional else (on_model
                                            and src.shape[d] != local[d]):
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


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in f32 (a copy; ``t`` is left as it
    is) and rounded once to its dtype."""
    acc = t.to(torch.float32, copy=True)
    dist.all_reduce(acc, group=group)
    return acc.to(t.dtype)


def _all_gather_cat(t: torch.Tensor, dim: int, group,
                    size: int) -> torch.Tensor:
    """The blocks ``t`` of the ``size`` ranks of ``group``, in rank order,
    joined along ``dim``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _SumPartial(torch.autograd.Function):
    """Forward: the f32 sum over the group.  Backward: the gradient as it
    is — every rank holds the whole gradient of the sum, which is each
    partial's."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Forward: the identity.  Backward: the f32 sum over the group of
    each rank's partial gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Forward: the blocks along ``dim`` over the group, joined.
    Backward: this rank's block of the gradient — every rank computes
    with the whole tensor, so each holds its whole gradient."""

    @staticmethod
    def forward(ctx, t, dim, split):
        ctx.dim, ctx.split = dim, split
        return _all_gather_cat(t, dim, split.group, split.count)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.dim, ctx.split), None, None


class _SumShared(torch.autograd.Function):
    """Forward: the f32 sum over the group.  Backward: the f32 sum over
    the group of the gradient — each rank uses the sum in its own way, so
    each holds only its share of the sum's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _GatherShared(torch.autograd.Function):
    """Forward: the blocks along ``dim`` over the group, joined.
    Backward: the f32 sum over the group of every rank's gradient of the
    whole, this rank's block kept (one reduce-scatter) — each rank uses
    the whole in its own way, so each holds a partial of its gradient."""

    @staticmethod
    def forward(ctx, t, dim, split):
        ctx.dim, ctx.split = dim, split
        return _all_gather_cat(t, dim, split.group, split.count)

    @staticmethod
    def backward(ctx, g):
        count, dim = ctx.split.count, ctx.dim % g.ndim
        parts = g.to(torch.float32).unflatten(dim, (count, -1)).movedim(
            dim, 0).contiguous()
        mine = parts.new_empty(parts[0].numel())
        dist.reduce_scatter_tensor(mine, parts.view(-1),
                                   group=ctx.split.group)
        return mine.view(parts.shape[1:]).to(g.dtype), None, None


def sum_partial(t: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The sum over ``split``'s group of each rank's partial ``t``, taken
    in f32 and rounded once to ``t``'s dtype; ``t`` itself with no split.
    Its gradient is the output's, passed to every partial."""
    if split is None:
        return t
    return _SumPartial.apply(t, split.group)


def enter(x: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """``x`` entering a column-parallel product over ``split``: the
    identity, whose gradient is the sum over the group of each rank's
    partial (a rank's columns give only their share of ``x``'s
    gradient); ``x`` itself with no split.  Only where ``x``'s gradient
    would be a partial: in front of a branch that every rank computes
    whole it would count that gradient ``count`` times."""
    if split is None:
        return x
    return _Enter.apply(x, split.group)


def gather(t: torch.Tensor, dim: int,
           split: Optional[ModelSplit]) -> torch.Tensor:
    """``t``'s blocks along ``dim`` over ``split``'s group, in rank
    order, joined; ``t`` itself with no split.  Its gradient is this
    rank's block of the output's."""
    if split is None:
        return t
    return _Gather.apply(t, dim, split)


def sum_shared(t: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """:func:`sum_partial`'s sum, for a sum that every rank then uses in
    its own way (a statistic over columns that the ranks share out): its
    gradient is the sum over the group of each rank's; ``t`` itself with
    no split."""
    if split is None:
        return t
    return _SumShared.apply(t, split.group)


def gather_shared(t: torch.Tensor, dim: int,
                  split: Optional[ModelSplit]) -> torch.Tensor:
    """:func:`gather`'s whole, for a tensor that every rank then uses in
    its own way (``B`` and ``C``, which every head of the Mamba mixer
    reads): its gradient is the sum over the group of every rank's, this
    rank's block kept; ``t`` itself with no split."""
    if split is None:
        return t
    return _GatherShared.apply(t, dim, split)


def mixer_split(cfg) -> Optional[ModelSplit]:
    """The installed split where the Mamba mixer of ``cfg`` computes this
    rank's heads (``sharding.mixer_splits``: it divides the heads and the
    state), else ``None``: the mixer's leaves are gathered along
    ``model`` and every rank computes every column."""
    from .sharding import mixer_splits

    split = ctx.model_split()
    if split is None or not mixer_splits(cfg, split.count):
        return None
    return split


def max_over(t: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``split``'s group (no
    gradient); ``t`` itself with no split."""
    if split is None:
        return t
    top = t.detach().clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=split.group)
    return top


def own_block(t: torch.Tensor, dim: int,
              split: Optional[ModelSplit]) -> torch.Tensor:
    """This rank's block of a whole ``t`` along ``dim`` (a view); ``t``
    itself with no split."""
    if split is None:
        return t
    size = t.shape[dim] // split.count
    return t.narrow(dim, split.index * size, size)


def kv_heads_read(t: torch.Tensor, heads_q: int, heads_kv: int,
                  split: ModelSplit) -> torch.Tensor:
    """The kv heads of ``t`` (B, ``heads_kv``, S, D) that this rank's
    query heads ``[index·n, (index+1)·n)`` read, n = ``heads_q``/count:
    query head h reads kv head h // G, G = ``heads_q``/``heads_kv``.
    Where the rank's heads lie in one kv head (G % n == 0) or cover
    whole groups (n % G == 0), a view of those kv heads, the GQA ratio
    kept; else one kv head a query head (ratio 1).  Its gradient lands
    in those heads of ``t``'s, zeros elsewhere."""
    n = heads_q // split.count
    group = heads_q // heads_kv
    first = split.index * n
    if group % n == 0 or n % group == 0:
        return t.narrow(1, first // group, max(n // group, 1))
    index = torch.arange(first, first + n, device=t.device) // group
    return t.index_select(1, index)


def combine_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    split: ModelSplit) -> torch.Tensor:
    """softmax · V from its blocks: each rank's running max ``m`` (...),
    sum ``l`` (...) of ``exp(s − m)`` and unnormalised ``o`` (..., D),
    all f32, rescaled to the group's max and summed → (..., D) f32.  A
    rank that saw no position holds ``m`` = -1e30, ``l`` = 0, ``o`` = 0
    and adds nothing.  Decode only: under autograd it raises rather than
    give a gradient it does not compute."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (m, l, o)):
        raise RuntimeError("combine_softmax has no backward: it combines "
                           "a decode step's blocks of positions")
    top = max_over(m, split)
    scale = torch.exp(m - top)
    l = sum_partial(l * scale, split)
    o = sum_partial(o * scale[..., None], split)
    return o / l[..., None]


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, split: ModelSplit,
                lookup) -> torch.Tensor:
    """Rows ``ids`` of a vocabulary-parallel embedding: this rank holds
    rows ``[index·n, (index+1)·n)`` of the table (``table``, n rows),
    read through ``lookup``; ids outside them give zeros, and the rows are
    summed over the group.  The table's gradient is this rank's rows."""
    n = table.shape[0]
    local = ids - split.index * n
    inside = (local >= 0) & (local < n)
    rows = lookup(table, local.clamp(0, n - 1))
    return sum_partial(torch.where(inside[..., None], rows,
                                   rows.new_zeros(())), split)


# ---------------------------------------------------------------------------
# the params along the data axes (the mesh steps)
# ---------------------------------------------------------------------------


#: a leaf's bytes in the data-axes gather's buffer start at a multiple of
#: this, so that each is a view of its dtype there
_ALIGN = 16


class _DataGather(torch.autograd.Function):
    """Forward: each leaf's blocks along its dimension over the data
    axes' group, joined — the leaves packed as bytes into one buffer, one
    all-gather for them all, each leaf counted live until its storage is
    freed (a leaf joined along its first dimension is a view of the
    gathered buffer, and any view of it, a cache's too, keeps that
    buffer and every such leaf of the superblock alive).  Under
    ``torch.inference_mode`` (the serve steps) the forward alone runs.
    Backward: one reduce-scatter, in f32, of all the leaves' whole
    gradients — each rank's rows' gradients summed over the group, this
    rank's blocks kept."""

    @staticmethod
    def forward(ctx, dims, group, count, *leaves):
        ctx.dims, ctx.group, ctx.count = dims, group, count
        ctx.shapes = [t.shape for t in leaves]
        ctx.dtypes = [t.dtype for t in leaves]
        sizes = [t.numel() * t.element_size() for t in leaves]
        starts = _starts(sizes, _ALIGN)
        buf = leaves[0].new_empty(starts[-1], dtype=torch.uint8)
        for t, o, n in zip(leaves, starts, sizes):
            buf[o:o + n].copy_(t.contiguous().view(-1).view(torch.uint8))
        whole = buf.new_empty(count, starts[-1])
        dist.all_gather_into_tensor(whole.view(-1), buf, group=group)
        out = []
        for t, d, o, n in zip(leaves, dims, starts, sizes):
            x = whole[:, o:o + n].view(t.dtype).view(count, *t.shape)
            x = x.movedim(0, d).reshape(_joined(t.shape, d, count))
            _count_live(x)
            out.append(x)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        count = ctx.count
        sizes = [s.numel() for s in ctx.shapes]
        starts = _starts(sizes, 1)
        buf = grads[0].new_empty(count, starts[-1], dtype=torch.float32)
        for g, shape, d, o, n in zip(grads, ctx.shapes, ctx.dims, starts,
                                     sizes):
            buf[:, o:o + n].view(count, *shape).copy_(
                g.unflatten(d, (count, shape[d])).movedim(d, 0))
        mine = buf.new_empty(starts[-1])
        dist.reduce_scatter_tensor(mine, buf.view(-1), group=ctx.group)
        return (None, None, None) + tuple(
            mine[o:o + n].view(shape).to(dtype)
            for shape, dtype, o, n in zip(ctx.shapes, ctx.dtypes, starts,
                                          sizes))


def _starts(sizes: list, align: int) -> list:
    """Where each of ``sizes`` starts in a buffer that packs them, each
    start a multiple of ``align``; the buffer's size last."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + -(-n // align) * align)
    return out


def _joined(shape: torch.Size, dim: int, count: int) -> tuple:
    return tuple(n * count if i == dim else n for i, n in enumerate(shape))


def _count_live(t: torch.Tensor) -> None:
    """Count ``t``'s bytes live until its storage dies: a view keeps the
    storage, where the tensor object itself may die before it."""
    n = t.numel() * t.element_size()
    with _GATHERED_LOCK:
        _GATHERED["live"] += n
        _GATHERED["peak"] = max(_GATHERED["peak"], _GATHERED["live"])
    weakref.finalize(t.untyped_storage(), _release, n)


def _release(n: int) -> None:
    with _GATHERED_LOCK:
        _GATHERED["live"] -= n


def gathered_bytes() -> dict:
    """``{"live", "peak"}``: the bytes of the data-axes gather's outputs
    alive now, and the most alive at once since :func:`reset_gathered`
    (a tensor counts until its storage is freed, whoever holds it or a
    view of it: a layer, a cache, or autograd for the backward).  The
    process group may hold a collective's output a moment after the call
    returns — gloo's worker thread drops its work, and with it the
    gathered buffer, only after it has woken the caller — so right after
    a step ``live`` may still count its last gather."""
    with _GATHERED_LOCK:
        return dict(_GATHERED)


def reset_gathered() -> None:
    """Start the peak of :func:`gathered_bytes` from what is alive now."""
    with _GATHERED_LOCK:
        _GATHERED["peak"] = _GATHERED["live"]


def gather_data(tree: Any, path: tuple, *, layer: bool = False) -> Any:
    """``tree`` — the params' subtree at ``path``, or the leaf there —
    with each leaf that the installed ``ctx.ParamGather`` names gathered
    along the data axes, all in one collective (differentiable: their
    gradients are reduce-scattered back to this rank's blocks, again in
    one), and where the plan says so each ``QTensor`` then dequantized
    (its ``q`` and ``scale`` gathered in that same collective); ``tree``
    itself with none installed.  ``layer``: the leaves are one layer of
    stacked leaves (the layer axis taken off, so each dimension is one
    less)."""
    plan = ctx.param_gather()
    if plan is None:
        return tree
    from .sharding import _leaves_with_path, _map_with_path

    picked = [(keys, t, plan.dims[path + keys] - int(layer))
              for keys, t in _leaves_with_path(tree)
              if path + keys in plan.dims]
    if picked:
        keys, leaves, dims = zip(*picked)
        whole = dict(zip(keys, _DataGather.apply(dims, plan.group,
                                                 plan.count, *leaves)))
        tree = _map_with_path(lambda k, t: whole.get(k, t), tree)
    if plan.dequantize is None:
        return tree
    from repro_torch.quant.ptq import dequantize_params

    return dequantize_params(tree, plan.dequantize)


def gather_rows(t: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """A batch-major ``t`` of this rank's rows made the global batch's:
    the blocks of ``split``'s group in rank order, the first
    ``split.count`` of them (one, when every rank holds every row)."""
    whole = _all_gather_cat(t, 0, split.group,
                            dist.get_world_size(split.group))
    return whole[:split.count * t.shape[0]]
