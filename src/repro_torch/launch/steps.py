"""Step functions shared by the trainer and the server.

Model-family dispatch (decoder-only LM vs encoder–decoder) happens here,
so the launchers stay family-agnostic:

  ``train_step(params, opt_state, batch)   -> (params, opt_state, metrics)``
  ``prefill_step(params, batch)             -> (logits, caches)``
  ``decode_step(params, cache, token, pos)  -> (logits, cache)``

The train step is the reference's: loss, its gradient, gradient
accumulation over microbatches, then the AdamW update.  It trains every
family: dense (dense, vlm, audio), MoE, SSM (the SSD's gradient through
its backward kernel), the hybrid (Jamba's superblock of all three) and
the encoder–decoder (``encdec.encdec_loss``), with ``mlp_impl`` dense or
streamed (the fused MLP's gradient through its backward kernel).

On a device mesh each rank computes its rows of the global batch on its
shard of ``model`` (heads, ``d_ff``, experts, vocabulary, the Mamba
mixer's heads; ``distributed/tp.py``): the serve steps (``mesh=``), whose
logits come back whole, and :func:`make_sharded_train_step`, backward
included, which hands each rank the gradient of its own shards.  Both
install a ``ctx.ParamGather`` (:func:`param_gather`) and hand the model
the params' local tensors: the model gathers them along the data axes
one superblock at a time, where it uses them (``tp.gather_data``).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# family dispatch
# ---------------------------------------------------------------------------

def model_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.family == "encdec":
        return encdec.encdec_loss(params, cfg, batch)
    return lm.lm_loss(params, cfg, batch)


def model_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.family == "encdec":
        return encdec.init_params(gen, cfg)
    return lm.init_params(gen, cfg)


def model_prefill(params: dict, cfg: ModelConfig, batch: dict):
    if cfg.family == "encdec":
        return encdec.encdec_prefill(params, cfg, batch)
    return lm.lm_prefill(params, cfg, batch)


def model_decode(params: dict, cfg: ModelConfig, cache, token, pos: int):
    if cfg.family == "encdec":
        return encdec.encdec_decode(params, cfg, cache, token, pos)
    return lm.lm_decode(params, cfg, cache, token, pos)


def model_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device=None):
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, mem_len=max_len,
                                 max_len=max_len, device=device)
    return lm.init_cache(cfg, batch, max_len, device=device)


# ---------------------------------------------------------------------------
# gradient accumulation helpers
# ---------------------------------------------------------------------------

#: batch leaves whose microbatch split axis is not 0
SPLIT_AXIS = {"mrope_positions": 1}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches of ``batch`` (views): each leaf cut into
    ``accum`` equal parts along its batch axis (``SPLIT_AXIS``; 0
    otherwise), in order."""
    def parts(name, x):
        ax = SPLIT_AXIS.get(name, 0)
        b = x.shape[ax]
        if b % accum:
            raise ValueError(f"{name}: batch {b} does not split into "
                             f"{accum} microbatches")
        return torch.chunk(x, accum, dim=ax)

    split = {name: parts(name, x) for name, x in batch.items()}
    return [{name: split[name][i] for name in batch} for i in range(accum)]


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, grads): the loss of ``batch`` and its gradient for every
    parameter leaf, in the leaf's dtype, contiguous — a tied embedding's
    comes out of autograd transposed, a reduce-scattered one not, and the
    global norm sums a leaf in the order of its layout."""
    with torch.enable_grad():
        live = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        loss = model_loss(live, cfg, batch)
        leaves = adamw.tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves)
    flat = iter(g.contiguous() for g in grads)
    return loss.detach(), _rebuild(live, flat)


def _rebuild(tree, flat):
    """``tree``'s structure filled from ``flat`` in sorted key order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat) for k in sorted(tree)}
    return next(flat)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                    grad_accum: int):
    """(loss, grads) of ``batch``: with ``grad_accum`` > 1 the batch is
    cut into that many microbatches whose gradients are summed in f32 and
    divided by ``grad_accum`` (the loss too), as the reference's
    ``lax.scan`` over microbatches does."""
    if grad_accum == 1:
        return _value_and_grad(cfg, params, batch)
    loss = torch.zeros((), dtype=torch.float32)
    grads = adamw.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
    for mb in _split_microbatches(batch, grad_accum):
        l, g = _value_and_grad(cfg, params, mb)
        loss = loss.to(l.device) + l
        adamw.tree_map(lambda a, b: a.add_(b.to(torch.float32)), grads, g)
        del g
    return loss / grad_accum, adamw.tree_map(lambda g: g / grad_accum,
                                             grads)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    grad_accum: int = 1,
) -> Callable:
    """Forward + backward + AdamW update, optionally microbatched
    (:func:`_loss_and_grads`).  The returned step leaves its arguments
    unchanged (``adamw.apply`` is functional)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")

    def train_step(params, opt_state, batch):
        loss, grads = _loss_and_grads(cfg, params, batch, grad_accum)
        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# the train step on a device mesh
# ---------------------------------------------------------------------------


def batch_rows(mesh, global_batch: int, grad_accum: int = 1) -> list:
    """``[(start, end), ...]``: the rows of a global batch that this rank
    of ``mesh`` computes, in order.  Along the data axes (``pod`` ×
    ``data``, ``make_batch_shardings``' group) each microbatch — a
    ``global_batch / grad_accum`` slice of rows, as the reference cuts
    them — is cut into one block a rank, in row order; the rank holds its
    block of every microbatch.  With ``grad_accum`` 1 that is the
    ``Shard`` of ``make_batch_shardings``.  Where the blocks would not be
    whole the batch replicates: every rank computes every row."""
    from repro_torch.distributed import sharding as shd

    n = shd.axis_size(mesh, shd.dp_axes(mesh))
    if n == 1 or global_batch % (n * grad_accum):
        return [(0, global_batch)]
    index = _dp_index(mesh)
    micro, block = global_batch // grad_accum, global_batch // grad_accum // n
    return [(i * micro + index * block, i * micro + (index + 1) * block)
            for i in range(grad_accum)]


def _dp_index(mesh) -> int:
    """This rank's block along the data axes (``pod`` major)."""
    coord = mesh.coordinate()
    return coord.get("pod", 0) * mesh.shape["data"] + coord["data"]


def _row_split(mesh, global_batch: int, grad_accum: int = 1):
    """The ``ctx.RowSplit`` of this rank's rows (:func:`batch_rows`) of a
    global batch of ``global_batch`` rows: the data axes' group, its
    block index, the number of blocks (1 when the batch replicates) and
    the rows of each microbatch it holds."""
    from repro_torch.distributed import ctx, sharding as shd

    rows = sum(b - a for a, b in batch_rows(mesh, global_batch, grad_accum))
    count = global_batch // rows
    return ctx.RowSplit(mesh.get_group(shd.dp_axes(mesh)),
                        _dp_index(mesh) if count > 1 else 0, count,
                        rows // grad_accum)


def local_batch(mesh, batch: dict, grad_accum: int = 1) -> dict:
    """This rank's rows (:func:`batch_rows`) of a global ``batch``."""
    def rows(name, x):
        ax = SPLIT_AXIS.get(name, 0)
        spans = batch_rows(mesh, x.shape[ax], grad_accum)
        return torch.cat([x.narrow(ax, a, b - a) for a, b in spans], dim=ax)

    return {name: rows(name, x) for name, x in batch.items()}


def param_gather(mesh, params, dequantize=None):
    """The ``ctx.ParamGather`` of DTensor ``params`` on ``mesh``: each
    leaf's dimension that the data axes (``pod`` × ``data``) shard, by
    its placements (a ``QTensor``'s ``q`` and ``scale`` each by its
    own); ``dequantize``, the dtype a ``QTensor`` becomes after its
    gather."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import ctx, sharding as shd

    dp = shd.dp_axes(mesh)
    axes = [mesh.axis_names.index(a)
            for a in ((dp,) if isinstance(dp, str) else dp)]
    dims = {}
    for keys, p in shd._leaves_with_path(params):
        on = [p.placements[i] for i in axes]
        split = {q.dim for q in on if isinstance(q, Shard)}
        if not split:
            continue
        if len(split) > 1 or not all(isinstance(q, Shard) for q in on):
            raise ValueError(f"{'/'.join(keys)}: placements "
                             f"{p.placements} split the data axes apart")
        dims[keys] = split.pop()
    return ctx.ParamGather(mesh.get_group(dp), shd.axis_size(mesh, dp), dims,
                           dequantize)


def _model_split(mesh, kv_seq: bool = False):
    from repro_torch.distributed import ctx

    return ctx.ModelSplit(mesh.get_group("model"), mesh.coordinate()["model"],
                          mesh.shape["model"], kv_seq)


def _whole_scalar(v):
    """A metric of ``adamw.apply`` on DTensors as a plain tensor: its
    value made whole on every rank (a 0-d tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(v, DTensor):
        return v
    return v.redistribute(v.device_mesh,
                          [Replicate()] * v.device_mesh.ndim).to_local()


def make_sharded_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    *,
    global_batch: int,
    grad_accum: int = 1,
) -> Callable:
    """The train step on ``mesh`` for batches of ``global_batch`` rows:
    ``step(params, opt_state, batch)`` with params and optimizer state as
    DTensors placed by the sharding rules and ``batch`` this rank's rows
    (:func:`batch_rows`; :func:`local_batch` cuts them from a global
    batch).

    A rank computes on its own shards.  The loss and its gradient run as
    in :func:`make_train_step` on this rank's rows, on each leaf's local
    tensor — plain tensors, so the hand-written kernels see no DTensor —
    with a ``ctx.ModelSplit`` installed: heads, ``d_ff`` columns, experts
    and the vocabulary (a vocabulary-parallel chunked CE) split along
    ``model``, backward included, through the autograd-aware collectives
    of ``distributed/tp.py``.  A ``ctx.ParamGather`` names the leaves the
    data axes shard: the model gathers each where it uses it — a
    superblock's (an encoder–decoder layer's) inside its checkpointed
    function, so that under ``cfg.remat`` a rank holds one superblock's
    gathered leaves at a time (without remat autograd keeps them all for
    the backward) — and their backward reduce-scatters each gradient to
    this rank's block, summed over the data axes.  That sum is divided by
    the data axes' size: the number of row blocks, or where the batch
    replicates, the number of identical copies summed.  A leaf the data
    axes do not shard has this rank's rows' gradient, averaged over the
    row blocks by an all-reduce (nothing when the batch replicates).  The
    gradients become DTensors with their params' placements as they are,
    and ``adamw.apply`` runs on the DTensors, its global norm and the
    int8 moments' absmax reduced across the mesh.  No leaf is ever made
    whole.  On a 1 × 1 mesh every collective is the identity and the
    step gives :func:`make_train_step`'s bits."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import ctx, sharding as shd

    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")
    split = _row_split(mesh, global_batch, grad_accum)
    group, count, rows = split.group, split.count, split.rows * grad_accum
    msplit = _model_split(mesh)
    hook = shd.activation_hook(mesh, cfg)

    def mean_over_rows(t):
        if count > 1:
            dist.all_reduce(t, group=group)
            t.div_(count)
        return t

    def train_step(params, opt_state, batch):
        for name, x in batch.items():
            if x.shape[SPLIT_AXIS.get(name, 0)] != rows:
                raise ValueError(f"{name}: {x.shape[SPLIT_AXIS.get(name, 0)]}"
                                 f" rows, this rank of {mesh!r} computes "
                                 f"{rows} of {global_batch}")
        plan = param_gather(mesh, params)
        local = adamw.tree_map(lambda p: p.to_local(), params)
        with ctx.data_rows(split), ctx.model_shards(msplit), \
                ctx.gathering_params(plan), ctx.activation_sharding(hook):
            loss, grads = _loss_and_grads(cfg, local, batch, grad_accum)
        del local

        def own(keys, g, p):
            if keys in plan.dims:
                g.div_(plan.count)
            else:
                mean_over_rows(g)
            return DTensor.from_local(g, p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride())

        by_path = dict(shd._leaves_with_path(params))
        grads = shd._map_with_path(lambda keys, g: own(keys, g, by_path[keys]),
                                   grads)
        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 opt_cfg)
        metrics = {k: _whole_scalar(v) for k, v in metrics.items()}
        metrics["loss"] = mean_over_rows(loss.clone())
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _serving_on(mesh, cfg: ModelConfig, params, global_batch: int, *,
                kv_seq: bool = False):
    """The context of a serve step on ``mesh`` with DTensor ``params``
    for a batch of ``global_batch`` rows → its ``RowSplit``: the rows as
    :func:`batch_rows` deals them (MoE capacity counts the global rows),
    the ``ModelSplit`` along which the layers split heads, ``d_ff``,
    experts and the vocabulary (``distributed/tp.py``), the
    ``ParamGather`` of ``params`` (:func:`param_gather`; int8 leaves
    dequantized to ``cfg.param_dtype`` right after their gather), and
    the activation hook, which checks the widths the split gives."""
    from repro_torch.distributed import ctx, sharding as shd

    rsplit = _row_split(mesh, global_batch)
    msplit = _model_split(mesh, kv_seq)
    plan = param_gather(mesh, params, cfg.param_dtype)
    with ctx.data_rows(rsplit), ctx.model_shards(msplit), \
            ctx.gathering_params(plan), \
            ctx.activation_sharding(shd.activation_hook(mesh, cfg)):
        yield rsplit


def _rows_of(batch: dict) -> int:
    name, x = next(iter(batch.items()))
    return x.shape[SPLIT_AXIS.get(name, 0)]


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``prefill_step(params, batch) -> (logits (B, V) f32, caches)``.

    On ``mesh`` the params are DTensors placed by the sharding rules (a
    ``QTensor``'s q and scale too) and ``batch`` is the global batch: the
    rank computes its rows (:func:`local_batch`) on its shard of
    ``model`` (:func:`_serving_on`), the logits are gathered to the whole
    batch, and the tight caches are the rank's own (its rows; under a
    head split its heads), as ``tp.cache_from_prefill`` takes them.  The
    model gets the params' local tensors — each leaf's block along the
    data axes and its shard along ``model`` — and gathers a superblock's
    leaves along the data axes when it runs, one collective a
    superblock, freed before the next (int8 ones dequantized right
    after), the embedding and the head where they are read; no cache it
    returns holds a view of a gathered leaf."""
    if mesh is None:
        def prefill_step(params, batch):
            return model_prefill(params, cfg, batch)

        return prefill_step
    from repro_torch.distributed import tp

    def prefill_step(params, batch):
        with _serving_on(mesh, cfg, params, _rows_of(batch)) as rows:
            logits, caches = model_prefill(tp.to_local(params), cfg,
                                           local_batch(mesh, batch))
            return tp.gather_rows(logits, rows), caches

    return prefill_step


def place_token(mesh, token: torch.Tensor):
    """A decode step's ``token`` — the global batch's, the same on every
    rank — as the step on ``mesh`` takes it: a DTensor placed by
    ``make_batch_shardings``, its local tensor this rank's rows, cut
    locally (no collective); ``token`` itself with no mesh."""
    if mesh is None:
        return token
    from repro_torch.distributed import sharding as shd

    return shd.distribute(
        token, shd.make_batch_shardings(mesh, {"token": token})["token"])


def make_decode_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``decode_step(params, cache, token, pos) -> (logits (B, V) f32,
    cache)``, the cache updated in place.

    On ``mesh`` the params are placed as for :func:`make_prefill_step`,
    ``cache`` is a tree of DTensors placed by ``make_cache_shardings``
    (whose local tensors the step updates) and ``token`` a DTensor placed
    by ``make_batch_shardings`` (:func:`place_token`), as the reference's
    jitted decode takes them: the rank reads its own rows of the token
    and of the caches.  ``pos`` stays a Python int, where the
    reference's is an int32 argument: the attention reads it on the host.
    Where the caches hold their positions in blocks along ``model`` the
    attention layers take their softmax in blocks.  The params are
    gathered along the data axes as in a prefill, every superblock on
    every token, as the reference's jitted decode does; the logits are
    gathered to the whole batch."""
    if mesh is None:
        def decode_step(params, cache, token, pos):
            return model_decode(params, cfg, cache, token, pos)

        return decode_step
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import tp

    def decode_step(params, cache, token, pos):
        if not isinstance(token, DTensor):
            raise TypeError("a decode step on a mesh takes its token placed "
                            "by make_batch_shardings (steps.place_token)")
        seq = tp.positions_on_model(cache, mesh)
        with _serving_on(mesh, cfg, params, token.shape[0],
                         kv_seq=seq) as rows:
            logits, _ = model_decode(tp.to_local(params), cfg,
                                     tp.to_local(cache), token.to_local(),
                                     pos)
            return tp.gather_rows(logits, rows), cache

    return decode_step
