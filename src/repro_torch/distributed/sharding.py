"""Parameter / batch / cache sharding rules, in PyTorch: the port of the
reference's ``distributed/sharding.py``.

Axis roles:
  ``model``          — tensor parallelism (heads, d_ff, vocab, experts)
  ``data`` (+``pod``) — batch parallelism; together they form the FSDP
                        axis group along which params & optimizer states
                        are fully sharded.

Rules are keyed on leaf *names* (the tree's key path suffix), with one
structural convention: leaves under a ``blocks`` subtree carry a leading
layer-stack axis which is never sharded.

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dimension an axis name, a tuple of them or ``None`` (``()`` replicates
everything).  The rules give, leaf for leaf, the reference's specs; they
need only the mesh's axis sizes, so they run on a mesh with no ranks and
on ``meta`` tensors.  :func:`placements` turns a spec into DTensor
placements, one per mesh axis: ``Shard(d)`` where the spec puts that
axis on tensor dimension ``d``, ``Replicate()`` elsewhere.  A dimension
over ``("pod", "data")`` takes ``Shard(d)`` on both, ``pod`` the outer,
as JAX orders them.

The Mamba-2 mixer's leaves take the reference's specs, but which of
their columns lie on a rank differs: ``in_proj``'s columns are ``z | x |
B | C | dt`` (the conv's ``x | B | C``), and a contiguous cut of them is
not a set of heads.  Where the mixer splits by heads
(:func:`mixer_splits`), the sharding carries the widths of those parts
(``NamedSharding.parts``): each part is cut into ``model`` blocks, and a
rank's blocks lie side by side (:func:`column_order`), so that a rank
holds the columns of its own heads in the same local extent.
:func:`distribute` lays a whole leaf out in that order and
:func:`whole` takes it back to the reference's; a checkpoint holds the
reference's order whatever mesh wrote it.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.launch.mesh import Mesh
from . import ctx


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``).  ``parts``: the widths
    of the parts of the last dimension, each cut into ``model`` blocks
    with a rank's blocks side by side (:func:`column_order`) — a Mamba
    mixer leaf split by heads; ``None``: the dimension is cut as it
    lies."""

    mesh: Mesh
    spec: tuple
    parts: Optional[tuple] = None

    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def order(self) -> Optional[torch.Tensor]:
        """:func:`column_order` of ``parts`` over the ``model`` axis, or
        ``None``."""
        if self.parts is None:
            return None
        return column_order(self.parts, self.mesh.shape["model"])


def placements(mesh: Mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * len(mesh.axis_names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        index = [mesh.axis_names.index(a) for a in names]
        if index != sorted(index):
            raise ValueError(f"spec {spec}: axes {names} out of mesh order "
                             f"{mesh.axis_names}")
        for i in index:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} uses mesh axis "
                                 f"{mesh.axis_names[i]!r} twice")
            out[i] = Shard(dim)
    return out


def fsdp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def dp_axes(mesh: Mesh):
    return fsdp_axes(mesh)


# ---------------------------------------------------------------------------
# tree walks keyed by path
# ---------------------------------------------------------------------------


def _map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(keys, leaf)`` over a tree of dicts, ``NamedTuple`` states and
    lists; ``keys`` are the dict keys, field names and list indices (as
    strings) down to the leaf; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves_with_path(tree) -> list:
    out: list = []
    _map_with_path(lambda keys, leaf: out.append((keys, leaf)), tree)
    return out


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


#: attention leaves whose TP sharding slices q-heads / kv-heads
_Q_HEAD_LEAVES = frozenset({"wq", "wo", "bq"})
_KV_HEAD_LEAVES = frozenset({"wk", "wv", "bk", "bv"})


def _param_spec_for(name: str, ndim: int, fsdp, *, q_ok=True,
                    kv_ok=True) -> tuple:
    """Spec for an *unstacked* leaf (the stack prefix is the caller's).

    ``q_ok`` / ``kv_ok``: whether TP may shard the q / kv head axes; when
    the heads do not divide the model axis these leaves replicate their
    head axis instead of slicing inside a head."""
    if name == "embed":                          # (V, D): vocab-parallel
        return ("model", fsdp)
    if name == "lm_head":                        # (D, V)
        return (fsdp, "model")
    if name in _Q_HEAD_LEAVES and not q_ok:
        if name == "wq":
            return (fsdp, None)
        if name == "wo":
            return (None, fsdp)
        return (None,)                           # bq
    if name in _KV_HEAD_LEAVES and not kv_ok:
        if name in ("wk", "wv"):
            return (fsdp, None)
        return (None,)                           # bk / bv
    if name in ("wq", "wk", "wv", "wu", "wg", "in_proj"):   # (D, X)
        if ndim == 3:                            # MoE experts (E, D, F)
            return ("model", fsdp, None)
        return (fsdp, "model")
    if name in ("wo", "wd", "out_proj"):         # (X, D)
        if ndim == 3:                            # MoE experts (E, F, D)
            return ("model", None, fsdp)
        return ("model", fsdp)
    if name == "router":                         # (D, E)
        return (fsdp, None)
    if name == "conv_w":                         # (K, conv_dim)
        return (None, "model")
    if name in ("bq", "bk", "bv"):               # (X,)
        return ("model",)
    return ()                                    # norms, scalars: replicate


# ---------------------------------------------------------------------------
# the Mamba mixer's columns, by heads
# ---------------------------------------------------------------------------


def mixer_splits(cfg, count: int) -> bool:
    """Whether ``cfg``'s Mamba-2 mixer computes a rank's heads over a
    ``model`` axis of ``count`` ranks: ``count`` divides its heads and its
    state, and so ``d_inner`` and the widths of ``in_proj`` and the conv.
    Elsewhere its leaves are gathered along ``model`` and every rank
    computes every column (``models/mamba2.py:_whole_leaves``)."""
    s = cfg.ssm
    return s is not None and s.num_heads(cfg.d_model) % count == 0 \
        and s.state_dim % count == 0


def mixer_parts(cfg, *, conv: bool = False) -> tuple:
    """The widths of ``in_proj``'s parts ``z | x | B | C | dt`` (d_inner,
    d_inner, N, N, H), or with ``conv`` of the conv's ``x | B | C``."""
    s, d = cfg.ssm, cfg.d_model
    di, n = s.d_inner(d), s.state_dim
    return (di, n, n) if conv else (di, di, n, n, s.num_heads(d))


def column_order(parts: tuple, count: int) -> torch.Tensor:
    """The columns of a dimension of ``parts`` (widths, side by side) laid
    out for ``count`` ranks: each part cut into ``count`` blocks, rank
    ``r``'s blocks side by side, the ranks in order — position ``j``
    holds column ``order[j]`` of the whole.  The identity at ``count``
    1."""
    starts = [0, *itertools.accumulate(parts)][:-1]
    blocks = [torch.arange(w).view(count, w // count) + s0
              for s0, w in zip(starts, parts)]
    return torch.cat(blocks, dim=1).reshape(-1)


def mixer_order(cfg, count: int, *, conv: bool = False) -> torch.Tensor:
    """:func:`column_order` of ``in_proj``'s columns (``conv``: the conv
    weight's and the conv cache's) for a ``model`` axis of ``count``."""
    return column_order(mixer_parts(cfg, conv=conv), count)


def mixer_order_inverse(cfg, count: int, *,
                        conv: bool = False) -> torch.Tensor:
    """The inverse of :func:`mixer_order`: column ``i`` of the whole lies
    at position ``inverse[i]`` of the laid-out dimension."""
    return torch.argsort(mixer_order(cfg, count, conv=conv))


def _mixer_leaf_parts(cfg, mesh: Mesh, name: str, spec: tuple):
    """``parts`` of a leaf named ``name``: a Mamba mixer leaf whose last
    dimension the spec puts on ``model`` where the mixer splits by heads
    over more than one rank; else ``None``."""
    count = mesh.shape.get("model", 1)
    if cfg is None or count == 1 or not spec or spec[-1] != "model" \
            or not mixer_splits(cfg, count):
        return None
    if name == "in_proj":
        return mixer_parts(cfg)
    if name in ("conv_w", "conv"):              # the weight, the cache
        return mixer_parts(cfg, conv=True)
    return None


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, mesh: Mesh, axes) -> bool:
    """True when a dim of this size can shard over the axis group."""
    n = axis_size(mesh, axes)
    return n > 0 and dim % n == 0


def make_param_shardings(mesh: Mesh, params_shape: Any, cfg=None) -> Any:
    """Tree of :class:`NamedSharding` congruent with the params tree.

    Divisibility-aware: an axis that does not divide its dimension is
    dropped (that dimension replicates).  ``cfg`` (a ``ModelConfig``)
    enables head-aware attention sharding (:func:`_param_spec_for`) and
    the Mamba mixer's split by heads: where ``model`` divides its heads
    and its state (:func:`mixer_splits`), ``in_proj`` and ``conv_w`` keep
    their specs and carry their parts (``NamedSharding.parts``), and the
    mixer computes a rank's heads on its own columns; elsewhere they are
    cut as they lie and the mixer gathers them whole along ``model``
    (``models/mamba2.py:_whole_leaves``, the fallback)."""
    fsdp = fsdp_axes(mesh)
    tp = mesh.shape.get("model", 1)
    q_ok = cfg is None or cfg.num_heads == 0 or cfg.num_heads % tp == 0
    kv_ok = cfg is None or cfg.num_kv_heads == 0 or \
        cfg.num_kv_heads % tp == 0

    def spec_for(keys, leaf):
        name, ndim = keys[-1], len(leaf.shape)
        if "blocks" in keys:
            parts = (None, *_param_spec_for(name, ndim - 1, fsdp, q_ok=q_ok,
                                            kv_ok=kv_ok))
        else:
            parts = _param_spec_for(name, ndim, fsdp, q_ok=q_ok, kv_ok=kv_ok)
        parts = parts[:ndim] + (None,) * (ndim - len(parts))
        parts = tuple(a if _fits(leaf.shape[i], mesh, a) else None
                      for i, a in enumerate(parts))
        return NamedSharding(mesh, parts,
                             _mixer_leaf_parts(cfg, mesh, name, parts))

    return _map_with_path(spec_for, params_shape)


def make_opt_shardings(mesh: Mesh, opt_state_shape: Any,
                       param_shardings: Any) -> Any:
    """Optimizer state: the moments (``mu``, ``nu``) follow their
    parameter's sharding, matched by path suffix; 0-d leaves (``step``,
    ``nu_scale``) and anything unmatched replicate."""
    repl = NamedSharding(mesh, ())
    flat_p = dict(_leaves_with_path(param_shardings))

    def spec_for(keys, leaf):
        if len(leaf.shape) == 0:
            return repl
        for start in range(len(keys)):
            if keys[start:] in flat_p:
                return flat_p[keys[start:]]
        return repl

    return _map_with_path(spec_for, opt_state_shape)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def make_batch_shardings(mesh: Mesh, batch_shape: Any) -> Any:
    """Batch rows over the DP axis group — dropped when the batch does not
    divide it (long_500k's global batch of 1)."""
    dp = dp_axes(mesh)

    def spec_for(keys, leaf):
        name, nd = keys[-1], len(leaf.shape)
        if name == "mrope_positions":               # (3, B, S)
            d = dp if _fits(leaf.shape[1], mesh, dp) else None
            return NamedSharding(mesh, (None, d, None))
        if name in ("tokens", "labels", "embeds", "frames", "token"):
            d = dp if _fits(leaf.shape[0], mesh, dp) else None
            return NamedSharding(mesh, (d, *([None] * (nd - 1))))
        return NamedSharding(mesh, (None,) * nd)

    return _map_with_path(spec_for, batch_shape)


def make_cache_shardings(mesh: Mesh, cache_shape: Any, cfg=None) -> Any:
    """KV / SSM cache sharding with divisibility-aware fallbacks.

    Attention KV (L, B, Hkv, S, hd): heads over ``model`` where they
    divide it, else the sequence over ``model``; the batch over the DP
    group wherever it divides.  Given ``cfg``, the Mamba conv cache
    carries the conv's parts where the mixer splits by heads, as
    ``conv_w`` does (:func:`make_param_shardings`)."""
    dp = dp_axes(mesh)

    def kv_spec(shape):
        _, b, h, s, _ = shape
        d = dp if _fits(b, mesh, dp) else None
        if _fits(h, mesh, "model"):
            return (None, d, "model", None, None)
        if _fits(s, mesh, "model"):
            return (None, d, None, "model", None)
        return (None, d, None, None, None)

    def spec_for(keys, leaf):
        name, nd = keys[-1], len(leaf.shape)
        if name in ("k", "v", "ck", "cv") and nd == 5:
            return NamedSharding(mesh, kv_spec(tuple(leaf.shape)))
        if name == "conv" and nd == 4:          # (L, B, K-1, conv_dim)
            d = dp if _fits(leaf.shape[1], mesh, dp) else None
            m = "model" if _fits(leaf.shape[3], mesh, "model") else None
            spec = (None, d, None, m)
            return NamedSharding(mesh, spec,
                                 _mixer_leaf_parts(cfg, mesh, name, spec))
        if name == "ssm" and nd == 5:           # (L, B, H, P, N)
            d = dp if _fits(leaf.shape[1], mesh, dp) else None
            m = "model" if _fits(leaf.shape[2], mesh, "model") else None
            return NamedSharding(mesh, (None, d, m, None, None))
        return NamedSharding(mesh, (None,) * nd)

    return _map_with_path(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------


def distribute(tensor: torch.Tensor, sharding: NamedSharding):
    """``tensor`` — the same full value on every rank — as a DTensor on
    the sharding's mesh: each rank keeps its own shard, nothing moves.
    Where the sharding carries parts, the last dimension is laid out in
    their order first (:func:`column_order`)."""
    from torch.distributed.tensor import distribute_tensor

    order = sharding.order()
    if order is not None:
        tensor = tensor.index_select(-1, order.to(tensor.device))
    return distribute_tensor(tensor, sharding.mesh.device_mesh,
                             sharding.placements(), src_data_rank=None)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """:func:`distribute` over a tree and its congruent shardings."""
    by_path = dict(_leaves_with_path(shardings))
    return _map_with_path(lambda keys, x: distribute(x, by_path[keys]), tree)


def whole(x, sharding: Optional[NamedSharding] = None):
    """A DTensor placed by ``sharding`` (:func:`distribute`) as its full
    value in the reference's column order — a collective every rank of
    its mesh takes part in; a plain tensor as it is.  ``sharding``
    ``None``: the full value as the ranks lay it out."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    t = x.full_tensor()
    order = None if sharding is None else sharding.order()
    if order is None:
        return t
    return t.index_select(-1, torch.argsort(order).to(t.device))


def whole_tree(tree: Any, shardings: Any) -> Any:
    """:func:`whole` over a tree and its congruent shardings."""
    by_path = dict(_leaves_with_path(shardings))
    return _map_with_path(lambda keys, x: whole(x, by_path[keys]), tree)


# ---------------------------------------------------------------------------
# activation hook (installed by the sharded step; models call
# ctx.shard_activation)
# ---------------------------------------------------------------------------


def activation_hook(mesh: Mesh, cfg=None) -> Callable:
    """The hook of a step on ``mesh``.  Compute runs on plain local
    tensors, so where the reference constrains ``hidden`` (B, S, D) and
    ``logits`` (B, c, V) to the DP rows, this hook checks that they are
    plain tensors holding this rank's rows of the microbatch
    (``ctx.row_split``) and returns them as they are.  Given the model's
    ``cfg`` it also checks their widths: ``hidden`` holds the whole
    ``d_model`` (replicated along ``model``), ``logits`` this rank's
    shard of the vocabulary (all of it with no ``ctx.ModelSplit``
    installed, or where the vocabulary does not divide it)."""
    from torch.distributed.tensor import DTensor

    from . import tp

    def hook(x, kind: str):
        if kind in ("hidden", "logits") and x.ndim >= 2:
            if isinstance(x, DTensor):
                raise TypeError(f"a DTensor {kind} activation on {mesh!r}: "
                                "compute runs on local tensors")
            split = ctx.row_split()
            if split is not None and x.shape[0] != split.rows:
                raise ValueError(
                    f"{kind} activation holds {x.shape[0]} rows, this rank "
                    f"of {mesh!r} {split.rows}")
            if cfg is not None:
                want = cfg.d_model if kind == "hidden" else \
                    tp.local_extent(tp.vocab_rows(cfg))
                if x.shape[-1] != want:
                    raise ValueError(
                        f"{kind} activation holds {x.shape[-1]} columns, "
                        f"this rank of {mesh!r} {want}")
        return x

    return hook
