"""Walks over parameter and state trees: nested dicts of tensors, with
``NamedTuple`` states (``AdamWState``, ``QTensor``) inside.  Shared by
the optimizer, the checkpoint manager and post-training quantization."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (the reference's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_flatten_with_path(tree, path: str = "") -> list:
    """(path, leaf) pairs in the reference's tree order — dict keys
    sorted, ``NamedTuple`` fields in order, list and tuple items by
    index, ``None`` no leaf — each path in ``jax.tree_util.keystr`` form
    (``"['opt'].mu['blocks']['b0']['attn']['bk']"``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in tree_flatten_with_path(v, f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]
