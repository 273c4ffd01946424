"""Atomic checkpoints with asynchronous writes, in PyTorch: the port of
the reference's ``checkpoint/manager.py``, in its on-disk layout to the
byte.

Layout (one directory per step)::

    <root>/step_000000042/
        manifest.json      # step, leaf index, shapes/dtypes, extra metadata
        arr_00000.npy ...  # one file per tree leaf

* **The reference's tree order and paths** — leaves are taken with dict
  keys sorted, ``NamedTuple`` fields in order (``AdamWState``), list and
  tuple items by index, ``None`` no leaf; ``leaf_paths`` are
  ``jax.tree_util.keystr`` strings (``"['opt'].step"``,
  ``"['opt'].mu['blocks']['b0']['attn']['bk']"``, …;
  ``tree.tree_flatten_with_path``).  bfloat16 and the
  two float8 types are stored as raw ``uint16`` / ``uint8`` views with the
  logical dtype in the manifest (``_EXT_DTYPES``).  So a checkpoint the
  reference writes restores here bit for bit, and the other way round.
* **Atomicity** — writes go to ``step_N.tmp`` then ``os.rename`` to
  ``step_N``; a crash mid-write never corrupts the latest checkpoint and
  ``latest_step`` only ever sees committed directories.
* **Async** — ``save_async`` copies every leaf to host memory before it
  returns (a CUDA tensor by a blocking copy, a host tensor or array by a
  clone) and writes the files on a thread; ``wait`` joins before the
  next save, so at most one checkpoint is in flight.
* **Restore onto a device or a mesh (elastic re-mesh)** — leaves are
  full logical arrays; ``restore`` casts each to the template's dtype,
  puts it on ``device`` (``None``: the CUDA card) and, given
  ``shardings`` (``distributed.sharding``), places it as a DTensor on
  their mesh.  So a checkpoint written on a (4, 2) mesh restores onto
  (2, 2, 2) or one device.
* **Under a process group** — a DTensor leaf is gathered to its full
  value on the calling thread, a collective every rank takes part in,
  and given the tree's ``shardings`` laid back into the reference's
  column order (``distributed.sharding.whole``: a Mamba mixer leaf split
  by heads is placed in another), so that a file holds the same arrays
  whatever mesh wrote it;
  only rank 0 copies the leaves to host memory, writes files, renames
  and collects old steps (the other ranks drop what they gathered), and
  ``save`` and ``wait`` end at a barrier, so that every rank then sees
  the committed directory.  With more than one rank, ``save``,
  ``save_async``, ``wait`` and ``restore`` are called by every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_path

#: extension dtypes numpy can't round-trip through .npy — stored as raw
#: uint views with the logical dtype recorded in the manifest: (torch
#: dtype, the integer view torch hands to numpy, numpy's dtype of that
#: view, the stored uint view)
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}


def _to_host(x, sharding=None) -> tuple[np.ndarray, str]:
    """(storage array, logical dtype name) of a host copy of ``x`` that
    the caller may not mutate: a tensor copied off its device (a CUDA
    tensor blocking) or cloned, an array copied; a DTensor made whole
    by ``sharding`` (``distributed.sharding.whole``) first."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if _is_dtensor(t):
            t = _whole(t, sharding)    # a collective: every rank gathers
        t = t.to("cpu") if t.device.type != "cpu" else t.clone()
        t = t.contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXT_DTYPES:
            _, view, _, stored = _EXT_DTYPES[name]
            return t.view(view).numpy().view(stored), name
        return t.numpy(), name
    arr = np.array(x, copy=True)
    return arr, arr.dtype.name


def _whole(t, sharding):
    from repro_torch.distributed.sharding import whole

    return whole(t, sharding)


def _shardings_of(tree, shardings) -> list:
    """``shardings`` (congruent with ``tree``) flattened in its order, or
    ``None`` for every leaf."""
    n = len(tree_flatten_with_path(tree))
    if shardings is None:
        return [None] * n
    place = [sh for _, sh in tree_flatten_with_path(shardings)]
    if len(place) != n:
        raise ValueError(f"{len(place)} shardings for a template of {n} "
                         "leaves")
    return place


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writes() -> bool:
    """Whether this process writes the files: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if _ranks() > 1:
        dist.barrier()


def _from_saved(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _EXT_DTYPES:
        ext, _, np_view, _ = _EXT_DTYPES[logical]
        return torch.from_numpy(arr.view(np_view)).view(ext)
    return torch.from_numpy(arr)


def _torch_dtype(dtype) -> torch.dtype:
    """A template's dtype (torch, numpy or its name) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _unflatten(tree, leaves):
    """``tree``'s structure (its own dict key order) filled from the
    iterator ``leaves``, taken in ``tree_flatten_with_path``'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        filled = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3) -> None:
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                    steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: dict | None = None, *,
             shardings: Any = None) -> str:
        """Synchronous atomic save; returns the step's directory.
        ``shardings``: the ``distributed.sharding.NamedSharding`` tree the
        DTensor leaves were placed by — needed where one carries a column
        order (a Mamba mixer split by heads), which the file then holds
        as the reference's."""
        host = self._snapshot(tree, shardings)
        if _writes():
            self._write(step, host, extra or {})
        _barrier()
        return self._step_dir(step)

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   *, shardings: Any = None) -> None:
        """Snapshot now, write on a background thread.  The snapshot
        copies every leaf, so the caller may change or free the tree as
        soon as this returns.  A failed write raises from the next
        ``wait`` (or ``save_async``, which waits first).  ``shardings``
        as for :meth:`save`."""
        self.wait()
        host = self._snapshot(tree, shardings)
        if not _writes():
            return

        def write():
            try:
                self._write(step, host, extra or {})
            except Exception as e:         # raised again by ``wait``
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer; a write that failed raises here (on the
        writing rank, after the barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        err, self._error = self._error, None
        if err is not None:
            raise err

    @staticmethod
    def _snapshot(tree: Any, shardings: Any = None) -> list:
        """(path, storage array, logical dtype) of a host copy of every
        leaf, in the reference's order, each DTensor made whole by its
        sharding.  A rank that writes no files only takes part in the
        gathers of the DTensor leaves, copies nothing to the host and
        returns an empty list."""
        flat = tree_flatten_with_path(tree)
        place = _shardings_of(tree, shardings)
        if not _writes():
            for (_, x), sh in zip(flat, place):
                if _is_dtensor(x):
                    _whole(x.detach(), sh)      # a collective
            return []
        return [(path, *_to_host(x, sh))
                for (path, x), sh in zip(flat, place)]

    def _write(self, step: int, host: list, extra: dict) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "extra": extra,
            "leaf_paths": [path for path, _, _ in host],
            "leaves": [],
        }
        for i, (_, arr, logical) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape), "dtype": logical}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # commit point
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def restore(self, step: int, template: Any, *, device=None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` → (tree, extra).

        ``template``: a tree whose leaves have ``shape`` and ``dtype``
        (tensors — ``meta`` ones will do — arrays, the reference's
        ``ShapeDtypeStruct``); each leaf is cast to its template's dtype
        and put on ``device`` (``None``: the CUDA card, which raises
        without one).  ``shardings``: a tree congruent with ``template``
        of ``distributed.sharding.NamedSharding`` — each leaf then becomes
        a DTensor on its sharding's mesh (of ``device``'s type), this rank
        keeping its own shard: the checkpoint may come from any mesh.  A
        template of another structure or shape raises
        :class:`ValueError`.
        """
        dev = resolve_device(device)
        place = _shardings_of(template, shardings)
        if shardings is not None:
            from repro_torch.distributed.sharding import distribute
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = tree_flatten_with_path(template)
        if len(flat) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, template "
                f"{len(flat)} — structure changed?")
        out = []
        for i, (meta, (_, tmpl), sh) in enumerate(
                zip(manifest["leaves"], flat, place)):
            arr = _from_saved(np.load(os.path.join(d, meta["file"])),
                              meta["dtype"])
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"{manifest['leaf_paths'][i]}: checkpoint shape "
                    f"{tuple(arr.shape)}, template {tuple(tmpl.shape)}")
            t = arr.to(_torch_dtype(tmpl.dtype)).to(dev)
            out.append(t if sh is None else distribute(t, sh))
        return _unflatten(template, iter(out)), manifest["extra"]
