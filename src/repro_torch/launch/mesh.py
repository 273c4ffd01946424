"""Device meshes in PyTorch: the port of the reference's
``launch/mesh.py``.

A :class:`Mesh` names its axes (``data``, ``model`` and, across pods,
``pod``) and their sizes.  When ``torch.distributed`` has a default
process group, the mesh holds a torch ``DeviceMesh`` over it, row-major
over the ranks, and its size must be the world size.  Without one it is
its shape alone, the counterpart of JAX's ``AbstractMesh``: enough to
compute and test the sharding rules (``distributed/sharding.py``) with
no device and no process.

Kept as functions, so importing this module touches no process group:

* :func:`make_production_mesh` — the reference's 16 × 16 pod and 2 × 16
  × 16 multi-pod shapes, its per-arch ``tp`` reshape and its
  ``REPRO_MESH_SHAPE`` / ``REPRO_MESH_SHAPE_MULTI`` overrides;
* :func:`make_host_mesh` — any shape, e.g. the gloo mesh of a CPU test's
  spawned ranks;
* :func:`single_device_mesh` — the 1 × 1 mesh of one device.  With no
  process group it starts a world of one on an in-memory store (NCCL on
  the card, gloo on the CPU): no ``torchrun``, no port, no environment.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class Mesh:
    """Axis names and sizes, and the ``DeviceMesh`` when ranks exist.

    ``shape`` maps each axis to its size, in axis order, as JAX's
    ``Mesh.shape`` does."""

    def __init__(self, shape, axis_names, device_mesh=None) -> None:
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device_mesh = device_mesh
        self._groups: dict = {}

    def __repr__(self) -> str:
        kind = self.device_mesh.device_type if self.device_mesh is not None \
            else "abstract"
        return f"Mesh({self.shape}, {kind})"

    @property
    def device_type(self) -> str:
        return self._dm().device_type

    def _dm(self):
        if self.device_mesh is None:
            raise RuntimeError(f"{self!r} has no ranks: start a process group "
                               "before building the mesh")
        return self.device_mesh

    def coordinate(self) -> dict:
        """This rank's index along each axis."""
        return dict(zip(self.axis_names, self._dm().get_coordinate()))

    def get_group(self, axes):
        """The process group of this rank's line or plane along ``axes``
        (an axis name or a tuple of them): its ranks ordered row-major over
        ``axes``, so the group rank of a member is its block index."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self._groups:
            raise KeyError(f"{self!r} has no group over {key}")
        return self._groups[key]

    def _make_groups(self) -> None:
        """One group per axis and one over the data axes (``pod`` and
        ``data`` together where both exist), made by every rank in the
        same order, as ``torch.distributed`` requires."""
        dm = self._dm()
        for name in self.axis_names:
            self._groups[(name,)] = dm.get_group(name)
        if "pod" in self.shape and "data" in self.shape:
            self._groups[("pod", "data")] = _plane_group(
                dm.mesh, self.axis_names, ("pod", "data"))


def _plane_group(ranks: torch.Tensor, names: tuple, axes: tuple):
    """``dist.new_subgroups_by_enumeration`` over every plane of ``ranks``
    that spans ``axes``; returns this rank's group."""
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    planes = ranks.permute(*rest, *keep).reshape(
        -1, math.prod(ranks.shape[i] for i in keep))
    group, _ = dist.new_subgroups_by_enumeration(
        [[int(r) for r in row] for row in planes])
    return group


def _mesh(shape, axes) -> Mesh:
    """A mesh on the process group if one exists, else its shape alone."""
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        return Mesh(shape, axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh has {math.prod(shape)} devices, the "
                         f"process group {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = Mesh(shape, axes, init_device_mesh(device_type, shape,
                                              mesh_dim_names=axes))
    mesh._make_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, tp: int = 0) -> Mesh:
    """16 × 16 = 256 devices a pod; 2 pods = 512 multi-pod.

    Axes: ``model`` is tensor parallelism, ``data`` (and ``pod``) the
    batch and FSDP group; ``pod`` is the slow cross-pod axis that
    :func:`repro_torch.optim.compress.compressed_psum_pod` compresses.
    ``REPRO_MESH_SHAPE`` / ``REPRO_MESH_SHAPE_MULTI`` override the shapes
    (e.g. "2,4" / "2,2,2"); ``tp`` reshapes the last two axes to the same
    device count with ``model`` = ``tp``."""
    env = os.environ.get(
        "REPRO_MESH_SHAPE_MULTI" if multi_pod else "REPRO_MESH_SHAPE")
    if env:
        shape = tuple(int(x) for x in env.split(","))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if tp:
        chips = shape[-1] * shape[-2]
        if chips % tp:
            raise ValueError(f"tp {tp} does not divide {chips} devices")
        shape = (*shape[:-2], chips // tp, tp)
    return _mesh(shape, axes)


def make_host_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh of any shape, e.g. over a test's gloo ranks."""
    return _mesh(shape, axes)


def single_device_mesh(device=None) -> Mesh:
    """The (1, 1) ``data`` × ``model`` mesh of one device (``None``: the
    CUDA card, which raises without one).  Starts a world of one on a
    ``HashStore`` when no process group exists: NCCL for a CUDA device,
    gloo for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    mesh = _mesh((1, 1), ("data", "model"))
    if mesh.device_type != dev.type:
        raise ValueError(f"the process group's devices are "
                         f"{mesh.device_type}, not {dev.type}")
    return mesh
