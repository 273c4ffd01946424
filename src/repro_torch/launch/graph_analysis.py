"""Per-device counts of one step for the roofline: the port's counterpart
of the reference's ``launch/hlo_analysis.py``.

The reference parses the compiled HLO text, recovers every ``while``
loop's trip count and multiplies each loop body's costs by it.  The port
exports no graph.  It runs the step once, eagerly, on ``meta`` tensors —
shapes and dtypes, no memory, no arithmetic — under a
``TorchDispatchMode`` (:class:`StepCounter`) that sees every aten op the
card would launch.  Eager execution runs a loop body once per trip, so
there is no trip count to recover: the counter's sums are already the
trip-scaled ones.  On a fake process group of the production mesh's size
the counts are those of this rank (SPMD: every rank runs the same ops on
shards of the same shapes, as the reference's per-device HLO does).

What each op is charged (:class:`GraphStats`):

* **FLOPs.** 2 × the output elements × the contracted size for every
  product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv`` — what
  ``matmul`` and ``einsum`` decompose to) and for convolutions: the
  reference's ``_dot_flops``.  Each product is kept by its dtype, so that
  the roofline charges it at that dtype's rate.
* **Bytes.** Every op that launches a kernel on the card is charged its
  inputs plus its outputs; views, metadata and bare allocations cost
  nothing.  Unlike the reference's ``MEM_OPS``, elementwise ops count: in
  eager PyTorch each is a launch that reads and writes device memory,
  where on the TPU they fused.  An in-place update into a buffer
  (``copy_``, ``index_copy_``, ``index_put_``, ``index_add_``,
  ``scatter_``: a cache update) is charged 2 × the update, not the
  buffer — the reference's rule for ``dynamic-update-slice``.
* **Collectives.** Every c10d op the port calls (``allreduce_``,
  ``allgather_``, ``_allgather_base_``, ``reduce_scatter_``,
  ``_reduce_scatter_base_``, ``alltoall_``, ``broadcast_``, their
  coalesced forms) and every ``_c10d_functional`` one (DTensor's
  redistributes), by the reference's convention: all-reduce 2 × size,
  all-gather the result, reduce-scatter the operand, all-to-all and
  broadcast the size.  Each is also kept by its process group, whose
  ranks say which link it crosses; a group of one rank moves nothing and
  is not counted.
* **Hand-written kernels.**  A kernel's wrapper on ``meta`` tensors runs
  no plain version: it records one launch with the kernel's own work
  (``kernels/work.py``) through ``kernels.work.record_kernel``, which
  calls :meth:`StepCounter.count_kernel`.
* **Arguments.** A storage handed to the step counts only if an op of
  the step reads it, as the reference's ``jax.jit`` (``keep_unused``
  left ``False``) drops the parameters its program never reads: the
  encoder's params from an encoder–decoder's decode step.  Those it
  never reads are kept apart (``unread_argument_bytes``).
* **Peak.** The live bytes of the storages during the step, on top of
  the arguments it reads (live from the start): a storage is added when
  an op first returns it and taken off when it dies (a weakref
  finalizer).  These are the bytes the
  tensors ask for — on the card ``torch.cuda.memory_stats()``'s
  ``requested_bytes``; the caching allocator holds them in blocks of 512
  bytes and more, which ``torch.cuda.memory_allocated`` counts.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline
from repro_torch.tree import tree_flatten_with_path

#: per-device bytes moved per byte of the counted buffer (ring algorithms)
_COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                      "reduce-scatter": 1.0, "all-to-all": 1.0,
                      "broadcast": 1.0}
#: ``(namespace, op)`` → (kind, the argument whose bytes count; None: the
#: op's result)
_COLLECTIVES = {
    ("c10d", "allreduce_"): ("all-reduce", "tensors"),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", "tensors"),
    ("c10d", "allgather_"): ("all-gather", "output_tensors"),
    ("c10d", "_allgather_base_"): ("all-gather", "output_tensor"),
    ("c10d", "allgather_coalesced_"): ("all-gather", "output_lists"),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", "outputs"),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", "input_tensors"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "input_tensor"),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter",
                                                   "inputs"),
    ("c10d", "alltoall_"): ("all-to-all", "input_tensors"),
    ("c10d", "alltoall_base_"): ("all-to-all", "input"),
    ("c10d", "broadcast_"): ("broadcast", "tensors"),
    ("_c10d_functional", "all_reduce"): ("all-reduce", "input"),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "input"),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", "inputs"),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", None),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather",
                                                         "out"),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): ("all-gather",
                                                               None),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter",
                                                    "input"),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): (
        "reduce-scatter", "inputs"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "input"),
    ("_c10d_functional", "broadcast"): ("broadcast", "input"),
    ("_c10d_functional", "broadcast_"): ("broadcast", "input"),
}
#: collective namespaces' ops that move nothing of their own
_COLLECTIVE_FREE = {"wait_tensor", "_wrap_tensor_autograd", "barrier"}

#: in-place updates charged 2 × their update (read it, write its region)
_UPDATES = {"copy_": "src", "index_copy_": "source", "index_put_": "values",
            "_index_put_impl_": "values", "index_add_": "source",
            "scatter_": "src", "scatter_add_": "src",
            "masked_scatter_": "source"}
#: ops that allocate and launch nothing
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
#: products: (name) → FLOPs from (args, output)
_PRODUCTS = {
    "mm": lambda a, out: 2 * out.numel() * a[0].shape[-1],
    "bmm": lambda a, out: 2 * out.numel() * a[0].shape[-1],
    "addmm": lambda a, out: 2 * out.numel() * a[1].shape[-1],
    "baddbmm": lambda a, out: 2 * out.numel() * a[1].shape[-1],
    "addbmm": lambda a, out: 2 * out.numel() * a[1].shape[0]
    * a[1].shape[-1],
    "dot": lambda a, out: 2 * a[0].numel(),
    "vdot": lambda a, out: 2 * a[0].numel(),
    "mv": lambda a, out: 2 * a[0].numel(),
    "addmv": lambda a, out: 2 * a[1].numel(),
}
_CONVS = {"convolution", "_convolution", "convolution_backward"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors in an argument or a result (lists nest)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _dims_key(t: torch.Tensor) -> tuple:
    return (str(t.dtype).removeprefix("torch."), tuple(t.shape[-2:]))


def _bind(func, args, kwargs) -> dict:
    """The op's arguments by their schema names."""
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args))
    bound.update(kwargs)
    return bound


def _group_name(func, bound: dict) -> str | None:
    """The process group an op runs on, by its name."""
    from torch._C._distributed_c10d import ProcessGroup

    if "group_name" in bound:
        g = bound["group_name"]
        return g if isinstance(g, str) else g.group_name
    for a in func._schema.arguments:
        if str(a.type).endswith("c10d.ProcessGroup"):
            pg = bound[a.name]
            if isinstance(pg, torch.ScriptObject):
                pg = ProcessGroup.unbox(pg)
            return pg.group_name
    return None


def _group_ranks(name: str) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


#: op overload → what it is charged as (:func:`_classify`)
_KINDS: dict = {}


def _classify(func) -> str:
    """``"view"`` (its outputs alias its inputs by its schema, or a
    collective namespace's op that moves nothing: no launch), ``"alloc"``
    (allocates, launches nothing), ``"collective"``, ``"update"``
    (an in-place update, charged 2 × the update), a product's or a conv's
    name (FLOPs besides its bytes), ``"mutable"`` (another in-place op)
    or ``"op"`` (a launch unless its outputs alias its inputs)."""
    ns, name = func.namespace, func.__name__.split(".")[0]
    if ns in ("c10d", "_c10d_functional"):
        if name in _COLLECTIVE_FREE:
            return "view"
        if (ns, name) not in _COLLECTIVES:
            raise NotImplementedError(
                f"StepCounter does not know the collective {ns}.{name}")
        return "collective"
    if func.is_view:
        return "view"
    if name in _ALLOCATIONS:
        return "alloc"
    if name in _UPDATES:
        return "update"
    if name in _PRODUCTS or name in _CONVS:
        return name
    if any(a.alias_info is not None and a.alias_info.is_write
           for a in func._schema.arguments):
        return "mutable"
    return "op"


@dataclasses.dataclass
class GraphStats:
    """One step's per-device counts, with ``HloStats``' fields and meaning
    (``kernel_calls`` in place of ``loop_trips``; the bytes of the
    arguments, the outputs and the peak besides)."""

    dot_flops: float = 0.0
    conv_flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    #: (dtype, last two dims of the op's first output) → bytes
    traffic_by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    #: (kind, dtype, dims of the counted buffer) → bytes
    collective_by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    #: process group name → bytes, and its global ranks
    collective_by_group: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    group_ranks: dict = dataclasses.field(default_factory=dict)
    #: product FLOPs by the dtype they run in
    product_flops_by_dtype: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    #: kernel name → {"launches", "flops", "bytes", "seconds"}
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    #: the arguments' storages the step never read
    unread_argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def kernel_flops(self) -> float:
        return sum(c["flops"] for c in self.kernel_calls.values())

    @property
    def flops(self) -> float:
        return self.dot_flops + self.conv_flops + self.kernel_flops

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def compute_s(self) -> float:
        """Each product at its dtype's peak, each kernel at its own."""
        return (sum(f / roofline.peak_rate(getattr(torch, dt))
                    for dt, f in self.product_flops_by_dtype.items())
                + sum(c["seconds"] for c in self.kernel_calls.values()))

    def memory_s(self) -> float:
        return self.memory_bytes / roofline.HBM_BYTES_PER_S

    def collective_s(self) -> float:
        """Each group's bytes over its link (``roofline.link_rate``)."""
        return sum(b / roofline.link_rate(self.group_ranks[g])
                   for g, b in self.collective_by_group.items())

    def summary(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "conv_flops": self.conv_flops,
            "kernel_flops": self.kernel_flops,
            "memory_bytes": self.memory_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "kernel_calls": {k: dict(v) for k, v in self.kernel_calls.items()},
            "argument_bytes": self.argument_bytes,
            "unread_argument_bytes": self.unread_argument_bytes,
            "output_bytes": self.output_bytes,
            "peak_bytes": self.peak_bytes,
        }


class StepCounter(TorchDispatchMode):
    """Counts what a step launches while it is active (``with counter:``).

    Call :meth:`arguments` with the step's arguments before the step and
    :meth:`outputs` with its result after it; ``stats`` holds the counts.
    Ops on tensor subclasses (DTensor) pass through to the subclass, whose
    local ops then come back here: the counts are this rank's."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = GraphStats()
        self._owned: dict = {}
        #: the bytes alive besides the arguments read, now and at most
        self._live = 0
        self._top = 0
        #: the arguments' storages not read yet → their bytes
        self._unread: dict = {}

    # -- storages and the peak ---------------------------------------------

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live from now until it dies → its
        bytes (0 if it already was)."""
        if type(t) is not torch.Tensor and not isinstance(
                t, torch.nn.Parameter):
            t = getattr(t, "_local_tensor", None)
            if t is None:
                return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owned:
            return 0
        n = st.nbytes()
        self._owned[key] = n
        self._live += n
        self._top = max(self._top, self._live)
        self.stats.peak_bytes = self.stats.argument_bytes + self._top
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key) -> None:
        self._live -= self._owned.pop(key, 0)
        self._unread.pop(key, None)

    def _storages(self, trees) -> list:
        """The distinct storages' bytes of the tensors in ``trees`` (a
        DTensor's: its local shard's)."""
        seen, out = set(), []
        for tree in trees:
            for _, leaf in tree_flatten_with_path(tree):
                if not isinstance(leaf, torch.Tensor):
                    continue
                local = getattr(leaf, "_local_tensor", leaf)
                st = local.untyped_storage()
                if st._cdata not in seen:
                    seen.add(st._cdata)
                    out.append((local, st.nbytes()))
        return out

    def arguments(self, *trees) -> None:
        """The step's arguments, this rank's local shards.  A storage of
        theirs counts in ``argument_bytes``, and is live from the start,
        once an op of the step reads it (:meth:`_read`); until then it is
        in ``unread_argument_bytes``.  The caller holds them through the
        step."""
        for local, n in self._storages(trees):
            st = local.untyped_storage()
            self._owned[st._cdata] = 0        # never the step's own
            self._unread[st._cdata] = n
            weakref.finalize(st, self._release, st._cdata)
        self.stats.unread_argument_bytes = sum(self._unread.values())

    def _read(self, tensors) -> None:
        """The step reads ``tensors``: an argument's storage among them
        counts from now on."""
        for t in tensors:
            n = self._unread.pop(t.untyped_storage()._cdata, None)
            if n is not None:
                self.stats.argument_bytes += n
                self.stats.unread_argument_bytes -= n
                self.stats.peak_bytes = self.stats.argument_bytes + self._top

    def outputs(self, *trees) -> None:
        """The step's results: their storages' bytes."""
        self.stats.output_bytes = sum(n for _, n in self._storages(trees))

    # -- the ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)      # DTensor's sharding planner
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _classify(func)
        if kind == "view":
            return out
        outs = _tensors(out)
        if kind != "alloc":
            if self._unread:
                self._read(_tensors(args) + _tensors(list(kwargs.values())))
            self._charge(func, kind, args, kwargs, outs)
        for t in outs:
            self._hold(t)
        return out

    def _traffic(self, n_bytes: float, like: torch.Tensor | None) -> None:
        s = self.stats
        s.memory_bytes += n_bytes
        if like is not None:
            s.traffic_by_shape[_dims_key(like)] += n_bytes

    def _charge(self, func, kind: str, args, kwargs, outs) -> None:
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(list(kwargs.values()))
        if kind == "collective":
            if not self._collective(func, args, kwargs, outs):
                return
        elif kind == "op":
            if not outs and not ins:
                return
            in_storages = {t.untyped_storage()._cdata for t in ins}
            if outs and all(t.untyped_storage()._cdata in in_storages
                            for t in outs):
                return                            # aliases: no launch
        elif kind == "update":
            bound = _bind(func, args, kwargs)
            upd = _tensors(bound.get(_UPDATES[func.__name__.split(".")[0]]))
            rest = [t for t in ins if not any(t is u for u in upd)
                    and not any(t is o for o in outs)]
            n_bytes = 2 * sum(map(_nbytes, upd)) + sum(map(_nbytes, rest))
            self._traffic(n_bytes, outs[0] if outs else None)
            return
        elif kind in _PRODUCTS and outs:
            f = _PRODUCTS[kind](args, outs[0])
            self.stats.dot_flops += f
            self.stats.product_flops_by_dtype[
                str(ins[0].dtype).removeprefix("torch.")] += f
        elif kind in _CONVS and outs:
            f = self._conv_flops(kind, args, outs)
            self.stats.conv_flops += f
            self.stats.product_flops_by_dtype[
                str(ins[0].dtype).removeprefix("torch.")] += f
        self._traffic(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)),
                      (outs or ins)[0])

    @staticmethod
    def _conv_flops(name, args, outs) -> float:
        """2 × output elements × (input channels a group) × taps; the
        backward's input and weight gradients each a forward's worth."""
        if name == "convolution_backward":
            grad_out, _, weight = args[:3]
            mask = args[-1]
            per = 2 * grad_out.numel() * weight[0].numel()
            return per * sum(bool(m) for m in mask[:2])
        weight = args[1]
        return 2 * outs[0].numel() * weight[0].numel()

    def _collective(self, func, args, kwargs, outs) -> bool:
        """Count one collective; False (and nothing counted) for a group of
        one rank, where it moves nothing."""
        kind, arg = _COLLECTIVES[(func.namespace, func.__name__.split(".")[0])]
        bound = _bind(func, args, kwargs)
        group = _group_name(func, bound)
        s = self.stats
        if group not in s.group_ranks:
            s.group_ranks[group] = _group_ranks(group)
        if len(s.group_ranks[group]) == 1:
            return False
        counted = outs if arg is None else _tensors(bound[arg])
        size = sum(map(_nbytes, counted))
        b = size * _COLLECTIVE_FACTOR[kind]
        s.collective_bytes[kind] += b
        s.collective_counts[kind] += 1
        if counted:
            t = counted[0]
            s.collective_by_shape[(kind, str(t.dtype).removeprefix("torch."),
                                   tuple(t.shape))] += b
        s.collective_by_group[group] += b
        return True

    # -- hand-written kernels -------------------------------------------------

    def count_kernel(self, name: str, work: roofline.Work,
                     like: torch.Tensor) -> None:
        """One launch of kernel ``name`` doing ``work``; ``like`` is its
        main output (the traffic's shape key)."""
        c = self.stats.kernel_calls.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0, "seconds": 0.0})
        c["launches"] += 1
        c["flops"] += work.flops
        c["bytes"] += work.bytes
        c["seconds"] += work.flops / work.rate
        self._traffic(work.bytes, like)


#: what :func:`use_compiled_meta_kernels` registered: its Meta library
#: (kept alive) and the ops that keep a Python meta function
_PYTHON_METAS: list = []


def use_compiled_meta_kernels() -> int:
    """Send aten ops on ``meta`` tensors to ATen's compiled Meta kernels
    wherever ATen has one → the number of ops that keep a Python one.

    ``import torch`` registers Python meta functions (``torch._refs`` and
    ``torch._meta_registrations``) over many compiled ones; on ``meta``
    an elementwise op then takes ≈ 0.4 ms of host CPU against ≈ 2 µs
    compiled, and a dry-run's train step makes ~10⁵ of them.  This takes
    down that Python library and registers again only the functions of
    ops ATen has no compiled Meta kernel for; shapes and dtypes are the
    same either way.  Process-global and for good: the dry-run calls it
    in its own process, with its fake world (``dryrun.fake_world``)."""
    if _PYTHON_METAS:
        return len(_PYTHON_METAS[1])
    import torch._meta_registrations as registered
    from torch._decomp import global_decomposition_table

    python_metas = getattr(registered,
                           "_meta_lib_dont_use_me_use_register_meta", None)
    if python_metas is None:        # a torch that registers none this way
        return 0
    table: dict = {}
    for kind in ("meta", "post_autograd", "pre_autograd"):
        for op, fn in global_decomposition_table[kind].items():
            table.setdefault(op, fn)
    python_metas._destroy()
    lib, kept = torch.library.Library("aten", "IMPL", "Meta"), []
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for op, fn in table.items():
        if not isinstance(op, torch._ops.OpOverload) or op.namespace != \
                "aten" or op.is_view:
            continue
        name = op.name()
        if has(name, "Meta") or has(name, "CompositeImplicitAutograd"):
            continue
        lib.impl(op, fn)
        kept.append(name)
    _PYTHON_METAS.extend((lib, kept))
    return len(kept)


def count_step(step, *args):
    """``step(*args)`` once under a fresh :class:`StepCounter` → (its
    result, the counter's :class:`GraphStats`)."""
    counter = StepCounter()
    counter.arguments(*args)
    with counter:
        out = step(*args)
    counter.outputs(out)
    return out, counter.stats
