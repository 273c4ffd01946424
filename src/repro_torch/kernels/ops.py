"""The runtime's consumer of the schedule IR, on PyTorch.

``conv2d_stream`` is the public conv entry point: it resolves
``"SAME"``/``"VALID"``/explicit padding and hands the unpadded frame to
the hand-written CUDA kernel (``repro_torch.kernels.conv2d_stream``) —
every conv on a CUDA tensor, batched or not, integer or float, goes
through that kernel.  ``conv2d_same_mm`` (per-tap shifted-window
products) stays as a CPU function the tests hold bit-exact against it.

``flash_attention`` is the LM path's attention entry point: it hands
``(B·H, S, D)`` views to the hand-written CUDA kernels
(``repro_torch.kernels.flash_attention``), differentiable through their
``FlashAttention`` function (the backward is a kernel too).  The other
three kernels have no backward yet and refuse to run under autograd on
the card.  ``fused_mlp`` and
``mamba2_ssd`` fold and check their inputs as the reference's wrappers do
and hand them to the hand-written fused-MLP and SSD kernels
(``repro_torch.kernels.fused_mlp`` / ``mamba2_ssd``).

``lower_group`` / ``run_compiled`` / ``run_compiled_batched`` are the
device duals of the HLS emitter: they consume the *same*
:class:`repro_torch.core.compile_driver.CompiledDesign` the FPGA path
emits from — each :class:`GroupSchedule` lowers to one executable
(streaming conv kernels with fused epilogues, MAC reductions,
elementwise tails), and the runners chain the groups through a value
environment exactly as the emitted ``host_schedule.cpp`` threads DRAM
spill buffers.

**The batch axis is always present.**  Inside a group executable every
non-constant value carries a leading batch axis — ``(B,) + compiled
shape``, a single sample being batch 1 — while constants stay unbatched.
Convs and pools fold it into N, MAC reductions fold it into the row
axis, reorders shift their permutation by one, and elementwise ops rely
on right-aligned broadcasting.  A batched run is therefore the same code
on the same kernel in the same summation order as a per-sample loop:
bit-identical, floats included.

**MAC reductions** (Dense layers: ``ac,cb->ab`` with a constant right
operand) run through the conv kernel as a 1×1 conv over a ``(1, 1, M,
K)`` frame.  That is exact for every integer width (products mod 2³²,
like the reference) where ``torch.matmul``/``einsum`` raise for integer
CUDA tensors, and it keeps batched == loop bit-exact for floats.  Other
contraction shapes fall back to ``torch.einsum`` (floats anywhere,
integers on the CPU only).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time

import torch

import repro_torch.instrument as instrument
from repro_torch.instrument import metrics as _metrics

from repro_torch.core.analysis import (
    KernelClass,
    classify_kernel,
    conv_spatial_pads,
    einsum_spec,
    reorder_spec,
    window_geometry,
)
from repro_torch.core.ir import PayloadKind
from repro_torch.device import env_to_device, resolve_device, synchronize
from . import conv2d_stream as _conv
from . import flash_attention as _flash
from . import fused_mlp as _mlp
from . import mamba2_ssd as _ssd
from . import ref as _ref


# ---------------------------------------------------------------------------
# kernels with no backward
# ---------------------------------------------------------------------------


def _refuse_grad(name: str, item: str, *tensors) -> None:
    """A kernel writes its output through ``ctypes`` into a fresh tensor
    that autograd does not see: on CUDA tensors under autograd (grad
    enabled and an input that requires grad) that output would silently
    drop every gradient upstream of it.  Raise instead, naming the ROADMAP
    item that brings the kernel's backward.  The plain versions on the CPU
    are differentiable and pass."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_cuda and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet: it cannot run under "
            f"autograd on the card (ROADMAP.md §A {item})")


# ---------------------------------------------------------------------------
# conv2d_stream
# ---------------------------------------------------------------------------


Padding = str | tuple[tuple[int, int], tuple[int, int]]

#: ``padding`` → explicit ((top, bottom), (left, right)); see ``ref.conv_pads``
_conv_pads = _ref.conv_pads


def conv2d_stream(
    x: torch.Tensor,            # (B, H, W, Cin)
    w: torch.Tensor,            # (KH, KW, Cin, Cout)
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    fuse_relu: bool = False,
    epilogue: str | None = None,
    rows_per_block: int | None = None,
) -> torch.Tensor:
    """NHWC conv via the line-buffer streaming kernel (stride-s, SAME /
    VALID / explicit pads).

    Returns int32 accumulators for integer inputs (the paper's int8 PTQ
    path; wrapping mod 2³²), f32 otherwise — requantization is the
    caller's (graph's) concern.

    ``epilogue`` fuses an elementwise tail into the kernel's writeback
    (``"relu"`` | ``"squared_relu"``) — the realization of the pass
    pipeline's conv+activation fusion; ``fuse_relu=True`` remains as
    sugar for ``epilogue="relu"``.  ``rows_per_block`` is the number of
    output rows per band a thread block walks (default: chosen by
    ``plan_conv_rows``); results do not depend on it.

    The operands decide where it runs: CUDA tensors launch the kernel
    (or raise), CPU tensors take its plain version.  The kernel has no
    backward: under autograd on CUDA tensors it raises
    NotImplementedError.
    """
    _refuse_grad("conv2d_stream", "item 4g (the reference trains no CNN)",
                 x, w)
    if fuse_relu:
        if epilogue not in (None, "relu"):
            raise ValueError("fuse_relu=True conflicts with epilogue="
                             f"{epilogue!r}")
        epilogue = "relu"
    _, h, ww, _ = x.shape
    kh, kw, _, _ = w.shape
    pads = _conv_pads(h, ww, kh, kw, stride, padding)
    return _conv.conv2d_stream(
        x, w, stride=stride, pads=pads, epilogue=epilogue,
        rows_per_block=rows_per_block,
    )


def conv2d_same_mm(
    x: torch.Tensor, w: torch.Tensor, *,
    stride: int = 1, padding: Padding = "SAME",
) -> torch.Tensor:
    """NHWC conv as KH·KW shifted channel matmuls, on the CPU.

    One ``(N·H·W, Cin) @ (Cin, Cout)`` product per kernel tap,
    accumulated in **int32** (operands cast first, so sub-int32 inputs
    get real int32 accumulators and overflow wraps identically
    everywhere) or f32.  In the reference package this is the batched
    integer lowering; here every conv on the card goes through the
    kernel, and this function remains as the independent CPU
    formulation the tests hold bit-exact against ``conv2d_stream`` for
    integers."""
    if x.is_cuda:
        raise RuntimeError(
            "conv2d_same_mm is a CPU function; on the card every conv "
            "goes through conv2d_stream")
    kh, kw, _, _ = w.shape
    _, h, wd, _ = x.shape
    pads = _conv_pads(h, wd, kh, kw, stride, padding)
    return _conv.conv2d_stream_plain(x, w, stride, pads, None)


def mac_reduce(spec: str, operands, batched) -> torch.Tensor:
    """A regular MAC reduction described by an einsum ``spec`` over
    ``operands``; ``batched[i]`` says whether operand ``i`` carries the
    leading batch axis (the result always does).

    The Dense form — two rank-2 operands ``ik,kj->ij``, left batched,
    right constant — folds the batch into the rows and runs through the
    conv kernel as a 1×1 conv (see the module docstring); anything else
    goes to ``torch.einsum`` with a batch letter on the batched
    operands."""
    ins, out = spec.split("->")
    subs = ins.split(",")
    if (
        len(operands) == 2 and batched[0] and not batched[1]
        and len(subs[0]) == 2 and len(subs[1]) == 2 and len(out) == 2
        and subs[0][1] == subs[1][0] and subs[0][0] == out[0]
        and subs[1][1] == out[1] and len(set(subs[0] + subs[1])) == 3
    ):
        a, wgt = operands
        bsz, m, k = a.shape
        if a.dtype != wgt.dtype:
            common = torch.promote_types(a.dtype, wgt.dtype)
            a, wgt = a.to(common), wgt.to(common)
        y = _conv.conv2d_stream(
            a.reshape(1, 1, bsz * m, k), wgt.reshape(1, 1, k, -1))
        return y.reshape(bsz, m, -1)
    if any(t.is_cuda and _ref.is_integer(t) for t in operands):
        raise NotImplementedError(
            f"integer MAC reduction {spec!r} has no CUDA lowering (only "
            "the Dense form 'ik,kj->ij' with a constant right operand)")
    letters = ",".join(("z" + s) if bt else s for s, bt in zip(subs, batched))
    res = torch.einsum(f"{letters}->z{out}", *operands)
    return res


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Schedule-IR consumer: one fused executable per GroupSchedule
# ---------------------------------------------------------------------------

#: epilogue kinds the conv kernel applies *inside* the CUDA kernel
#: (on the register accumulator, before the store)
_IN_KERNEL_EPILOGUES = {
    PayloadKind.RELU: "relu",
    PayloadKind.SQUARED_RELU: "squared_relu",
}


def _split_conv_epilogue(op):
    """(in-kernel epilogue string, remaining epilogue entries) for a
    conv node: a leading unary relu/squared_relu runs on the kernel's
    accumulator; everything after (constant binops, fused pools) applies
    to the kernel's output inside the same group executable."""
    epi = list(op.epilogue)
    if epi and epi[0].operand is None and not epi[0].window and (
        epi[0].kind in _IN_KERNEL_EPILOGUES
    ):
        return _IN_KERNEL_EPILOGUES[epi[0].kind], epi[1:]
    return None, epi


def _weight_tile_axes(op, dfg):
    """(const input name, const tensor axis, output tensor axis) for the
    *leading* weight-tileable dim of a streamed-weight node — the axis
    the DSE's ``weight_tiles`` splits the const buffer along (c_out for
    an NHWC conv, n_out for a matmul; ``NodePlan.weight_tile_dims[0]``,
    recomputed here from the maps).  ``None`` when no safe tile axis
    exists (the untiled lowering is numerically identical either way)."""
    info = classify_kernel(op)
    window = set(info.classes.window)
    cands = []  # (dim, input index, input name, const axis, output axis)
    for i, name in enumerate(op.inputs):
        if not dfg.values[name].is_constant:
            continue
        for pos, expr in enumerate(op.input_maps[i].results):
            if not expr.is_single_dim():
                continue
            (d, _), = expr.terms
            if not (op.is_parallel_dim(d) and d not in window):
                continue
            out_axis = next(
                (
                    q for q, oe in enumerate(op.output_map.results)
                    if oe.is_single_dim() and oe.terms[0][0] == d
                ),
                None,
            )
            if out_axis is not None:
                cands.append((d, i, name, pos, out_axis))
    if not cands:
        return None
    d, i, name, pos, out_axis = min(cands)  # leading dim, like plan_node
    # slicing one operand is only sound if no other input reads dim d
    for j, other in enumerate(op.inputs):
        if j == i:
            continue
        if any(d in expr.dims() for expr in op.input_maps[j].results):
            return None
    return name, pos, out_axis


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W, C) → (B·N, H, W, C): the batch folds into N."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(y: torch.Tensor, batch: int) -> torch.Tensor:
    return y.reshape((batch, y.shape[0] // batch) + tuple(y.shape[1:]))


def execute_reorder_batched(op, x: torch.Tensor) -> torch.Tensor:
    """Transpose / flatten of a value with a leading batch axis: the
    reorder's own axes all shift by one."""
    kind, arg = reorder_spec(op)
    if kind == "transpose":
        return x.permute((0,) + tuple(p + 1 for p in arg))
    # flatten: bring the non-batch axes into linearization order, then
    # collapse them row-major
    y = x.permute((0, 1) + tuple(p + 1 for p in arg))
    return y.reshape(x.shape[0], x.shape[1], -1)


def _lower_node(op, dfg, env, weight_tiles: int = 1):
    """Execute one GenericOp with the kernel library.  Non-constant
    values in ``env`` carry a leading batch axis, constants do not.

    ``weight_tiles > 1`` honors the schedule's partial weight streaming:
    the const operand is processed in output-channel tiles (the stand-in
    for the HLS kernel's double-buffered DRAM ``wtile`` loop) and the
    partial results concatenated — bit-exact with the resident lowering,
    but structurally the same tiled schedule the emitter realizes.  The
    tiles are strided views of the weight; the conv wrapper makes them
    contiguous.
    """
    if weight_tiles > 1:
        tiled = _weight_tile_axes(op, dfg)
        if tiled is not None:
            cname, cax, oax = tiled
            w = env[cname]
            if w.shape[cax] % weight_tiles == 0:
                bare = dataclasses.replace(op, epilogue=())
                step = w.shape[cax] // weight_tiles
                parts = [
                    _lower_node(
                        bare, dfg,
                        {**env, cname: w.narrow(cax, t * step, step)},
                    )
                    for t in range(weight_tiles)
                ]
                out = torch.cat(parts, dim=oax + 1)  # +1: the batch axis
                return _ref.apply_epilogue(out, op.epilogue, env)
    info = classify_kernel(op)
    if info.kernel_class == KernelClass.SLIDING_WINDOW:
        if op.payload == PayloadKind.MAC:
            stream = [i for i in op.inputs if not dfg.values[i].is_constant]
            const = [i for i in op.inputs if dfg.values[i].is_constant]
            if (
                len(stream) == 1 and len(const) == 1
                and op.n_dims == 7 and info.dilation == 1
            ):
                x_b = env[stream[0]]
                x_in = _fold(x_b)
                # the maps determine the reach; whatever exceeds the
                # actual input extent is the zero-padding frame (SAME
                # splits end-heavy, VALID reads within bounds -> (0,0))
                pads = conv_spatial_pads(op, tuple(x_b.shape[1:]))
                kern_epi, rest = _split_conv_epilogue(op)
                wgt = env[const[0]]
                if x_in.dtype != wgt.dtype:
                    common = torch.promote_types(x_in.dtype, wgt.dtype)
                    x_in, wgt = x_in.to(common), wgt.to(common)
                out = conv2d_stream(
                    x_in, wgt, stride=info.stride,
                    padding=(pads[1], pads[2]), epilogue=kern_epi,
                )
                out = _unfold(out, x_b.shape[0])
                return _ref.apply_epilogue(out, rest, env)
            # keep parity with the interpreter: fail loudly rather
            # than silently computing a dilation-1 conv
            raise NotImplementedError(
                f"{op.name}: unsupported conv form in lower_group"
            )
        if (
            op.payload in (PayloadKind.MAX, PayloadKind.AVG)
            and len(op.inputs) == 1
        ):
            geo = window_geometry(op, info)
            kh, kw = geo.window_extents
            pool = (
                _ref.maxpool2d if op.payload == PayloadKind.MAX
                else _ref.avgpool2d
            )
            x_b = env[op.inputs[0]]
            out = _unfold(pool(_fold(x_b), kh, kw, info.stride), x_b.shape[0])
            return _ref.apply_epilogue(out, op.epilogue, env)
        raise NotImplementedError(f"{op.name}: unsupported sliding window")
    if info.kernel_class == KernelClass.REGULAR_REDUCTION:
        if op.payload != PayloadKind.MAC:
            raise NotImplementedError(f"{op.name}: non-MAC reduction")
        out = mac_reduce(
            einsum_spec(op), [env[i] for i in op.inputs],
            [not dfg.values[i].is_constant for i in op.inputs],
        )
        return _ref.apply_epilogue(out, op.epilogue, env)
    # PURE_PARALLEL
    if reorder_spec(op) is not None:
        out = execute_reorder_batched(op, env[op.inputs[0]])
        return _ref.apply_epilogue(out, op.epilogue, env)
    args = [env[i] for i in op.inputs]
    if len(args) == 1:
        out = _ref.unary(op.payload, args[0])
    elif len(args) == 2:
        out = _ref.binary(op.payload, args[0], args[1])
    else:
        raise NotImplementedError(f"{op.name}: {len(args)}-ary elementwise")
    return _ref.apply_epilogue(out, op.epilogue, env)


#: executables per group *structure* — repeated ``run_compiled`` calls
#: (batched inference, benchmark sweeps) reuse the lowered closure
#: instead of rebuilding it per call.  PyTorch runs eagerly, so an
#: "executable" is a plain closure (CUDA graphs are later work); the
#: cache, its keys and its hit/miss/eviction counters keep the shape the
#: ``jit_cache`` tracer series and ``last_run_stats`` report.
#: A true LRU: hits refresh recency, inserts beyond the cap evict the
#: least-recently-used executable — across many signatures × batch
#: buckets the cache stays bounded instead of growing forever.
_EXEC_CACHE: "collections.OrderedDict[tuple, object]" = \
    collections.OrderedDict()
_EXEC_CACHE_CAP = 128
#: ServeEngine worker threads hit lower_group concurrently with
#: main-thread runs; the LRU mutates on every access (move_to_end /
#: popitem), so lookup+insert+stats form one critical section.
_EXEC_CACHE_LOCK = threading.Lock()
#: observability for tests and benchmarks (evictions included)
exec_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}


#: the batch extents batched executables are built for: a batched run
#: pads its batch up to the nearest bucket (and chunks above the top
#: one), so at most ``len(BATCH_BUCKETS)`` builds happen per group
#: signature no matter what batch sizes traffic brings.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def batch_bucket(n: int) -> int:
    """The padded batch extent ``n`` executes at: the smallest bucket
    ≥ ``n``.  ``n`` must not exceed the top bucket (the runner chunks
    larger batches before bucketing)."""
    if n < 1:
        raise ValueError(f"batch extent must be >= 1, got {n}")
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"batch extent {n} exceeds the top bucket {BATCH_BUCKETS[-1]} — "
        "chunk the batch first (run_compiled_batched does)"
    )


def _batch_chunks(batch: int):
    """Split ``batch`` into (start, n, bucket) chunks of at most the
    top bucket each, so any offered batch executes with a bounded set
    of shapes."""
    cap = BATCH_BUCKETS[-1]
    start = 0
    while start < batch:
        n = min(batch - start, cap)
        yield start, n, batch_bucket(n)
        start += n


def _group_signature(group) -> tuple:
    """Hashable identity of everything the lowered executable depends
    on: node structure (maps, iterators, payloads, epilogues), value
    shapes/bits/names (env keys!) and the group's streamed-weight
    tiling.  Constants arrive through ``env`` at call time, so they are
    deliberately *not* part of the key."""
    dfg = group.dfg
    sig: list = [tuple(dfg.graph_inputs), tuple(dfg.graph_outputs)]
    for op in dfg.topo_order():
        sig.append((
            op.name,
            op.inputs,
            op.output,
            tuple(str(m) for m in op.indexing_maps),
            tuple(t.value for t in op.iterator_types),
            op.dim_sizes,
            op.payload.value,
            op.elem_bits,
            tuple(
                (e.kind.value, e.operand, tuple(e.window) if e.window else ())
                for e in op.epilogue
            ),
            group.dse.weight_tiles.get(op.name, 1),
            tuple(
                (v, dfg.values[v].shape, dfg.values[v].elem_bits,
                 dfg.values[v].is_constant)
                for v in op.inputs + (op.output,)
            ),
        ))
    return tuple(sig)


def _build_group_fn(group, batch: int | None = None):
    """The uncached lowering — separable so tests can probe build
    counts.

    The returned ``fn(env)`` takes non-constant entries with a leading
    batch axis when ``batch`` is given (of that extent) and without one
    otherwise (a single sample: the axis is added on entry and dropped
    from the outputs) — inside, the batch axis is always present, so
    both forms run the very same lowering."""
    dfg = group.dfg
    order = dfg.topo_order()
    tiles = dict(group.dse.weight_tiles)
    needed = set(dfg.graph_inputs) | {
        v for v, val in dfg.values.items() if val.is_constant
    }
    streamed = {k for k in needed if not dfg.values[k].is_constant}

    def run(env):
        env = {k: v for k, v in env.items() if k in needed}
        if batch is None:
            for k in streamed:
                env[k] = env[k].unsqueeze(0)
        for op in order:
            env[op.output] = _lower_node(
                op, dfg, env, weight_tiles=tiles.get(op.name, 1),
            )
        if batch is None:
            return {v: env[v].squeeze(0) for v in dfg.graph_outputs}
        return {v: env[v] for v in dfg.graph_outputs}

    return run


def lower_group(group, *, batch: int | None = None):
    """Lower one :class:`~repro_torch.core.compile_driver.GroupSchedule`
    to an executable: ``fn(env) -> {output name: tensor}``.

    ``env`` must bind the group's graph inputs (spill values included)
    and constants, as tensors on one device; the tensors decide where
    the group runs.  All nodes of the group run back to back on the
    current stream — the analogue of the group's single DATAFLOW
    kernel: epilogues (activations, constant binops, fused pools) ride
    the producing conv; weight-streamed nodes run the tiled const-buffer
    schedule.  Executables are cached (LRU) per group signature (+ batch
    bucket), so recompiling or re-running the same design never rebuilds
    them (:func:`_build_group_fn` is the uncached lowering).

    ``batch`` asks for the batched executable at exactly that
    (bucketed!) batch extent: non-constant env entries must carry a
    leading axis of that extent, outputs gain one.  Callers round to a
    :data:`BATCH_BUCKETS` bucket first so the cache sees a bounded key
    set (``run_compiled_batched`` handles padding/chunking).
    """
    key = _group_signature(group) + ("batch", batch)
    with _EXEC_CACHE_LOCK:
        fn = _EXEC_CACHE.get(key)
        if fn is None:
            exec_cache_stats["misses"] += 1
            event = "miss"
            # building is cheap (a closure), so holding the lock keeps
            # the insert/evict atomic
            fn = _build_group_fn(group, batch=batch)
            while len(_EXEC_CACHE) >= _EXEC_CACHE_CAP:  # LRU eviction
                _EXEC_CACHE.popitem(last=False)
                exec_cache_stats["evictions"] += 1
            _EXEC_CACHE[key] = fn
        else:
            _EXEC_CACHE.move_to_end(key)
            exec_cache_stats["hits"] += 1
            event = "hit"
        stats_snapshot = dict(exec_cache_stats)
    tracer = instrument.current()
    if tracer.enabled:
        tracer.instant("jit_cache", cat="runtime",
                       args={"group": group.name, "event": event,
                             "batch": batch})
        tracer.counter("jit_cache", stats_snapshot)
    return fn


def _cache_outcome(before: dict) -> str:
    return "hit" if exec_cache_stats["hits"] > before["hits"] else "miss"


def run_compiled(design, env, *, device=None,
                 stats_out: dict | None = None) -> dict:
    """Execute a :class:`~repro_torch.core.compile_driver.CompiledDesign`:
    groups run in schedule order, chained through the value environment
    (the dict entries standing in for the DRAM spill buffers of
    ``host_schedule.cpp``).  ``env`` entries (NumPy arrays or tensors,
    per-sample shapes) are moved to ``device`` at this boundary
    (``None`` → the CUDA card; no card → error).  Returns the graph
    outputs as tensors on that device.

    ``stats_out``: pass a dict to collect runtime counters — per-group
    wall time + exec-cache outcome, the exec-cache hit/miss delta of
    this call, and the modeled boundary-DMA bytes per group transition.
    Counter collection (also active whenever a tracer is installed)
    synchronizes the device after each group so per-group wall times
    measure execution, not the enqueue; the uninstrumented path is
    untouched.
    """
    dev = resolve_device(device)
    tracer = instrument.current()
    reg = _metrics.current()
    collect = stats_out is not None or tracer.enabled or reg.enabled
    env = env_to_device(env, dev)
    if not collect:
        for g in design.groups:
            env.update(lower_group(g)(env))
        return {v: env[v] for v in design.source.graph_outputs}
    m_wall = reg.histogram("run_group_wall_ms",
                           "per-group execution wall time (ms)",
                           labels=("group",))
    m_dma = reg.counter("run_dma_bytes_total",
                        "modeled boundary-DMA bytes", labels=("direction",))

    before = dict(exec_cache_stats)
    transitions = design.boundary_traffic()
    rows = []
    t_run0 = time.perf_counter()
    for idx, g in enumerate(design.groups):
        g_before = dict(exec_cache_stats)
        t0 = time.perf_counter()
        with tracer.span(f"run:{g.name}", cat="runtime") as sargs:
            out = lower_group(g)(env)
            synchronize(dev)
            env.update(out)
            row = {"group": g.name, "jit_cache": _cache_outcome(g_before)}
            if idx < len(transitions):
                w, r = transitions[idx]
                row["dma_write_bytes"] = w
                row["dma_read_bytes"] = r
                tracer.counter("dma_bytes", {"write": w, "read": r})
                if reg.enabled:
                    m_dma.inc(w, direction="write")
                    m_dma.inc(r, direction="read")
            sargs.update(row)
        row["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        if reg.enabled:
            m_wall.observe(row["wall_ms"], group=g.name)
        rows.append(row)
    if stats_out is not None:
        stats_out.update({
            "groups": rows,
            "wall_ms": round((time.perf_counter() - t_run0) * 1e3, 3),
            "exec_cache": {
                "hits": exec_cache_stats["hits"] - before["hits"],
                "misses": exec_cache_stats["misses"] - before["misses"],
            },
            "dma_write_bytes": sum(w for w, _ in transitions),
            "dma_read_bytes": sum(r for _, r in transitions),
        })
    return {v: env[v] for v in design.source.graph_outputs}


def run_compiled_batched(design, env, batch: int, *, device=None,
                         stats_out: dict | None = None) -> dict:
    """Execute a :class:`~repro_torch.core.compile_driver.CompiledDesign`
    over a batch: every non-constant entry of ``env`` carries a leading
    axis of extent ``batch``; constants are per-design.  Groups run in
    schedule order through batched executables (:func:`lower_group` with
    ``batch=``) — one kernel launch per conv for the whole batch: the
    batch is padded up to the nearest :data:`BATCH_BUCKETS` bucket (zero
    rows, sliced off the outputs before return, still on device) and
    chunked above the top bucket, so each group is built at most once
    per bucket.  Returns the graph outputs as tensors on ``device`` with
    a leading batch axis — the host conversion happens once at the
    caller's boundary, never per sample.
    """
    dev = resolve_device(device)
    tracer = instrument.current()
    reg = _metrics.current()
    collect = stats_out is not None or tracer.enabled or reg.enabled
    if reg.enabled:
        m_wall = reg.histogram("run_group_wall_ms",
                               "per-group execution wall time (ms)",
                               labels=("group",))
        m_dma = reg.counter("run_dma_bytes_total",
                            "modeled boundary-DMA bytes",
                            labels=("direction",))
    src = design.source
    env = env_to_device(env, dev)
    stream = [k for k in env
              if k in src.values and not src.values[k].is_constant]
    const_env = {k: v for k, v in env.items() if k not in stream}

    before = dict(exec_cache_stats)
    transitions = design.boundary_traffic()
    group_rows: dict[str, dict] = {}
    buckets: list[int] = []
    t_run0 = time.perf_counter()
    chunks_out: list[dict] = []
    for start, n, bucket in _batch_chunks(batch):
        buckets.append(bucket)
        chunk_env = dict(const_env)
        for k in stream:
            v = env[k][start:start + n]
            if bucket != n:
                pad = v.new_zeros((bucket - n,) + tuple(v.shape[1:]))
                chunk_env[k] = torch.cat([v, pad], dim=0)
            else:
                chunk_env[k] = v
        for idx, g in enumerate(design.groups):
            fn = lower_group(g, batch=bucket)
            if not collect:
                chunk_env.update(fn(chunk_env))
                continue
            g_before = dict(exec_cache_stats)
            t0 = time.perf_counter()
            with tracer.span(f"run:{g.name}", cat="runtime") as sargs:
                out = fn(chunk_env)
                synchronize(dev)
                chunk_env.update(out)
                row = group_rows.setdefault(
                    g.name, {"group": g.name, "wall_ms": 0.0, "samples": 0}
                )
                row["samples"] += n
                row["jit_cache"] = _cache_outcome(g_before)
                sargs.update({"group": g.name, "batch": n, "bucket": bucket,
                              "jit_cache": row["jit_cache"]})
                if idx < len(transitions):
                    w, r = transitions[idx]
                    sargs.update({"dma_write_bytes": w * n,
                                  "dma_read_bytes": r * n})
                    tracer.counter("dma_bytes",
                                   {"write": w * n, "read": r * n})
                    if reg.enabled:
                        m_dma.inc(w * n, direction="write")
                        m_dma.inc(r * n, direction="read")
            step_ms = (time.perf_counter() - t0) * 1e3
            if reg.enabled:
                m_wall.observe(step_ms, group=g.name)
            row["wall_ms"] = round(row["wall_ms"] + step_ms, 3)
        outs = {v: chunk_env[v] for v in src.graph_outputs}
        if bucket != n:  # drop padding rows, still on device
            outs = {k: v[:n] for k, v in outs.items()}
        chunks_out.append(outs)
    if len(chunks_out) == 1:
        result = chunks_out[0]
    else:
        result = {
            k: torch.cat([c[k] for c in chunks_out], dim=0)
            for k in src.graph_outputs
        }
    if stats_out is not None:
        stats_out.update({
            "groups": list(group_rows.values()),
            "wall_ms": round((time.perf_counter() - t_run0) * 1e3, 3),
            "exec_cache": {
                "hits": exec_cache_stats["hits"] - before["hits"],
                "misses": exec_cache_stats["misses"] - before["misses"],
            },
            "batch_buckets": buckets,
            "dma_write_bytes": sum(w for w, _ in transitions) * batch,
            "dma_read_bytes": sum(r for _, r in transitions) * batch,
        })
    return result


# ---------------------------------------------------------------------------
# flash attention (GQA, causal, decode offset)
# ---------------------------------------------------------------------------


#: ``x * scale`` in ``x.dtype``, the scalar rounded to that dtype first
scale_in_dtype = _flash.scale_in_dtype


def flash_attention(
    q: torch.Tensor,        # (B, Hq, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Sk, D)
    v: torch.Tensor,        # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
    block_q: int | None = None,
    block_k: int | None = None,
) -> torch.Tensor:
    """GQA flash attention → ``(B, Hq, Sq, D)`` in ``q.dtype``, through the
    hand-written kernel on a CUDA tensor (its plain version on a CPU one).
    Differentiable: under autograd it is ``FlashAttention`` (the forward
    kernel with ``lse``, the backward kernel for the gradient); without,
    one forward launch as in serving.

    ``q`` is scaled in ``q.dtype`` before the kernel.  ``block_q`` and
    ``block_k`` are only checked — ``Sq``/``Sk`` must be multiples of
    them, so the inputs that the TPU wrapper refuses raise here too — and
    change nothing: the kernel tiles with
    :func:`repro_torch.core.dse.plan_attention_blocks` and masks ragged
    edges itself.  ``None`` (or 0, as in the TPU wrapper) checks nothing:
    there the TPU wrapper picks a divisor of the length."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(
            f"flash_attention: {hq} query heads over {hkv} KV heads")
    scale = scale if scale is not None else d ** -0.5

    if (block_q and sq % block_q) or (block_k and sk % block_k):
        raise ValueError(
            f"flash_attention: Sq {sq} / Sk {sk} are not multiples of "
            f"block_q {block_q} / block_k {block_k}")

    out = _flash.attention(q.reshape(b * hq, sq, d),
                           k.reshape(b * hkv, sk, d),
                           v.reshape(b * hkv, sk, d), heads_q=hq,
                           heads_kv=hkv, causal=causal, q_offset=q_offset,
                           scale=scale)
    return out.reshape(b, hq, sq, d)


# ---------------------------------------------------------------------------
# fused MLP
# ---------------------------------------------------------------------------


def fused_mlp(
    x: torch.Tensor,                  # (..., D)
    w_gate: torch.Tensor | None,      # (D, F) or None
    w_up: torch.Tensor,               # (D, F)
    w_down: torch.Tensor,             # (F, D)
    *,
    act: str = "silu",
    block_m: int | None = None,
    block_f: int | None = None,
) -> torch.Tensor:
    """The (gated) MLP over the last axis of ``x`` → ``x.shape`` in
    ``x.dtype``, through the hand-written kernel on a CUDA tensor (its
    plain version on a CPU one).  Leading axes fold into rows.

    ``block_m`` and ``block_f`` are only checked — the row count and
    ``F`` must be multiples of them, so the inputs the TPU wrapper refuses
    raise ValueError here too — and change nothing: the kernel tiles with
    :func:`repro_torch.core.dse.plan_mlp_blocks`.  ``None`` checks
    nothing (there the TPU wrapper picks a divisor).  Differentiable:
    under autograd it is ``FusedMlp`` (the forward kernel, then the
    backward kernel for the gradients); without, one forward launch as in
    serving."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    f = w_up.shape[1]
    m = math.prod(lead) if lead else 1
    if (block_m and m % block_m) or (block_f and f % block_f):
        raise ValueError(
            f"fused_mlp: M {m} / F {f} are not multiples of block_m "
            f"{block_m} / block_f {block_f}")
    out = _mlp.mlp(x.reshape(m, d), w_gate, w_up, w_down, act=act)
    return out.reshape(*lead, d)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


def _pick_block(size: int, target: int) -> int:
    """Largest divisor of ``size`` that is ≤ ``target`` (≥ 1)."""
    return max(c for c in range(1, min(size, target) + 1) if size % c == 0)


def mamba2_ssd(
    x: torch.Tensor,            # (B, L, H, P)
    dt: torch.Tensor,           # (B, L, H)
    a: torch.Tensor,            # (H,)
    b_mat: torch.Tensor,        # (B, L, N)
    c_mat: torch.Tensor,        # (B, L, N)
    *,
    init_state: torch.Tensor | None = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked scan → (y (B, L, H, P) in ``x.dtype``, final state
    (B, H, P, N) f32), through the hand-written kernel on a CUDA tensor
    (its plain version, ``ref.ssd_chunked``, on a CPU one).

    ``chunk`` defaults to the largest divisor of ``L`` up to 128 and must
    divide ``L`` (ValueError, where the reference asserts); the kernel
    walks the sequence in its own tiles, so it only gates the call and
    sets the plain version's chunk.  The initial state defaults to zeros
    (f32).  Under autograd (grad enabled and an input that requires it)
    the call goes through ``mamba2_ssd.SsdScan``: the forward kernel saves
    its tile states and the backward kernel gives the six gradients;
    otherwise it is one forward launch, as in serving."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    if chunk is None:
        chunk = _pick_block(l, 128)
    if chunk < 1 or l % chunk:
        raise ValueError(f"mamba2_ssd: chunk {chunk} does not divide L {l}")
    s0 = (init_state if init_state is not None
          else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                           device=x.device))
    return _ssd.ssd_scan(x, dt, a, b_mat, c_mat, s0, chunk=chunk)
