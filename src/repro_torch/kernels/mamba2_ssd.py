"""Mamba-2 SSD (state-space duality) chunked scan for Hopper.

**Replaces** the TPU kernel ``repro/kernels/mamba2_ssd.py::_ssd_kernel``
(reached through ``mamba2_ssd_pallas``).  It computes what that kernel
computes — per chunk, the intra-chunk causal term ``Σ_{s≤t}
exp(cum_t−cum_s)·dt_s·(c_t·b_s)·x_s``, the carried-state term
``exp(cum_t)·c_t·S`` and the state update; ``y`` in ``x.dtype`` and the
final state in f32 — but not block by block.  The TPU's sequential chunk
grid axis becomes a loop inside one block (``csrc/mamba2_ssd.cu``, CUDA
C++ for ``sm_90a``) that keeps one head's ``(P, N)`` state on chip;
heads and batch rows are the parallel blocks.  The chunked scan
is exact for any chunk, so the kernel walks the sequence in its own tiles
(:func:`repro_torch.core.dse.plan_ssd_blocks`) and masks a
ragged last tile: every ``L`` runs.  ``exp`` is taken only for ``s ≤ t``.

**What bounds it on an H100.**  At mamba2-1.3b prefill (B 4, L 1024, H 64,
P 64, N 128, bf16) a call moves ≈ 87 MB (x, b, c, dt, the initial and
final state, y) and does ≈ 10 GFLOP: the bound is bytes, ≈ 26 µs at
3.35 TB/s.  Each block's walk is serial, so the latency of one tile's
chain of products is what a kernel has to shorten.

**What the design does about it.**  x, b and c are read once, from the
column slices the model hands in (their batch and position strides go to
the kernel, so nothing is copied); y is written once.  In bf16 all four
products of a tile (c·bᵀ, the gated intra term, the carried term c·Sᵀ and
the state update) run on the tensor cores (``mma.sync`` m16n8k16, bf16 →
f32); the (P, N) state stays in f32 accumulator registers for the whole
walk; the f32 operands — the gated c·bᵀ, the state and x·w — enter as a
bf16 high part plus a bf16 low part (rounding any of them to bf16 alone
misses the tolerance); the next tile streams in by ``cp.async`` while
this one computes.  In f32 the CUDA cores run the products out of shared
memory (f32 keeps f32 accuracy).

**The backward** (``csrc/mamba2_ssd_bwd.cu``) has no TPU kernel to
replace: the reference trains Mamba-2 by XLA's autodiff of
``src/repro/kernels/ref.py:300 ssd_chunked`` (called at
``src/repro/models/mamba2.py:107``), and this is its counterpart.  The
carried cotangent of the (P, N) state enters a tile's sums in only a few
places, and its recurrence does not depend on the rest, so it is two
kernels: a dS pass that walks each (batch row, head) from the last tile
to the first and writes the cotangent of the state leaving every tile,
then a tile kernel that runs every (batch row, tile, group of heads) in
parallel from that and the state entering the tile — the
forward's own, which it writes when asked (``return_states``; serving
asks for none).  In bf16 both run their products on the tensor cores
(f32 operands as bf16 hi + lo parts), in f32 on the CUDA cores.  It is
deterministic: b and c are shared by every head, so db and dc leave the
tile kernel as partials summed over its group of heads, and ``da`` as
per-(batch row, head, tile) partials, summed here in a fixed order; no
float atomics.  ``exp`` is taken only where ``s ≤ t``, so its gradient
stays finite where the plain version's ``0·inf`` is NaN (``ROADMAP.md``
§C).  :class:`SsdScan` joins forward and backward for autograd;
:func:`ssd_scan` takes it only where a gradient is wanted.

The libraries are built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside each kernel sits its plain PyTorch version,
:func:`mamba2_ssd_plain` (the port's ``ref.ssd_chunked``) and
:func:`mamba2_ssd_bwd_plain` (autograd through it); the wrappers take
them **only** for a tensor that lies on the CPU — on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.dse import plan_ssd_blocks, plan_ssd_bwd_blocks
from repro_torch.kernels import ref, work
from repro_torch.kernels.build import CudaLibrary, refuse_dtensor

#: dtypes of x, b and c the kernel takes → the dtype code of the C
#: interface (dt, a and the states are f32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does) — of the forward, and (``bwd_``) of
#: the backward.  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0
bwd_launches = 0
bwd_plain_cuda_calls = 0

_LOCK = threading.Lock()


def _declare(lib) -> None:
    fn = lib.mamba2_ssd_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_ssd_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib) -> None:
    fn = lib.mamba2_ssd_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_bwd_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_ssd_bwd_error_string.restype = ctypes.c_char_p


#: ``csrc/mamba2_ssd.cu`` → ``build/libmamba2_ssd.so``
LIBRARY = CudaLibrary("mamba2_ssd", _declare)
#: ``csrc/mamba2_ssd_bwd.cu`` → ``build/libmamba2_ssd_bwd.so``
BWD_LIBRARY = CudaLibrary("mamba2_ssd_bwd", _declare_bwd)


def reset_counts() -> None:
    """Zero the launch and plain-call counts of both kernels."""
    global launches, plain_cuda_calls, bwd_launches, bwd_plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0
        bwd_launches = 0
        bwd_plain_cuda_calls = 0


def _check(x, dt, a, b_mat, c_mat, init_state) -> None:
    refuse_dtensor("mamba2_ssd", x, dt, a, b_mat, c_mat, init_state)
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b_mat.ndim != 3 \
            or c_mat.ndim != 3:
        raise ValueError(
            "mamba2_ssd wants x (B, L, H, P), dt (B, L, H), a (H,), b and c "
            f"(B, L, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a.shape)}, {tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    if tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,) or \
            tuple(b_mat.shape) != (bsz, l, n) or \
            tuple(c_mat.shape) != (bsz, l, n) or (
                init_state is not None
                and tuple(init_state.shape) != (bsz, h, p, n)):
        raise ValueError(
            f"mamba2_ssd: shapes do not fit x {tuple(x.shape)}: dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b_mat.shape)},"
            f" c {tuple(c_mat.shape)}, init_state "
            f"{None if init_state is None else tuple(init_state.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"mamba2_ssd: unsupported dtype {x.dtype}")
    if b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(
            f"mamba2_ssd: x {x.dtype}, b {b_mat.dtype}, c {c_mat.dtype}")
    others = [t for t in (dt, a, b_mat, c_mat, init_state) if t is not None]
    if any(t.device != x.device for t in others):
        raise ValueError(
            f"mamba2_ssd: x on {x.device}, operands on "
            f"{[str(t.device) for t in others]}")


def mamba2_ssd_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    init_state: torch.Tensor,
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version:
    :func:`repro_torch.kernels.ref.ssd_chunked` with ``chunk``."""
    global plain_cuda_calls
    if x.is_cuda:
        with _LOCK:
            plain_cuda_calls += 1
    return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk,
                           init_state=init_state)


def _rows(t: torch.Tensor, inner: tuple[int, ...]) -> torch.Tensor:
    """``t`` itself when its trailing axes are contiguous (``inner`` their
    strides), else a contiguous copy: the kernel takes any batch and
    position stride."""
    if tuple(t.stride()[2:]) == inner:
        return t
    return t.contiguous()


def mamba2_ssd(
    x: torch.Tensor,            # (B, L, H, P)
    dt: torch.Tensor,           # (B, L, H)
    a: torch.Tensor,            # (H,)
    b_mat: torch.Tensor,        # (B, L, N)
    c_mat: torch.Tensor,        # (B, L, N)
    init_state: torch.Tensor,   # (B, H, P, N)
    *,
    chunk: int,
    return_states: bool = False,
):
    """The SSD scan → (y (B, L, H, P) in ``x.dtype``, final state (B, H,
    P, N) f32); x, b and c f32 or bf16 (one dtype), dt, a and the state
    cast to f32 (as the reference does first).  With ``return_states``
    also the state entering each of the kernel's tiles of
    ``dse.SSD_BWD_BLOCK_L`` positions, (B, H, n_tiles, P, N) f32 — what
    :func:`mamba2_ssd_bwd` reads — or None on the CPU, where the backward
    is the plain version's.

    On a CUDA tensor this launches the hand-written kernel on the calling
    thread's current stream (and adds one to ``launches``) or raises: an
    unsupported dtype, shapes that do not fit, a head or state wider than
    the kernel's tiles (the planner raises, on the CPU too).  ``chunk`` is
    the plain version's; the kernel tiles by itself.  Only a CPU tensor
    takes :func:`mamba2_ssd_plain`."""
    _check(x, dt, a, b_mat, c_mat, init_state)
    bsz, l, h, p = x.shape
    plan = plan_ssd_blocks(batch=bsz, length=l, heads=h, head_dim=p,
                           state_dim=b_mat.shape[-1],
                           dtype=str(x.dtype).removeprefix("torch."),
                           save_states=return_states)
    if not x.is_cuda and not x.is_meta:
        out = mamba2_ssd_plain(x, dt, a, b_mat, c_mat, init_state,
                               chunk=chunk)
        return (*out, None) if return_states else out
    return launch_plan(x, dt, a, b_mat, c_mat, init_state, plan,
                       return_states=return_states)


def launch_plan(x, dt, a, b_mat, c_mat, init_state, plan, *,
                return_states: bool = False):
    """Launch the kernel on CUDA tensors with a given ``plan`` (what
    :func:`mamba2_ssd` does after planning; a timing harness may hand it
    another of ``dse.SSD_MMA_TILES``).  Adds one to ``launches``.  On
    ``meta`` tensors it launches nothing: the outputs' shapes, and the
    launch's work recorded (``work.record_kernel``)."""
    global launches
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    x = _rows(x, (p, 1))
    b_mat, c_mat = _rows(b_mat, (1,)), _rows(c_mat, (1,))
    dtf = dt.float().contiguous()
    af = a.float().contiguous()
    s0 = init_state.float().contiguous()
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    sf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    blk = plan.blocks
    states = None
    if return_states:
        states = torch.empty((bsz, h, -(-l // blk["block_l"]), p, n),
                             dtype=torch.float32, device=x.device)
    if x.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("mamba2_ssd", work.ssd_work(
            bsz, l, h, p, n, x.dtype, states=return_states), y)
        return (y, sf, states) if return_states else (y, sf)
    lib = LIBRARY.load()

    def launch() -> int:
        return lib.mamba2_ssd_launch(
            x.data_ptr(), dtf.data_ptr(), af.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
            None if states is None else states.data_ptr(),
            _DTYPE_CODES[x.dtype], bsz, l, h, p, n,
            x.stride(0), x.stride(1), b_mat.stride(0), b_mat.stride(1),
            c_mat.stride(0), c_mat.stride(1), blk["block_l"],
            blk["heads_per_block"],
            torch.cuda.current_stream(x.device).cuda_stream,
        )

    rc = _on_device(x, launch)
    if rc != 0:
        msg = lib.mamba2_ssd_error_string(rc).decode()
        raise RuntimeError(
            f"mamba2_ssd launch failed: {msg} (code {rc}); x "
            f"{tuple(x.shape)} N {n} {x.dtype} plan {blk} grid {plan.grid} "
            f"smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return (y, sf, states) if return_states else (y, sf)


def _on_device(x: torch.Tensor, launch):
    """``launch()`` with ``x``'s card current."""
    if x.device.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(x.device):
        return launch()


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def mamba2_ssd_bwd_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    init_state: torch.Tensor,
    y_grad: torch.Tensor,
    state_grad: torch.Tensor | None,
    *,
    chunk: int,
) -> tuple[torch.Tensor, ...]:
    """The backward kernel's plain PyTorch version: ``torch.autograd.grad``
    through :func:`repro_torch.kernels.ref.ssd_chunked` (the reference
    defines the SSD's gradient as autodiff of that function) → (dx, ddt,
    da, db, dc, d_init_state), each in its input's dtype.  Like the
    reference's, it is NaN where ``exp`` of a masked (t, s) difference
    overflows (``ROADMAP.md`` §C)."""
    global bwd_plain_cuda_calls
    if x.is_cuda:
        with _LOCK:
            bwd_plain_cuda_calls += 1
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, dt, a, b_mat, c_mat, init_state)]
        y, sf = ref.ssd_chunked(*ins[:5], chunk=chunk, init_state=ins[5])
        outs, cts = [y], [y_grad.to(y.dtype)]
        if state_grad is not None:
            outs.append(sf)
            cts.append(state_grad.float())
        grads = torch.autograd.grad(outs, ins, cts, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ins))


def mamba2_ssd_bwd(
    x: torch.Tensor,            # (B, L, H, P)
    dt: torch.Tensor,           # (B, L, H)
    a: torch.Tensor,            # (H,)
    b_mat: torch.Tensor,        # (B, L, N)
    c_mat: torch.Tensor,        # (B, L, N)
    init_state: torch.Tensor,   # (B, H, P, N)
    y_grad: torch.Tensor,       # (B, L, H, P)
    state_grad: torch.Tensor | None = None,   # (B, H, P, N); None: zeros
    *,
    chunk: int,
    states: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, da, db, dc, d_init_state) of :func:`mamba2_ssd`'s (y,
    final state) against the cotangents ``y_grad`` and ``state_grad``:
    dx, db and dc in x's dtype, the rest f32.

    On a CUDA tensor this launches the hand-written backward — the dS
    pass, then the tile kernel — on the current stream (and adds one to
    ``bwd_launches``: one per call) or raises; it needs ``states``, the
    forward's tile states (``return_states``).  Only a CPU tensor takes
    :func:`mamba2_ssd_bwd_plain` (with ``chunk``).  Deterministic: the
    same inputs give the same bits."""
    global bwd_launches
    _check(x, dt, a, b_mat, c_mat, init_state)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    dtype = str(x.dtype).removeprefix("torch.")
    plan = plan_ssd_bwd_blocks(batch=bsz, length=l, heads=h, head_dim=p,
                               state_dim=n, dtype=dtype)
    q = plan.blocks["block_l"]
    nt = -(-l // q)
    for name, t, shape in (("y_grad", y_grad, x.shape),
                           ("state_grad", state_grad, (bsz, h, p, n)),
                           ("states", states, (bsz, h, nt, p, n))):
        if t is not None and (tuple(t.shape) != tuple(shape)
                              or t.device != x.device):
            raise ValueError(
                f"mamba2_ssd_bwd: {name} {tuple(t.shape)} on {t.device} "
                f"does not fit x {tuple(x.shape)} on {x.device} (want "
                f"{tuple(shape)})")
    if not x.is_cuda and not x.is_meta:
        return mamba2_ssd_bwd_plain(x, dt, a, b_mat, c_mat, init_state,
                                    y_grad, state_grad, chunk=chunk)
    if states is None:
        raise ValueError("mamba2_ssd_bwd: on the card it needs the "
                         "forward's tile states (return_states=True)")
    x = _rows(x, (p, 1))
    b_mat, c_mat = _rows(b_mat, (1,)), _rows(c_mat, (1,))
    dtf = dt.float().contiguous()
    af = a.float().contiguous()
    dy = y_grad.to(x.dtype).contiguous()
    dsf = None if state_grad is None else state_grad.float().contiguous()
    states = states.float().contiguous()
    dev = x.device
    groups = plan.grids["tile"][2]
    f32 = dict(dtype=torch.float32, device=dev)
    ds_tiles = torch.empty((bsz, h, nt, p, n), **f32)   # the pass's dS_k
    dx = torch.empty((bsz, l, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, l, h), **f32)
    db_part = torch.empty((bsz, groups, l, n), **f32)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty((bsz, h, nt), **f32)
    d_init = torch.empty((bsz, h, p, n), **f32)
    if x.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("mamba2_ssd_bwd", work.ssd_bwd_work(
            bsz, l, h, p, n, x.dtype, state_grad=dsf is not None), dx)
    else:
        lib = BWD_LIBRARY.load()
        rc = _on_device(x, lambda: lib.mamba2_ssd_bwd_launch(
            x.data_ptr(), dtf.data_ptr(), af.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dsf is None else dsf.data_ptr(), ds_tiles.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), db_part.data_ptr(),
            dc_part.data_ptr(), da_part.data_ptr(), d_init.data_ptr(),
            _DTYPE_CODES[x.dtype], bsz, l, h, p, n, x.stride(0),
            x.stride(1), b_mat.stride(0), b_mat.stride(1), c_mat.stride(0),
            c_mat.stride(1), q, *plan.grids["pass"], *plan.grids["tile"],
            torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            msg = lib.mamba2_ssd_bwd_error_string(rc).decode()
            raise RuntimeError(
                f"mamba2_ssd_bwd launch failed: {msg} (code {rc}); x "
                f"{tuple(x.shape)} N {n} {x.dtype} grids {plan.grids} smem "
                f"{plan.smem_bytes}")
        with _LOCK:
            bwd_launches += 1
    # the head groups' (and batch rows' and tiles') partials, summed in a
    # fixed order
    db = db_part.sum(1).to(x.dtype)
    dc = dc_part.sum(1).to(x.dtype)
    return dx, ddt, da_part.sum((0, 2)), db, dc, d_init


class SsdScan(torch.autograd.Function):
    """Differentiable SSD scan → (y, final state): forward
    :func:`mamba2_ssd` with its tile states saved, backward
    :func:`mamba2_ssd_bwd` from them.  Gradients come back in each
    input's dtype (dt, a and the initial state f32, as the forward reads
    them)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, init_state, chunk):
        y, sf, states = mamba2_ssd(x, dt, a, b_mat, c_mat, init_state,
                                   chunk=chunk, return_states=True)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, init_state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, sf

    @staticmethod
    def backward(ctx, y_grad, state_grad):
        x, dt, a, b_mat, c_mat, init_state, states = ctx.saved_tensors
        if y_grad is None:
            y_grad = torch.zeros_like(x)
        grads = mamba2_ssd_bwd(x, dt, a, b_mat, c_mat, init_state, y_grad,
                               state_grad, chunk=ctx.chunk, states=states)
        ins = (x, dt, a, b_mat, c_mat, init_state)
        out = tuple(g.to(t.dtype) if need else None for g, t, need in
                    zip(grads, ins, ctx.needs_input_grad))
        return (*out, None)


def ssd_scan(x, dt, a, b_mat, c_mat, init_state, *, chunk: int):
    """:class:`SsdScan` where a gradient is wanted (grad enabled and an
    input that requires it); otherwise one forward launch with no saved
    states — serving's cost is unchanged."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b_mat, c_mat, init_state)):
        return SsdScan.apply(x, dt, a, b_mat, c_mat, init_state, chunk)
    return mamba2_ssd(x, dt, a, b_mat, c_mat, init_state, chunk=chunk)
