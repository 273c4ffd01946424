"""Fused (gated) MLP for Hopper.

**Replaces** the TPU kernel ``repro/kernels/fused_mlp.py::
_fused_mlp_kernel`` (reached through ``fused_mlp_pallas``).  It computes
what that kernel computes — ``down(act(x·Wg) * (x·Wu))``, or
``down(act(x·Wu))`` ungated, with silu / gelu (tanh form) / relu /
squared relu, the products summed in f32 and the output rounded to
``x.dtype`` — with the ``(M, F)`` hidden never written to device memory,
but not block by block: the TPU's sequential hidden-tile grid axis
becomes a loop inside the kernel (``csrc/fused_mlp.cu``, CUDA C++ for
``sm_90a``).

**What bounds it on an H100.**  At llama3.2-1b prefill (M 4096, D 2048,
F 8192, gated, bf16) a call does ≈ 412 GFLOP: 0.42 ms at the bf16
tensor-core peak.  At decode (M 4) it reads ≈ 100 MB of weights: ≈ 30 µs
by bytes.

**What the design does about it.**  bf16 runs on the tensor cores
(``mma.sync``): a thread-block cluster of up to 8 CTAs owns a tile of up
to 64 rows and splits D, each CTA keeping its slice of the ``(rows, D)``
f32 accumulator in registers and its slice of x in shared memory.  Per
64-column hidden tile the CTAs compute partial up/gate products over
their slices, sum them through distributed shared memory in rank order,
apply the activation, and accumulate the down product of the hidden tile
split into a bf16 high and a bf16 low part (16 significant bits, where
the Pallas kernel keeps f32: h in bf16 alone, as the JAX model's own
streamed loop rounds it, has no margin left under the 1e-2 tolerance
with squared relu); the weights stream through a three-stage
``cp.async`` ring, each element read once per row tile for the whole
cluster.  f32 keeps the CUDA-core kernel (TF32 would miss its 5e-4): a
block keeps R rows of x and uses each weight element R times, its
register accumulator bounding ``D`` at 8192 (``MLP_MAX_D``, both
routes).  Where the row tiles alone leave the card idle (decode), the
hidden axis is also split (:func:`repro_torch.core.dse.plan_mlp_blocks`):
each split writes an f32 partial and a second pass of the same launch
sums them in a fixed order and rounds.

**The backward** (``csrc/fused_mlp_bwd.cu``, :func:`fused_mlp_bwd`) is
the counterpart of XLA's autodiff of the reference's streamed MLP
(``src/repro/models/layers.py:531 _mlp_streamed``); it has no TPU
kernel.  From x, the weights and dy it recomputes the gate and up
products tile by tile — the forward saves no hidden — and gives dx, dWg,
dWu and dWd (:func:`fused_mlp_bwd_plain` states the sums).  Three
launches a call, deterministic (fixed-order sums, no atomics): the hidden
kernel writes h, du and dg for every (row tile, hidden tile) once; the
weight-gradient kernel sums dWd = hᵀ·dy, dWu = xᵀ·du and dWg = xᵀ·dg
over all rows in order; the dx kernel sums du·Wuᵀ + dg·Wgᵀ over the
hidden axis.  bf16 on the tensor cores, the f32 h, du and dg entering
their products as bf16 hi + lo: warpgroup ``wgmma`` fed by TMA where TMA
can read every operand (:func:`bwd_plan`), ``mma.sync`` for the shapes
it cannot; f32 on the CUDA cores.
:class:`FusedMlp` ties the two kernels into autograd; :func:`mlp` takes
it where a gradient is wanted and one forward launch otherwise.

The libraries are built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside each kernel sits its plain PyTorch version,
:func:`fused_mlp_plain` (the port's ``ref.mlp``) and
:func:`fused_mlp_bwd_plain`; the wrappers take them **only** for a tensor
that lies on the CPU — on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.core.dse import plan_mlp_blocks, plan_mlp_bwd_blocks
from repro_torch.kernels import ref, work
from repro_torch.kernels.build import CudaLibrary, refuse_dtensor

#: input dtypes the kernel takes → the dtype code of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: activations → the kernel's code
ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2, "squared_relu": 3}
#: the backward planner's routes → the launcher's code
BWD_ROUTE_CODES = {"cuda_core": 0, "mma": 1, "wgmma": 2}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does); the same for the backward (one per
#: call, which launches its three kernels).  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0
bwd_launches = 0
bwd_plain_cuda_calls = 0

_LOCK = threading.Lock()


def _declare(lib) -> None:
    fn = lib.fused_mlp_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib) -> None:
    fn = lib.fused_mlp_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_mlp_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p


#: ``csrc/fused_mlp.cu`` → ``build/libfused_mlp.so``
LIBRARY = CudaLibrary("fused_mlp", _declare)
#: ``csrc/fused_mlp_bwd.cu`` → ``build/libfused_mlp_bwd.so``
BWD_LIBRARY = CudaLibrary("fused_mlp_bwd", _declare_bwd)


def reset_counts() -> None:
    """Zero the launch and plain-call counts of both kernels."""
    global launches, plain_cuda_calls, bwd_launches, bwd_plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0
        bwd_launches = 0
        bwd_plain_cuda_calls = 0


def _check(x, w_gate, w_up, w_down, act: str) -> None:
    refuse_dtensor("fused_mlp", x, w_gate, w_up, w_down)
    if act not in ACT_CODES:
        raise ValueError(f"fused_mlp: unknown activation {act!r}")
    if x.ndim != 2 or w_up.ndim != 2 or w_down.ndim != 2:
        raise ValueError(
            "fused_mlp wants x (M, D), w_up (D, F), w_down (F, D); got "
            f"{tuple(x.shape)}, {tuple(w_up.shape)}, {tuple(w_down.shape)}")
    m, d = x.shape
    f = w_up.shape[1]
    if m < 1 or d < 1 or f < 1:
        raise ValueError(f"fused_mlp: empty problem (M {m}, D {d}, F {f})")
    if tuple(w_up.shape) != (d, f) or tuple(w_down.shape) != (f, d) or (
            w_gate is not None and tuple(w_gate.shape) != (d, f)):
        raise ValueError(
            f"fused_mlp: weights {None if w_gate is None else tuple(w_gate.shape)}"
            f", {tuple(w_up.shape)}, {tuple(w_down.shape)} do not fit x "
            f"{tuple(x.shape)}")
    ws = [w for w in (w_gate, w_up, w_down) if w is not None]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_mlp: unsupported dtype {x.dtype}")
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError(
            f"fused_mlp: x {x.dtype}, weights {[w.dtype for w in ws]}")
    if any(w.device != x.device for w in ws):
        raise ValueError(
            f"fused_mlp: x on {x.device}, weights on "
            f"{[str(w.device) for w in ws]}")


def _on_device(x: torch.Tensor, launch) -> int:
    """``launch()`` with ``x``'s card current (per-thread selection)."""
    if x.device.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(x.device):
        return launch()


def fused_mlp_plain(
    x: torch.Tensor,
    w_gate: torch.Tensor | None,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    act: str = "silu",
) -> torch.Tensor:
    """The kernel's plain PyTorch version: :func:`repro_torch.kernels.ref.
    mlp` — every product in f32, the hidden kept in f32 (the bf16 kernel
    carries it as two bf16 parts), the output in ``x.dtype``."""
    global plain_cuda_calls
    if x.is_cuda:
        with _LOCK:
            plain_cuda_calls += 1
    return ref.mlp(x, w_gate, w_up, w_down, act=act)


def fused_mlp(
    x: torch.Tensor,                  # (M, D)
    w_gate: torch.Tensor | None,      # (D, F) or None (ungated)
    w_up: torch.Tensor,               # (D, F)
    w_down: torch.Tensor,             # (F, D)
    *,
    act: str = "silu",
) -> torch.Tensor:
    """The (gated) MLP of ``x`` → ``(M, D)`` in ``x.dtype`` (f32 or bf16).

    On a CUDA tensor this launches the hand-written kernel on the calling
    thread's current stream (and adds one to ``launches``; a split hidden
    axis adds the summing pass to the same launch) or raises: an
    unsupported dtype or activation, weights that do not fit, ``D`` above
    the kernel's limit.  Only a CPU tensor takes :func:`fused_mlp_plain`.
    Operands are made contiguous."""
    global launches
    _check(x, w_gate, w_up, w_down, act)
    m, d = x.shape
    f = w_up.shape[1]
    plan = plan_mlp_blocks(m=m, d=d, f=f,      # raises for d > the limit
                           dtype=str(x.dtype).removeprefix("torch."))
    if not x.is_cuda and not x.is_meta:
        return fused_mlp_plain(x, w_gate, w_up, w_down, act=act)
    x, w_up, w_down = x.contiguous(), w_up.contiguous(), w_down.contiguous()
    if w_gate is not None:
        w_gate = w_gate.contiguous()
    out = torch.empty_like(x)
    blocks = plan.blocks
    part = None
    if blocks["splits"] > 1:
        part = torch.empty((blocks["splits"], m, d), dtype=torch.float32,
                           device=x.device)
    if x.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("fused_mlp", work.mlp_work(
            m, d, f, w_gate is not None, x.dtype), out)
        return out
    lib = LIBRARY.load()

    def launch() -> int:
        return lib.fused_mlp_launch(
            x.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            _DTYPE_CODES[x.dtype], m, d, f, ACT_CODES[act],
            int(w_gate is not None), blocks["rows"], blocks["cols"],
            blocks["cluster"], blocks["tiles_per_split"], blocks["splits"],
            torch.cuda.current_stream(x.device).cuda_stream,
        )

    rc = _on_device(x, launch)
    if rc != 0:
        msg = lib.fused_mlp_error_string(rc).decode()
        raise RuntimeError(
            f"fused_mlp launch failed: {msg} (code {rc}); x {tuple(x.shape)} "
            f"F {f} {x.dtype} plan {blocks} smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def act_grad(name: str, v: torch.Tensor) -> torch.Tensor:
    """The derivative of ``ref._act(name, ·)`` at ``v``: silu, gelu in
    the tanh form, relu (0 at 0, as ``jax.nn.relu``), squared relu."""
    if name == "silu":
        s = torch.sigmoid(v)
        return s * (1 + v * (1 - s))
    if name == "gelu":
        c = math.sqrt(2 / math.pi)
        t = torch.tanh(c * (v + 0.044715 * v ** 3))
        return 0.5 * (1 + t) + 0.5 * v * (1 - t * t) * c * (
            1 + 3 * 0.044715 * v * v)
    if name == "relu":
        return (v > 0).to(v.dtype)
    if name == "squared_relu":
        return 2 * torch.clamp_min(v, 0.0)
    raise ValueError(name)


def _check_bwd(x, w_gate, w_up, w_down, dy, act: str) -> None:
    _check(x, w_gate, w_up, w_down, act)
    refuse_dtensor("fused_mlp_bwd", dy)
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"fused_mlp_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} does not fit x {tuple(x.shape)} on "
                         f"{x.device}")


def mlp_bwd_hidden(x, w_gate, w_up, w_down, dy, *, act: str = "silu",
                   deriv=None):
    """The backward's recompute over all of F, in f32 → (h, du, dg or
    None): g = x·Wg and u = x·Wu, dh = dy·Wdᵀ; gated h = act(g)·u, du =
    dh·act(g), dg = dh·u·act′(g); ungated h = act(u), du = dh·act′(u).
    ``deriv`` stands in for act′ (default :func:`act_grad`)."""
    deriv = deriv or (lambda v: act_grad(act, v))
    xf = x.float()
    u = xf @ w_up.float()
    dh = dy.float() @ w_down.float().T
    if w_gate is None:
        return ref._act(act, u), dh * deriv(u), None
    g = xf @ w_gate.float()
    a = ref._act(act, g)
    return a * u, dh * a, dh * u * deriv(g)


def mlp_bwd_sums(x, w_gate, w_up, dy, h, du, dg):
    """The gradients from :func:`mlp_bwd_hidden`'s terms, in f32 → (dx,
    dWg or None, dWu, dWd): dWd = hᵀ·dy, dWu = xᵀ·du, dWg = xᵀ·dg, dx =
    du·Wuᵀ + dg·Wgᵀ."""
    xf = x.float()
    dwd = h.T @ dy.float()
    dwu = xf.T @ du
    dx = du @ w_up.float().T
    dwg = None
    if dg is not None:
        dwg = xf.T @ dg
        dx += dg @ w_gate.float().T
    return dx, dwg, dwu, dwd


def fused_mlp_bwd_plain(
    x: torch.Tensor,
    w_gate: torch.Tensor | None,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    dy: torch.Tensor,
    *,
    act: str = "silu",
):
    """The backward kernel's plain PyTorch version → (dx, dWg or None,
    dWu, dWd), each in its input's dtype: :func:`mlp_bwd_hidden`, then
    :func:`mlp_bwd_sums`, summed in f32 over all of F and rounded once."""
    global bwd_plain_cuda_calls
    if x.is_cuda:
        with _LOCK:
            bwd_plain_cuda_calls += 1
    h, du, dg = mlp_bwd_hidden(x, w_gate, w_up, w_down, dy, act=act)
    dx, dwg, dwu, dwd = mlp_bwd_sums(x, w_gate, w_up, dy, h, du, dg)
    return (dx.to(x.dtype), None if dwg is None else dwg.to(w_gate.dtype),
            dwu.to(w_up.dtype), dwd.to(w_down.dtype))


def bwd_plan(x, w_gate, w_up, w_down, dy):
    """The plan :func:`fused_mlp_bwd` launches for these contiguous
    inputs: :func:`repro_torch.core.dse.plan_mlp_bwd_blocks` with their
    bases' alignment — the launcher's own test, which also covers the
    outputs and the scratch (fresh from the allocator, 16-byte aligned)."""
    m, d = x.shape
    aligned = all(t is None or t.data_ptr() % 16 == 0
                  for t in (x, w_gate, w_up, w_down, dy))
    return plan_mlp_bwd_blocks(m=m, d=d, f=w_up.shape[1],
                               gated=w_gate is not None,
                               dtype=str(x.dtype).removeprefix("torch."),
                               aligned=aligned)


def fused_mlp_bwd(
    x: torch.Tensor,                  # (M, D)
    w_gate: torch.Tensor | None,      # (D, F) or None (ungated)
    w_up: torch.Tensor,               # (D, F)
    w_down: torch.Tensor,             # (F, D)
    dy: torch.Tensor,                 # (M, D)
    *,
    act: str = "silu",
):
    """The gradients of :func:`fused_mlp` for the cotangent ``dy`` →
    (dx, dWg or None, dWu, dWd) in the inputs' dtype.

    On a CUDA tensor this launches the hand-written backward (its three
    kernels on the calling thread's current stream; one added to
    ``bwd_launches``) or raises: what :func:`fused_mlp` refuses, or a
    ``dy`` that does not fit x.  The kernels' route and tiles are
    :func:`bwd_plan`'s (:func:`repro_torch.core.dse.plan_mlp_bwd_blocks`):
    bf16 on ``"wgmma"`` where TMA can read every operand, else on
    ``"mma"``; the launcher refuses a route the shape does not take.  Only
    a CPU tensor takes :func:`fused_mlp_bwd_plain`.  Deterministic: the
    same inputs give the same bits."""
    global bwd_launches
    _check_bwd(x, w_gate, w_up, w_down, dy, act)
    m, d = x.shape
    f = w_up.shape[1]
    if not x.is_cuda and not x.is_meta:
        bwd_plan(x, w_gate, w_up, w_down, dy)       # the planner's checks
        return fused_mlp_bwd_plain(x, w_gate, w_up, w_down, dy, act=act)
    x, w_up, w_down = x.contiguous(), w_up.contiguous(), w_down.contiguous()
    dy = dy.to(x.dtype).contiguous()
    if w_gate is not None:
        w_gate = w_gate.contiguous()
    plan = bwd_plan(x, w_gate, w_up, w_down, dy)
    dx = torch.empty_like(x)
    dwu, dwd = torch.empty_like(w_up), torch.empty_like(w_down)
    dwg = None if w_gate is None else torch.empty_like(w_gate)
    hidden = torch.empty(plan.hidden_bytes, dtype=torch.uint8,
                         device=x.device)
    if x.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("fused_mlp_bwd", work.mlp_bwd_work(
            m, d, f, w_gate is not None, x.dtype), dx)
        return dx, dwg, dwu, dwd
    lib = BWD_LIBRARY.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch() -> int:
        return lib.fused_mlp_bwd_launch(
            x.data_ptr(), ptr(w_gate), w_up.data_ptr(), w_down.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ptr(dwg), dwu.data_ptr(),
            dwd.data_ptr(), hidden.data_ptr(), _DTYPE_CODES[x.dtype],
            BWD_ROUTE_CODES[plan.route], m, d, f, ACT_CODES[act],
            int(w_gate is not None),
            torch.cuda.current_stream(x.device).cuda_stream)

    rc = _on_device(x, launch)
    if rc != 0:
        msg = lib.fused_mlp_bwd_error_string(rc).decode()
        raise RuntimeError(
            f"fused_mlp_bwd launch failed: {msg} (code {rc}); x "
            f"{tuple(x.shape)} F {f} {x.dtype} plan {plan}")
    with _LOCK:
        bwd_launches += 1
    return dx, dwg, dwu, dwd


class FusedMlp(torch.autograd.Function):
    """Differentiable fused MLP: forward :func:`fused_mlp`, backward
    :func:`fused_mlp_bwd`.  It saves only x and the weights — no hidden:
    the backward recomputes it."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, act):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        ctx.act = act
        return fused_mlp(x, w_gate, w_up, w_down, act=act)

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down = ctx.saved_tensors
        dx, dwg, dwu, dwd = fused_mlp_bwd(x, w_gate, w_up, w_down, dy,
                                          act=ctx.act)
        return dx, dwg, dwu, dwd, None


def mlp(x, w_gate, w_up, w_down, *, act: str = "silu") -> torch.Tensor:
    """:class:`FusedMlp` where a gradient is wanted (grad enabled and an
    input that requires it); otherwise one forward launch — serving's cost
    is unchanged."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_gate, w_up, w_down)):
        return FusedMlp.apply(x, w_gate, w_up, w_down, act)
    return fused_mlp(x, w_gate, w_up, w_down, act=act)
