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

The library is built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside the kernel sits its plain PyTorch version,
:func:`fused_mlp_plain` (the port's ``ref.mlp``); :func:`fused_mlp`
takes it **only** for a tensor that lies on the CPU — on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.dse import plan_mlp_blocks
from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: input dtypes the kernel takes → the dtype code of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: activations → the kernel's code
ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2, "squared_relu": 3}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does).  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0

_LOCK = threading.Lock()


def _declare(lib) -> None:
    fn = lib.fused_mlp_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p


#: ``csrc/fused_mlp.cu`` → ``build/libfused_mlp.so``
LIBRARY = CudaLibrary("fused_mlp", _declare)


def reset_counts() -> None:
    """Zero ``launches`` and ``plain_cuda_calls``."""
    global launches, plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0


def _check(x, w_gate, w_up, w_down, act: str) -> None:
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
    if not x.is_cuda:
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

    if x.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(x.device):
            rc = launch()
    if rc != 0:
        msg = lib.fused_mlp_error_string(rc).decode()
        raise RuntimeError(
            f"fused_mlp launch failed: {msg} (code {rc}); x {tuple(x.shape)} "
            f"F {f} {x.dtype} plan {blocks} smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return out
