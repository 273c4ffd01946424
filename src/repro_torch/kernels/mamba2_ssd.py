"""Mamba-2 SSD (state-space duality) chunked scan for Hopper.

**Replaces** the TPU kernel ``repro/kernels/mamba2_ssd.py::_ssd_kernel``
(reached through ``mamba2_ssd_pallas``).  It computes what that kernel
computes — per chunk, the intra-chunk causal term ``Σ_{s≤t}
exp(cum_t−cum_s)·dt_s·(c_t·b_s)·x_s``, the carried-state term
``exp(cum_t)·c_t·S`` and the state update; ``y`` in ``x.dtype`` and the
final state in f32 — but not block by block.  The TPU's sequential chunk
grid axis becomes a loop inside one block (``csrc/mamba2_ssd.cu``, CUDA
C++ for ``sm_90a``) that keeps one head's ``(P, N)`` state in shared
memory; heads and batch rows are the parallel blocks.  The chunked scan
is exact for any chunk, so the kernel walks the sequence in its own tiles
(:func:`repro_torch.core.dse.plan_ssd_blocks`) and masks a
ragged last tile: every ``L`` runs.  ``exp`` is taken only for ``s ≤ t``.

**What bounds it on an H100.**  At mamba2-1.3b prefill (B 4, L 1024, H 64,
P 64, N 128, bf16) a call moves ≈ 87 MB (x, b, c, dt, the initial and
final state, y) and does ≈ 10 GFLOP: the bound is bytes, ≈ 26 µs at
3.35 TB/s.  This kernel runs its small matrix products
out of shared memory on the CUDA cores, one block per (batch, head).

**What the design does about it.**  x, b and c are read once, from the
column slices the model hands in (their batch and position strides go to
the kernel, so nothing is copied); y is written once.  Tensor cores and
several heads per block are later work.

The library is built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside the kernel sits its plain PyTorch version,
:func:`mamba2_ssd_plain` (the port's ``ref.ssd_chunked``);
:func:`mamba2_ssd` takes it **only** for a tensor that lies on the CPU —
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.dse import plan_ssd_blocks
from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

#: dtypes of x, b and c the kernel takes → the dtype code of the C
#: interface (dt, a and the states are f32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does).  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0

_LOCK = threading.Lock()


def _declare(lib) -> None:
    fn = lib.mamba2_ssd_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_ssd_error_string.restype = ctypes.c_char_p


#: ``csrc/mamba2_ssd.cu`` → ``build/libmamba2_ssd.so``
LIBRARY = CudaLibrary("mamba2_ssd", _declare)


def reset_counts() -> None:
    """Zero ``launches`` and ``plain_cuda_calls``."""
    global launches, plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0


def _check(x, dt, a, b_mat, c_mat, init_state) -> None:
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan → (y (B, L, H, P) in ``x.dtype``, final state (B, H,
    P, N) f32); x, b and c f32 or bf16 (one dtype), dt, a and the state
    cast to f32 (as the reference does first).

    On a CUDA tensor this launches the hand-written kernel on the calling
    thread's current stream (and adds one to ``launches``) or raises: an
    unsupported dtype, shapes that do not fit, a head or state wider than
    the kernel's tiles.  ``chunk`` is the plain version's; the kernel
    tiles by itself.  Only a CPU tensor takes :func:`mamba2_ssd_plain`."""
    global launches
    _check(x, dt, a, b_mat, c_mat, init_state)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    plan = plan_ssd_blocks(batch=bsz, length=l, heads=h, head_dim=p,
                           state_dim=n)           # raises beyond the tiles
    if not x.is_cuda:
        return mamba2_ssd_plain(x, dt, a, b_mat, c_mat, init_state,
                                chunk=chunk)
    x = _rows(x, (p, 1))
    b_mat, c_mat = _rows(b_mat, (1,)), _rows(c_mat, (1,))
    dtf = dt.float().contiguous()
    af = a.float().contiguous()
    s0 = init_state.float().contiguous()
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    sf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()

    def launch() -> int:
        return lib.mamba2_ssd_launch(
            x.data_ptr(), dtf.data_ptr(), af.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
            _DTYPE_CODES[x.dtype], bsz, l, h, p, n,
            x.stride(0), x.stride(1), b_mat.stride(0), b_mat.stride(1),
            c_mat.stride(0), c_mat.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream,
        )

    if x.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(x.device):
            rc = launch()
    if rc != 0:
        msg = lib.mamba2_ssd_error_string(rc).decode()
        raise RuntimeError(
            f"mamba2_ssd launch failed: {msg} (code {rc}); x "
            f"{tuple(x.shape)} N {n} {x.dtype} plan {plan.blocks} smem "
            f"{plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return y, sf
