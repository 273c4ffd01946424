"""Line-buffer streaming conv2d (+ fused ReLU / squared-ReLU) for Hopper.

**Replaces** the TPU kernel ``repro/kernels/conv2d_stream.py::
_conv_stream_kernel`` (reached through ``conv2d_stream_pallas``).  It
computes what that kernel computes — an NHWC conv that streams input
rows past a line buffer instead of materializing the frame on chip —
but not block by block: the pre-padded frame, the causal output and the
discarded leading rows of the reference exist only because its grid runs
in order.  Here the kernel (``csrc/conv2d_stream.cu``, CUDA C++ for
``sm_90a``) takes the unpadded frame and explicit pads and writes the
output directly.

**What bounds it on an H100.**  At the model zoo's shapes (32²/16²
frames, Cin 1-32, Cout 6-32) a conv moves a few hundred KB and does well
under a GFLOP: bytes and launch latency bound it, not arithmetic.  At
224²×136→136 (``deep_cascade_224``) it is 8.4 G multiply-adds on int32
data, which has no tensor-core path: CUDA-core integer MACs bound it.

**What the design does about it.**  One block per (sample, band of
output rows, W tile, Cout tile) loops over its band with the input rows
in a shared-memory ring, so each input row is read from device memory
once per band; the weight tile stays resident in shared memory for the
block's life; the batch is a grid axis, so a served batch is one launch
per conv, not one per sample.  Tiles come from
``repro_torch.core.dse.plan_conv_rows`` under the 227 KB shared-memory
budget.  Arithmetic is CUDA-core FMA/IMAD on a 4×4 register tile per
thread; ``wgmma``/TMA paths for the wide float/int8 cases are later work.

The library is built by ``nvcc`` from the source in this package at
first use (a few seconds; plain C interface, bound with ``ctypes``) into
``build/`` at the repository root, or ``$REPRO_TORCH_BUILD_DIR``.

Beside the kernel sits its plain PyTorch version,
:func:`conv2d_stream_plain`.  :func:`conv2d_stream` takes it **only**
for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time

import torch

from repro_torch.core.dse import CONV_BLOCK_THREADS, plan_conv_rows

#: fused-epilogue kinds the conv path supports, applied to the int32/f32
#: accumulator before the store (zero extra device-memory traffic) →
#: the epilogue code of the C interface
_EPILOGUE_CODES = {None: 0, "relu": 1, "squared_relu": 2}

#: input dtypes the kernel takes → the dtype code of the C interface
_DTYPE_CODES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
    torch.float32: 4, torch.bfloat16: 5,
}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does).  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0
#: seconds the last ``nvcc`` build took (None until one ran here)
build_seconds: float | None = None

_LOCK = threading.Lock()
_LIB = None

_SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "conv2d_stream.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def line_buffer_rows(kh: int, stride: int) -> int:
    """Rows the line buffer carries from one output row to the next: at
    stride ``s`` the window advances ``s`` input rows, so ``max(kh - s,
    0)`` rows are reused — ``K-1`` at stride 1, none once ``s >= kh``."""
    return max(kh - stride, 0)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return (torch.float32 if dtype.is_floating_point else torch.int32)


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return _SOURCE.parents[4] / "build"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def build_library(*, verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/conv2d_stream.cu`` into ``libconv2d_stream.so``
    (always rebuilds; :func:`load_library` calls it when the library is
    missing or older than the source).  Raises when ``nvcc`` fails."""
    global build_seconds
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libconv2d_stream.so"
    tmp = out_dir / f".libconv2d_stream.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so


def load_library():
    """The ``ctypes`` handle of the kernel library, built on first use.
    One handle per process, created under the module lock (the serve
    worker thread and the main thread may race here)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = build_dir() / "libconv2d_stream.so"
            if (not so.exists()
                    or so.stat().st_mtime < _SOURCE.stat().st_mtime):
                so = build_library()
            lib = ctypes.CDLL(str(so))
            fn = lib.conv2d_stream_launch
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 19
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.conv2d_stream_error_string.argtypes = [ctypes.c_int]
            lib.conv2d_stream_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def reset_counts() -> None:
    """Zero ``launches`` and ``plain_cuda_calls``."""
    global launches, plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pads, epilogue,
           dilation: int):
    if dilation != 1:
        raise NotImplementedError(
            f"conv2d_stream: dilation {dilation} is not supported")
    if epilogue not in _EPILOGUE_CODES:
        raise ValueError(f"unsupported conv epilogue {epilogue!r}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(
            f"conv2d_stream wants x (B,H,W,Cin) and w (KH,KW,Cin,Cout); "
            f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[3] != w.shape[2]:
        raise ValueError(
            f"conv2d_stream: Cin mismatch, x {tuple(x.shape)} vs "
            f"w {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(
            f"conv2d_stream: x is {x.dtype} but w is {w.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv2d_stream: unsupported dtype {x.dtype}")
    if x.device != w.device:
        raise ValueError(
            f"conv2d_stream: x on {x.device} but w on {w.device}")
    if stride < 1:
        raise ValueError(f"conv2d_stream: stride {stride} < 1")
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"conv2d_stream: negative pads {pads}")
    b, h, wd, _ = x.shape
    kh, kw, _, _ = w.shape
    h_out = (h + pt + pb - kh) // stride + 1
    w_out = (wd + pl + pr - kw) // stride + 1
    if b < 1 or h_out < 1 or w_out < 1:
        raise ValueError(
            f"conv2d_stream: empty output for x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, stride {stride}, pads {pads}")
    return h_out, w_out


def conv2d_stream_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    pads=((0, 0), (0, 0)),
    epilogue: str | None = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: one shifted-window product
    ``(B·Ho·Wo, Cin) × (Cin, Cout)`` per kernel tap, accumulated in
    int32 (operands cast first: truncation mod 2³² commutes with integer
    multiply/add, so narrow inputs get real int32 accumulators and
    overflow wraps like the kernel's) or in f32.  Integer products are
    a broadcast multiply + ``sum`` — exact on any device, where an
    integer ``matmul`` does not exist on CUDA; float products are
    ``matmul`` in full f32."""
    global plain_cuda_calls
    if x.is_cuda:
        with _LOCK:
            plain_cuda_calls += 1
    (pt, pb), (pl, pr) = pads
    acc = acc_dtype(x.dtype)
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    h_out = (h + pt + pb - kh) // stride + 1
    w_out = (wd + pl + pr - kw) // stride + 1
    xp = torch.nn.functional.pad(x.to(acc), (0, 0, pl, pr, pt, pb))
    wa = w.to(acc)
    integer = acc == torch.int32
    out = None
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[
                :,
                dy: dy + (h_out - 1) * stride + 1: stride,
                dx: dx + (w_out - 1) * stride + 1: stride,
                :,
            ]
            if integer and x.is_cuda:
                tap = _int_product(patch, wa[dy, dx])
            else:
                tap = patch @ wa[dy, dx]
            out = tap if out is None else out + tap
    if epilogue == "relu":
        out = out.clamp_min(0)
    elif epilogue == "squared_relu":
        r = out.clamp_min(0)
        out = r * r
    elif epilogue is not None:
        raise ValueError(f"unsupported conv epilogue {epilogue!r}")
    return out


def _int_product(patch: torch.Tensor, tap: torch.Tensor) -> torch.Tensor:
    """``(..., Cin) × (Cin, Cout)`` in int32 without an integer matmul:
    broadcast multiply and sum, Cin in chunks to bound the temporary."""
    cin = tap.shape[0]
    chunk = max(1, min(cin, (1 << 26) // max(1, patch[..., 0].numel() * tap.shape[1])))
    out = None
    for c0 in range(0, cin, chunk):
        part = (patch[..., c0:c0 + chunk, None] * tap[c0:c0 + chunk]).sum(
            dim=-2, dtype=torch.int32)
        out = part if out is None else out + part
    return out


def conv2d_stream(
    x: torch.Tensor,            # (B, H, W, Cin), unpadded
    w: torch.Tensor,            # (KH, KW, Cin, Cout)
    *,
    stride: int = 1,
    pads=((0, 0), (0, 0)),
    epilogue: str | None = None,
    rows_per_block: int | None = None,
    dilation: int = 1,
) -> torch.Tensor:
    """NHWC conv with explicit ``((top, bottom), (left, right))`` pads →
    ``(B, Ho, Wo, Cout)`` int32 (integer inputs, wrapping) or f32.

    On a CUDA tensor this launches the hand-written kernel on the calling
    thread's current stream (and adds one to ``launches``) or raises: a
    band that does not fit shared memory, an unsupported dtype, dilation
    ≠ 1.  Only a CPU tensor takes :func:`conv2d_stream_plain`.
    ``rows_per_block`` pins the output rows per band (default: the
    planner's choice); results do not depend on it.  Non-contiguous
    operands (a Cout slice of a streamed weight) are made contiguous."""
    global launches
    h_out, w_out = _check(x, w, stride, pads, epilogue, dilation)
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError(f"rows_per_block must be >= 1, got {rows_per_block}")
    if not x.is_cuda:
        return conv2d_stream_plain(x, w, stride, pads, epilogue)

    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = plan_conv_rows(
        h_out=h_out, w_out=w_out, c_in=cin, c_out=cout, kh=kh, kw=kw,
        stride=stride, batch=b, rows=rows_per_block,
    )  # raises ValueError when no tile fits shared memory
    blk = plan.blocks
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty((b, h_out, w_out, cout), dtype=acc_dtype(x.dtype),
                      device=x.device)
    lib = load_library()
    (pt, _), (pl, _) = pads
    def launch() -> int:
        return lib.conv2d_stream_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], b, h, wd, cin, kh, kw, cout,
            h_out, w_out, stride, pt, pl, _EPILOGUE_CODES[epilogue],
            blk["rows"], blk["rows_step"], blk["w_tile"], blk["c_tile"],
            CONV_BLOCK_THREADS,
            torch.cuda.current_stream(x.device).cuda_stream,
        )

    # a launch goes to the calling thread's current device: switch only
    # when the tensors live on another card (the switch costs host time
    # on every call, and host time is what bounds small convs)
    if x.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(x.device):
            rc = launch()
    if rc != 0:
        msg = lib.conv2d_stream_error_string(rc).decode()
        raise RuntimeError(
            f"conv2d_stream launch failed: {msg} (code {rc}); "
            f"x {tuple(x.shape)} w {tuple(w.shape)} plan {blk} "
            f"smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return out
