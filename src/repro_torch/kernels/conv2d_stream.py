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
data, which has no tensor-core path: the CUDA cores' integer
multiply-add rate (64 a clock an SM, half the f32 FMA rate) bounds it at
≈ 0.50 ms.

**What the design does about it.**  One block per (sample, band of
output rows, W tile, Cout tile) walks its band, and every thread of it
owns one register tile of a step — 8 pixels × 8 channels (64
accumulators) at wide shapes, 4 × 4 or 2 × 4 where the outputs are too
few to fill the card — held across the whole K loop (a resident block
may carry extra threads that only load).  Small convs keep
the whole weight tile and a ring of input rows resident in shared memory
(each input row read once per band; a small conv with a deep Cin in one
wave of 256-thread blocks whose spare threads only load); wide convs
stream weights and input through two ``cp.async`` stages of 1-8 Cin
chunks, so tiles no longer hold all of Cin: Cout 136 fits one to three
channel tiles and two blocks share an SM.  The K loop runs in fixed
8-channel chunks, then (kh, kw, ci), whatever the plan, so float results
do not depend on the tiling.
The batch is a grid axis, so a served batch is one launch per conv, not
one per sample.  Tiles come from ``repro_torch.core.dse.plan_conv_rows``.
``wgmma``/TMA paths for bf16/int8 and a tensor-core route for int32 are
later work.

The library is built by ``nvcc`` from the source in this package at
first use (a few seconds; plain C interface, bound with ``ctypes``) into
``build/`` at the repository root, or ``$REPRO_TORCH_BUILD_DIR``
(``repro_torch.kernels.build``).

Beside the kernel sits its plain PyTorch version,
:func:`conv2d_stream_plain`.  :func:`conv2d_stream` takes it **only**
for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.dse import plan_conv_rows
from repro_torch.kernels.build import CudaLibrary, refuse_dtensor

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
_LOCK = threading.Lock()


def line_buffer_rows(kh: int, stride: int) -> int:
    """Rows the line buffer carries from one output row to the next: at
    stride ``s`` the window advances ``s`` input rows, so ``max(kh - s,
    0)`` rows are reused — ``K-1`` at stride 1, none once ``s >= kh``."""
    return max(kh - stride, 0)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return (torch.float32 if dtype.is_floating_point else torch.int32)


def _declare(lib) -> None:
    fn = lib.conv2d_stream_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 23
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.conv2d_stream_error_string.argtypes = [ctypes.c_int]
    lib.conv2d_stream_error_string.restype = ctypes.c_char_p


#: ``csrc/conv2d_stream.cu`` → ``build/libconv2d_stream.so``, built by
#: ``nvcc`` at first use
LIBRARY = CudaLibrary("conv2d_stream", _declare)


def reset_counts() -> None:
    """Zero ``launches`` and ``plain_cuda_calls``."""
    global launches, plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0


def _check(x_shape, w_shape, x_dtype, w_dtype, stride: int, pads, epilogue,
           dilation: int):
    """The call's contract on shapes and dtypes → ``(h_out, w_out)``."""
    if dilation != 1:
        raise NotImplementedError(
            f"conv2d_stream: dilation {dilation} is not supported")
    if epilogue not in _EPILOGUE_CODES:
        raise ValueError(f"unsupported conv epilogue {epilogue!r}")
    if len(x_shape) != 4 or len(w_shape) != 4:
        raise ValueError(
            f"conv2d_stream wants x (B,H,W,Cin) and w (KH,KW,Cin,Cout); "
            f"got {tuple(x_shape)} and {tuple(w_shape)}")
    if x_shape[3] != w_shape[2]:
        raise ValueError(
            f"conv2d_stream: Cin mismatch, x {tuple(x_shape)} vs "
            f"w {tuple(w_shape)}")
    if x_dtype != w_dtype:
        raise TypeError(
            f"conv2d_stream: x is {x_dtype} but w is {w_dtype}")
    if x_dtype not in _DTYPE_CODES:
        raise TypeError(f"conv2d_stream: unsupported dtype {x_dtype}")
    if stride < 1:
        raise ValueError(f"conv2d_stream: stride {stride} < 1")
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"conv2d_stream: negative pads {pads}")
    b, h, wd, _ = x_shape
    kh, kw, _, _ = w_shape
    h_out = (h + pt + pb - kh) // stride + 1
    w_out = (wd + pl + pr - kw) // stride + 1
    if b < 1 or h_out < 1 or w_out < 1:
        raise ValueError(
            f"conv2d_stream: empty output for x {tuple(x_shape)}, "
            f"w {tuple(w_shape)}, stride {stride}, pads {pads}")
    return h_out, w_out


def _check_devices(x: torch.Tensor, w: torch.Tensor) -> None:
    refuse_dtensor("conv2d_stream", x, w)
    if x.device != w.device:
        raise ValueError(
            f"conv2d_stream: x on {x.device} but w on {w.device}")


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
    conv whose smallest tile does not fit shared memory, an unsupported
    dtype, dilation ≠ 1.  Only a CPU tensor takes
    :func:`conv2d_stream_plain`.
    ``rows_per_block`` pins the output rows per band (default: the
    planner's choice); results do not depend on it.  Non-contiguous
    operands (a Cout slice of a streamed weight) are made contiguous.
    The checks and the plan are worked out once per call signature (the
    shapes, dtype, stride, pads, epilogue and band), so a repeated call
    only launches."""
    (pt, pb), (pl, pr) = pads
    if not x.is_cuda:
        _check(x.shape, w.shape, x.dtype, w.dtype, stride, pads, epilogue,
               dilation)
        _check_devices(x, w)
        if rows_per_block is not None and rows_per_block < 1:
            raise ValueError(
                f"rows_per_block must be >= 1, got {rows_per_block}")
        return conv2d_stream_plain(x, w, stride, pads, epilogue)
    args = _launch_args(x.shape, w.shape, x.dtype, w.dtype, stride,
                        (pt, pb, pl, pr), epilogue, rows_per_block, dilation)
    _check_devices(x, w)
    return _launch(x, w, *args)


@functools.lru_cache(maxsize=4096)
def _launch_args(x_shape, w_shape, x_dtype, w_dtype, stride, pads4,
                 epilogue, rows_per_block, dilation):
    """(output shape, output dtype, plan, the C interface's integer
    arguments) of one call signature: its checks and its plan (raises
    where :func:`conv2d_stream` raises; an error is not cached)."""
    pt, pb, pl, pr = pads4
    pads = ((pt, pb), (pl, pr))
    h_out, w_out = _check(x_shape, w_shape, x_dtype, w_dtype, stride, pads,
                          epilogue, dilation)
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError(f"rows_per_block must be >= 1, got {rows_per_block}")
    b, _, _, cin = x_shape
    kh, kw, _, cout = w_shape
    plan = plan_conv_rows(
        h_out=h_out, w_out=w_out, c_in=cin, c_out=cout, kh=kh, kw=kw,
        stride=stride, batch=b, rows=rows_per_block,
    )  # raises ValueError when no tile fits shared memory
    return _plan_args(x_shape, w_shape, x_dtype, stride, pads, epilogue,
                      plan, h_out, w_out)


def _plan_args(x_shape, w_shape, x_dtype, stride, pads, epilogue, plan,
               h_out, w_out):
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    (pt, _), (pl, _) = pads
    blk = plan.blocks
    ints = (_DTYPE_CODES[x_dtype], b, h, wd, cin, kh, kw, cout, h_out,
            w_out, stride, pt, pl, _EPILOGUE_CODES[epilogue], blk["rows"],
            blk["rows_step"], blk["w_tile"], blk["c_tile"],
            blk["tile_pixels"], blk["tile_channels"], int(blk["streamed"]),
            blk["stage_chunks"], blk["threads"])
    return (b, h_out, w_out, cout), acc_dtype(x_dtype), plan, ints


def launch_plan(x, w, stride, pads, epilogue, plan) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that :func:`conv2d_stream` would
    accept, under a given ``plan`` (a harness's hand-made tiling; the
    wrapper takes the planner's).  Adds one to ``launches``."""
    h_out, w_out = _check(x.shape, w.shape, x.dtype, w.dtype, stride, pads,
                          epilogue, 1)
    _check_devices(x, w)
    return _launch(x, w, *_plan_args(x.shape, w.shape, x.dtype, stride, pads,
                                     epilogue, plan, h_out, w_out))


def _launch(x, w, out_shape, out_dtype, plan, ints) -> torch.Tensor:
    global launches
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    lib = LIBRARY.load()

    def launch() -> int:
        return lib.conv2d_stream_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), *ints,
            torch.cuda.current_stream(x.device).cuda_stream)

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
            f"x {tuple(x.shape)} w {tuple(w.shape)} plan {plan.blocks} "
            f"smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return out
