"""Plain PyTorch primitives — the semantic ground truth of the runtime.

``conv2d`` is the dense oracle of the streaming conv kernel; the payload
and epilogue primitives below it are shared by the DFG interpreter
(``repro_torch.passes.interp``) and the per-group lowering
(``repro_torch.kernels.ops.lower_group``), so both execute identical
semantics.  Everything here works on integer tensors on the CPU and on
the card: pooling is ``unfold`` + ``amax``/``sum`` because
``F.max_pool2d`` / ``F.avg_pool2d`` reject integer CUDA tensors, and
integer averages are *floor* divisions.
"""
from __future__ import annotations

import torch


def is_integer(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """int32 accumulators for integer data, f32 otherwise."""
    return torch.int32 if is_integer(t) else torch.float32


# ---------------------------------------------------------------------------
# conv2d (+ fused ReLU) — the streaming conv oracle
# ---------------------------------------------------------------------------


def conv_pads(
    h: int, w: int, kh: int, kw: int, stride: int, padding
):
    """Resolve ``padding`` to explicit ((top, bottom), (left, right)).

    ``"SAME"`` splits the deficit end-heavy (``begin = total // 2`` —
    the ONNX SAME_UPPER convention; at stride 1 with odd kernels
    this is the symmetric ``(k-1)//2`` frame), ``"VALID"`` pads nothing,
    and an explicit pair-of-pairs passes through (the importer's
    asymmetric-pads path).
    """
    if isinstance(padding, str):
        if padding == "SAME":
            def same(n: int, k: int) -> tuple[int, int]:
                out = -(-n // stride)
                total = max(0, stride * (out - 1) + k - n)
                return total // 2, total - total // 2
            return same(h, kh), same(w, kw)
        if padding == "VALID":
            if kh > h or kw > w:
                raise ValueError(
                    f"VALID conv kernel ({kh}x{kw}) exceeds input ({h}x{w})"
                )
            return (0, 0), (0, 0)
        raise ValueError(f"unsupported padding {padding!r}")
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))



def conv2d(
    x: torch.Tensor,          # (B, H, W, C_in)
    w: torch.Tensor,          # (KH, KW, C_in, C_out)
    *,
    stride: int = 1,
    padding: str | tuple = "SAME",
    fuse_relu: bool = False,
    epilogue: str | None = None,
) -> torch.Tensor:
    """NHWC conv; integer inputs accumulate in int32 (wrapping mod 2³²),
    floats in f32.  ``padding`` is ``"SAME"`` (end-heavy split) /
    ``"VALID"`` or an explicit ``((top, bottom), (left, right))``.
    ``epilogue`` mirrors the kernel's fused tails (relu / squared_relu).

    Dense formulation, independent of the kernel's: the padded frame is
    unfolded into ``(B, Ho, Wo, Cin, KH, KW)`` windows and contracted
    with the weights in one broadcast multiply + sum (exact for
    integers on any device; no integer matmul is needed)."""
    if fuse_relu and epilogue not in (None, "relu"):
        raise ValueError(f"fuse_relu=True conflicts with epilogue={epilogue!r}")
    acc = acc_dtype(x)
    kh, kw, cin, cout = w.shape
    _, h, wd, _ = x.shape
    (pt, pb), (pl, pr) = conv_pads(h, wd, kh, kw, stride, padding)
    xp = torch.nn.functional.pad(x.to(acc), (0, 0, pl, pr, pt, pb))
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # B,Ho,Wo,Cin,KH,KW
    wk = w.to(acc).permute(2, 0, 1, 3)                    # Cin,KH,KW,Cout
    out = None
    for ci in range(cin):  # one input channel at a time bounds the temporary
        term = (win[:, :, :, ci, :, :, None] * wk[ci]).sum(dim=(3, 4), dtype=acc)
        out = term if out is None else out + term
    if fuse_relu or epilogue == "relu":
        out = out.clamp_min(0)
    elif epilogue == "squared_relu":
        r = out.clamp_min(0)
        out = r * r
    elif epilogue is not None:
        raise ValueError(f"unsupported conv epilogue {epilogue!r}")
    return out


# ---------------------------------------------------------------------------
# DFG payload / epilogue primitives.  Kinds are the *string values* of
# repro_torch.core.ir.PayloadKind (a str enum, so the enum members
# themselves compare equal and pass straight through).
# ---------------------------------------------------------------------------


def unary(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "relu":
        return x.clamp_min(0)
    if kind == "squared_relu":
        r = x.clamp_min(0)
        return r * r          # int32 squares wrap, like the reference
    if kind == "identity":
        return x
    if kind == "exp":
        return torch.exp(x.to(torch.float32))
    raise NotImplementedError(f"unary payload {kind}")


def binary(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise binop with right-aligned broadcasting — a batched
    value ``(B, …)`` against an unbatched constant of the compiled rank
    (or a rank-1 bias) lines up without help."""
    if kind == "add":
        return a + b
    if kind == "mul":
        return a * b
    if kind == "max":
        return torch.maximum(a, b)
    raise NotImplementedError(f"binary payload {kind}")


def _div_exact(x: torch.Tensor, n: int) -> torch.Tensor:
    """The DIV exit path shared by every avg-pool realization: floor
    division for integer accumulators (not truncation — negative sums
    tell them apart), true division for floats."""
    if n == 1:
        return x
    if is_integer(x):
        return torch.div(x, n, rounding_mode="floor")
    return x / n


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    # integer sums stay 32-bit (torch would widen to int64)
    return torch.int32 if is_integer(x) else x.dtype


def pool_reduce(kind: str, x: torch.Tensor, window: tuple[int, ...]) -> torch.Tensor:
    """Non-overlapping window reduction over the *trailing*
    ``len(window)`` axes of ``x`` (leading batch axes pass through):
    axis ``i`` shrinks by ``window[i]`` and ``kind`` combines each tile.

    ``kind="avg"`` accumulates with ADD and takes the DIV exit path
    *once*, over the whole window product — not per axis — so integer
    floor division matches the single divider on the stream-exit
    datapath."""
    if kind not in ("max", "add", "avg"):
        raise NotImplementedError(f"pool payload {kind}")
    lead = x.ndim - len(window)
    assert lead >= 0, (x.shape, window)
    count = 1
    for i in range(len(window) - 1, -1, -1):
        f = window[i]
        if f <= 1:
            continue
        ax = lead + i
        count *= f
        shp = tuple(x.shape)
        assert shp[ax] % f == 0, (shp, window)
        x = x.reshape(shp[:ax] + (shp[ax] // f, f) + shp[ax + 1:])
        if kind == "max":
            x = x.amax(dim=ax + 1)
        else:
            x = x.sum(dim=ax + 1, dtype=_sum_dtype(x))
    if kind == "avg":
        x = _div_exact(x, count)
    return x


def _windows(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """(N, H, W, C) → (N, Ho, Wo, C, kh, kw) VALID windows (a view)."""
    return x.unfold(1, kh, stride).unfold(2, kw, stride)


def maxpool2d(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """Standalone NHWC max pool (VALID padding) — the unfused oracle the
    conv+pool fusion pass is checked against."""
    return _windows(x, kh, kw, stride).amax(dim=(4, 5))


def avgpool2d(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """Standalone NHWC average pool (VALID padding): window ADDs in the
    accumulator dtype, then the shared DIV exit path."""
    acc = acc_dtype(x)
    summed = _windows(x.to(acc), kh, kw, stride).sum(dim=(4, 5), dtype=acc)
    return _div_exact(summed, kh * kw)


def apply_epilogue(out: torch.Tensor, epilogue, env) -> torch.Tensor:
    """Apply a chain of :class:`repro_torch.core.ir.FusedEpilogue`
    entries (duck-typed: ``kind`` / ``operand`` / ``window``)."""
    for e in epilogue:
        window = getattr(e, "window", ())
        if window:
            out = pool_reduce(e.kind, out, window)
        elif e.operand is None:
            out = unary(e.kind, out)
        else:
            out = binary(e.kind, out, env[e.operand])
    return out
