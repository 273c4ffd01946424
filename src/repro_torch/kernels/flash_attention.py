"""KV-streaming flash attention for Hopper: the forward kernel, its
backward kernel, and the ``torch.autograd.Function`` that joins them.

**The forward replaces** the TPU kernel ``repro/kernels/flash_attention.py::
_flash_kernel`` (reached through ``flash_attention_pallas``).  It
computes what that kernel computes — attention of pre-scaled queries
against keys and values that stream past a running (max ``m``,
denominator ``l``, numerator ``acc``) per query row, so the (Sq, Sk)
score matrix never reaches device memory; GQA; a causal mask by absolute
position with a query offset; masked scores ``-1e30`` and masked
probabilities 0, so a row that sees no key gives 0 — but not block by
block.  The TPU's sequential KV grid axis becomes a loop inside one
block (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``), key tiles
that lie wholly above the causal diagonal are skipped (exact: they
would leave ``m`` unchanged, give ``alpha = 1`` and ``p = 0``), and the
ragged edges of Sq and Sk are masked inside the kernel, so any length
runs with the kernel's own tiles.  For training it also writes each
row's log-sum-exp ``lse = m + log(l)`` (``l`` replaced by 1 where it is
0, the reference's ``safe_l``); serving asks for none.

**The backward** (``csrc/flash_attention_bwd.cu``) has no TPU kernel to
replace: it is the counterpart of the reference's XLA custom VJP
``src/repro/models/layers.py:209 _blockwise_attention_bwd``, which
recomputes each score tile from ``lse`` and never stores the O(S²)
probabilities.  It is deterministic — dK and dV are summed over the
query tiles and the GQA group inside one block per (batch·KV head, key
tile), dQ in a second pass per (batch·query head, query tile); no float
atomics.  bf16 runs on the tensor cores, f32 accumulation, P and dS
rounded to bf16 as they become operands (as in FA2): on warpgroup
``wgmma`` fed by TMA where TMA can read every operand (a head of 64 or
128, 16-byte aligned bases), else on ``mma.sync`` — the route of
:func:`repro_torch.core.dse.plan_attn_bwd_blocks`; f32 on the CUDA
cores.  A row that sees no key is 0 in
the forward, so its probabilities are 0 in the backward and it passes no
gradient on (``blockwise`` attention, the reference's convention, gives
such a row the mean of v instead).

**What bounds them on an H100.**  Operations, not bytes.  At the LM
path's prefill shapes (B 4, S 1024, 32 or 14 query heads of 64) a
forward does ≈ 17 GFLOP against ≈ 42 MB of q/k/v/o — 17 µs at the bf16
tensor-core peak, 0.26 ms at the f32 CUDA-core peak.  At llama3.2-1b's
train shape (B 4, S 4096) the backward's five products over the visible
tile pairs bound it at ≈ 0.69 ms (bf16 tensor cores).

**What the forward's design does about it.**  bf16 runs on the tensor
cores (FA2-style): one block of 4 warps per (batch·head, 64 query rows),
the query tile held in registers as ``mma.sync`` fragments, key and
value tiles of 64 keys streamed through shared memory as bf16 in a
``cp.async`` double buffer, S = Q·Kᵀ and O += P·V by ``mma.sync`` with
f32 accumulation, the online softmax in registers, and P repacked to
bf16 fragments without touching shared memory (the Pallas kernel keeps P
in f32; l sums the f32 p).  f32 keeps the CUDA-core kernel (TF32 would
miss its 2e-5): every operand in shared memory as f32, each thread a
(block_q/16)×4 piece of the score tile
(``repro_torch.core.dse.plan_attention_blocks`` picks 64 or 32 rows).
On both, the heaviest causal tiles start first.

Both libraries are built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside each kernel sits its plain PyTorch version,
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`; the
wrappers take them **only** for a tensor that lies on the CPU — on a
CUDA tensor they launch the kernel or raise.  :class:`FlashAttention`
is the differentiable op: its forward is the forward kernel with
``lse``, its backward the backward kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.dse import plan_attention_blocks, plan_attn_bwd_blocks
from repro_torch.kernels import work
from repro_torch.kernels.build import CudaLibrary, refuse_dtensor

NEG_INF = -1e30

#: input dtypes the kernel takes → the dtype code of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the backward planner's routes → the launcher's code
BWD_ROUTE_CODES = {"cuda_core": 0, "mma": 1, "wgmma": 2}

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
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib) -> None:
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


#: ``csrc/flash_attention.cu`` → ``build/libflash_attention.so``
LIBRARY = CudaLibrary("flash_attention", _declare)
#: ``csrc/flash_attention_bwd.cu`` → ``build/libflash_attention_bwd.so``
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", _declare_bwd)


def reset_counts() -> None:
    """Zero the launch and plain-call counts of both kernels."""
    global launches, plain_cuda_calls, bwd_launches, bwd_plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0
        bwd_launches = 0
        bwd_plain_cuda_calls = 0


def scale_in_dtype(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in ``x.dtype`` with ``scale`` first rounded to that
    dtype — the product a framework that casts a Python scalar to the
    array's type computes (for bf16 that differs from multiplying by the
    exact scale before one rounding)."""
    return x * float(torch.tensor(scale, dtype=x.dtype))


def _check(q, k, v, heads_q: int, heads_kv: int) -> None:
    refuse_dtensor("flash_attention", q, k, v)
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(
            "flash_attention wants q (B·Hq, Sq, D), k and v (B·Hkv, Sk, D); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: q on {q.device}, k on {k.device}, "
            f"v on {v.device}")
    if heads_q < 1 or heads_kv < 1 or heads_q % heads_kv:
        raise ValueError(
            f"flash_attention: {heads_q} query heads over {heads_kv} KV "
            "heads is not a whole group")
    bhq, _, d = q.shape
    if bhq % heads_q:
        raise ValueError(
            f"flash_attention: q's leading axis {bhq} is not B·{heads_q}")
    want = (bhq // heads_q * heads_kv, k.shape[1], d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"do not fit q {tuple(q.shape)} with {heads_q}/{heads_kv} heads")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads_q: int,
    heads_kv: int,
    causal: bool = True,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """The kernel's plain PyTorch version, with the kernel's masking (not
    ``ref.attention``'s): masked scores ``-1e30``, masked probabilities
    0, the sum guarded where it is 0 — so a row that sees no key gives 0,
    where ``ref.attention`` gives NaN.  Dense ``einsum`` in f32; output
    in ``q.dtype``; with ``return_lse`` also ``lse`` (B·Hq, Sq) f32, ``m
    + log(safe_l)`` as the kernel writes it."""
    global plain_cuda_calls
    if q.is_cuda:
        with _LOCK:
            plain_cuda_calls += 1
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b, g = bhq // heads_q, heads_q // heads_kv
    qf = q.float().reshape(b, heads_kv, g, sq, d)
    kf = k.float().reshape(b, heads_kv, sk, d)
    vf = v.float().reshape(b, heads_kv, sk, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if causal:
        mask = causal_mask(sq, sk, q_offset, q.device)
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / safe_l
    out = out.reshape(bhq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(safe_l)).reshape(bhq, sq)


def causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) causal mask: query row r sees key c iff r + q_offset ≥ c."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    return qpos >= torch.arange(sk, device=device)[None, :]


def _on_device(q: torch.Tensor, launch) -> int:
    """``launch()`` with ``q``'s card current (per-thread selection)."""
    if q.device.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(q.device):
        return launch()


def flash_attention(
    q: torch.Tensor,        # (B·Hq, Sq, D), pre-scaled
    k: torch.Tensor,        # (B·Hkv, Sk, D)
    v: torch.Tensor,        # (B·Hkv, Sk, D)
    *,
    heads_q: int,
    heads_kv: int,
    causal: bool = True,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention of pre-scaled ``q`` over ``k``/``v`` → ``(B·Hq, Sq, D)``
    in ``q.dtype`` (f32 or bf16); with ``return_lse`` also each row's
    ``lse`` (B·Hq, Sq) f32, which :func:`flash_attention_bwd` takes.

    On a CUDA tensor this launches the hand-written kernel on the calling
    thread's current stream (and adds one to ``launches``) or raises: an
    unsupported dtype, a head wider than 128, shapes that do not fit the
    heads.  Only a CPU tensor takes :func:`flash_attention_plain`.
    Operands are made contiguous (the model hands in transposed views)."""
    global launches
    _check(q, k, v, heads_q, heads_kv)
    bhq, sq, d = q.shape
    sk = k.shape[1]
    plan = plan_attention_blocks(     # raises for d > 128
        seq_q=sq, seq_k=sk, head_dim=d, batch_heads=bhq,
        dtype=str(q.dtype).removeprefix("torch."))
    if not q.is_cuda and not q.is_meta:
        return flash_attention_plain(q, k, v, heads_q=heads_q,
                                     heads_kv=heads_kv, causal=causal,
                                     q_offset=q_offset,
                                     return_lse=return_lse)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("flash_attention", work.attention_work(
            bhq // heads_q, heads_q, heads_kv, sq, sk, d, causal, q_offset,
            q.dtype, lse=return_lse), out)
        return (out, lse) if return_lse else out
    lib = LIBRARY.load()
    rc = _on_device(q, lambda: lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODES[q.dtype], bhq, sq, sk, d, heads_q, heads_kv,
        int(causal), int(q_offset), plan.blocks["block_q"],
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(
            f"flash_attention launch failed: {msg} (code {rc}); "
            f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} plan "
            f"{plan.blocks} smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, heads_q: int, heads_kv: int,
    causal: bool = True, q_offset: int = 0, scale: float = 1.0,
    block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's plain PyTorch version:
    :func:`streaming_attention_bwd` with the kernel's masking (a row that
    sees no key passes no gradient) and tiles of ``block``."""
    global bwd_plain_cuda_calls
    if q.is_cuda:
        with _LOCK:
            bwd_plain_cuda_calls += 1
    return streaming_attention_bwd(
        q, k, v, out, lse, dout, heads_q=heads_q, heads_kv=heads_kv,
        causal=causal, q_offset=q_offset, scale=scale, block_q=block,
        block_k=block, unseen_rows="zero")


def streaming_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, heads_q: int, heads_kv: int,
    causal: bool, q_offset: int, scale: float, block_q: int, block_k: int,
    unseen_rows: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streaming backward of ``src/repro/models/layers.py:209-275``:
    per (query block, key block) the score tile recomputed from ``lse``,
    never the whole (Sq, Sk) matrix, and dq, dk, dv summed in f32.
    Layout (B·Hq, Sq, D) / (B·Hkv, Sk, D), ``lse`` (B·Hq, Sq); ragged
    lengths end in a short block.  ``q`` is the forward's pre-scaled
    query; dq comes back times ``scale`` (the gradient of the unscaled
    query); grads in the input dtype.

    ``unseen_rows`` is the forward's convention for a row that sees no
    key: ``"zero"`` (the kernel's: its probabilities are 0, so it passes
    no gradient, and key blocks wholly above the causal diagonal are
    skipped) or ``"mean"`` (``blockwise`` attention's, the reference's:
    masked scores are ``-1e30``, so such a row's probabilities are
    ``exp(0) = 1`` against its ``lse`` and every key block is visited)."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b, g = bhq // heads_q, heads_q // heads_kv
    zero = unseen_rows == "zero"
    qf = q.float().reshape(b, heads_kv, g, sq, d)
    dof = dout.float().reshape(b, heads_kv, g, sq, d)
    kf = k.float().reshape(b, heads_kv, sk, d)
    vf = v.float().reshape(b, heads_kv, sk, d)
    lsef = lse.float().reshape(b, heads_kv, g, sq)
    # delta = rowsum(dout ⊙ out) — the softmax-jacobian diagonal term
    delta = (dof * out.float().reshape(b, heads_kv, g, sq, d)).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qc, doc = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        lc, dc = lsef[:, :, :, q0:q1, None], delta[:, :, :, q0:q1, None]
        for k0 in range(0, sk, block_k):
            if zero and causal and k0 > q1 - 1 + q_offset:
                break                       # wholly above the diagonal
            k1 = min(k0 + block_k, sk)
            kc, vc = kf[:, :, k0:k1], vf[:, :, k0:k1]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            if causal:
                vis = causal_mask(q1 - q0, k1 - k0, q0 + q_offset - k0,
                               q.device)
                s = torch.where(vis, s, NEG_INF)
            p = torch.exp(s - lc)
            if causal and zero:
                p = torch.where(vis, p, 0.0)
            # dv += Σ_g pᵀ do ; dp = do vᵀ ; ds = p (dp − delta)
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
            ds = p * (dp - dc)
            dq[:, :, :, q0:q1] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    return ((dq * scale).reshape(bhq, sq, d).to(q.dtype),
            dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype))


def bwd_plan(q, k, v, dout, *, heads_q: int, heads_kv: int):
    """The plan :func:`flash_attention_bwd` launches for these contiguous
    inputs: :func:`repro_torch.core.dse.plan_attn_bwd_blocks` with their
    bases' alignment — the launcher's own test, which also covers the
    gradients (fresh from the allocator, 16-byte aligned)."""
    bhq, sq, d = q.shape
    return plan_attn_bwd_blocks(
        batch_heads_q=bhq, heads_q=heads_q, heads_kv=heads_kv, seq_q=sq,
        seq_k=k.shape[1], head_dim=d,
        dtype=str(q.dtype).removeprefix("torch."),
        aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, dout)))


def flash_attention_bwd(
    q: torch.Tensor,        # (B·Hq, Sq, D), pre-scaled (the forward's)
    k: torch.Tensor,        # (B·Hkv, Sk, D)
    v: torch.Tensor,        # (B·Hkv, Sk, D)
    out: torch.Tensor,      # (B·Hq, Sq, D), the forward's output
    lse: torch.Tensor,      # (B·Hq, Sq) f32, the forward's
    dout: torch.Tensor,     # (B·Hq, Sq, D)
    *,
    heads_q: int,
    heads_kv: int,
    causal: bool = True,
    q_offset: int = 0,
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention`'s output, in the input
    dtype; dq times ``scale`` (the gradient of the unscaled query).

    On a CUDA tensor this launches the hand-written backward kernels on
    the current stream (and adds one to ``bwd_launches``) or raises; only
    a CPU tensor takes :func:`flash_attention_bwd_plain`.  The route is
    :func:`bwd_plan`'s (:func:`repro_torch.core.dse.plan_attn_bwd_blocks`):
    bf16 on ``"wgmma"`` where TMA can read every operand, else on
    ``"mma"``; the launcher refuses a route the shape does not take.
    Deterministic: the same inputs give the same bits."""
    global bwd_launches
    _check(q, k, v, heads_q, heads_kv)
    bhq, sq, d = q.shape
    sk = k.shape[1]
    if d > 128:
        raise ValueError(f"flash_attention_bwd: head dim {d} > 128")
    refuse_dtensor("flash_attention_bwd", out, lse, dout)
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (bhq, sq))):
        if tuple(t.shape) != tuple(shape) or t.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} {tuple(t.shape)} on {t.device}"
                f" does not fit q {tuple(q.shape)} on {q.device}")
    kw = dict(heads_q=heads_q, heads_kv=heads_kv, causal=causal,
              q_offset=q_offset, scale=scale)
    if not q.is_cuda and not q.is_meta:
        bwd_plan(q, k, v, dout, heads_q=heads_q, heads_kv=heads_kv)
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    plan = bwd_plan(q, k, v, dout, heads_q=heads_q, heads_kv=heads_kv)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
    if q.is_meta:                   # shapes only: the launch's work counted
        work.record_kernel("flash_attention_bwd", work.attention_bwd_work(
            bhq // heads_q, heads_q, heads_kv, sq, sk, d, causal, q_offset,
            q.dtype), dq)
        return dq, dk, dv
    lib = BWD_LIBRARY.load()
    rc = _on_device(q, lambda: lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype],
        BWD_ROUTE_CODES[plan.route], bhq, sq, sk, d, heads_q, heads_kv,
        int(causal), int(q_offset), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(
            f"flash_attention_bwd launch failed: {msg} (code {rc}); "
            f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} route "
            f"{plan.route}")
    with _LOCK:
        bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable attention of the *unscaled* ``q`` (B·Hq, Sq, D) over
    ``k``/``v`` (B·Hkv, Sk, D): forward :func:`flash_attention` on
    ``scale_in_dtype(q, scale)`` with ``lse``, backward
    :func:`flash_attention_bwd`.  It saves ``(q, k, v, out, lse)`` — the
    unscaled q, as the reference's VJP does — and recomputes the scaled
    q in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, heads_q, heads_kv, causal, q_offset, scale):
        out, lse = flash_attention(
            scale_in_dtype(q, scale), k, v, heads_q=heads_q,
            heads_kv=heads_kv, causal=causal, q_offset=q_offset,
            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (heads_q, heads_kv, causal, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        heads_q, heads_kv, causal, q_offset, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(
            scale_in_dtype(q, scale), k, v, out, lse, dout,
            heads_q=heads_q, heads_kv=heads_kv, causal=causal,
            q_offset=q_offset, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, heads_q: int, heads_kv: int, causal: bool = True,
              q_offset: int = 0, scale: float) -> torch.Tensor:
    """:class:`FlashAttention` where a gradient is wanted (grad enabled
    and an input that requires it); otherwise one forward launch on the
    scaled q with no ``lse`` — serving's cost is unchanged."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, heads_q, heads_kv, causal,
                                    q_offset, scale)
    return flash_attention(scale_in_dtype(q, scale), k, v, heads_q=heads_q,
                           heads_kv=heads_kv, causal=causal,
                           q_offset=q_offset)
