"""KV-streaming flash attention (forward) for Hopper.

**Replaces** the TPU kernel ``repro/kernels/flash_attention.py::
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
runs with the kernel's own tiles.

**What bounds it on an H100.**  At the LM path's prefill shapes (B 4,
S 1024, 32 or 14 query heads of 64) a call does ≈ 17 GFLOP against
≈ 42 MB of q/k/v/o: arithmetic, not bytes — 17 µs at the bf16
tensor-core peak, 0.26 ms at the f32 CUDA-core peak.

**What the design does about it.**  bf16 runs on the tensor cores
(FA2-style): one block of 4 warps per (batch·head, 64 query rows), the
query tile held in registers as ``mma.sync`` fragments, key and value
tiles of 64 keys streamed through shared memory as bf16 in a
``cp.async`` double buffer, S = Q·Kᵀ and O += P·V by ``mma.sync`` with
f32 accumulation, the online softmax in registers, and P repacked to
bf16 fragments without touching shared memory (the Pallas kernel keeps P
in f32; l sums the f32 p).  f32 keeps the CUDA-core kernel (TF32 would
miss its 2e-5): every operand in shared memory as f32, each thread a
(block_q/16)×4 piece of the score tile
(``repro_torch.core.dse.plan_attention_blocks`` picks 64 or 32 rows).
On both, the heaviest causal tiles start first.

The library is built by ``nvcc`` at first use (``repro_torch.kernels.
build``).  Beside the kernel sits its plain PyTorch version,
:func:`flash_attention_plain`; :func:`flash_attention` takes it **only**
for a tensor that lies on the CPU — on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.dse import plan_attention_blocks
from repro_torch.kernels.build import CudaLibrary

NEG_INF = -1e30

#: input dtypes the kernel takes → the dtype code of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches so far (one per call that reached the card), and
#: calls of the plain version on a CUDA tensor (the wrapper never makes
#: one; a comparison harness does).  Guarded by ``_LOCK``.
launches = 0
plain_cuda_calls = 0

_LOCK = threading.Lock()


def _declare(lib) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


#: ``csrc/flash_attention.cu`` → ``build/libflash_attention.so``
LIBRARY = CudaLibrary("flash_attention", _declare)


def reset_counts() -> None:
    """Zero ``launches`` and ``plain_cuda_calls``."""
    global launches, plain_cuda_calls
    with _LOCK:
        launches = 0
        plain_cuda_calls = 0


def _check(q, k, v, heads_q: int, heads_kv: int) -> None:
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
) -> torch.Tensor:
    """The kernel's plain PyTorch version, with the kernel's masking (not
    ``ref.attention``'s): masked scores ``-1e30``, masked probabilities
    0, the sum guarded where it is 0 — so a row that sees no key gives 0,
    where ``ref.attention`` gives NaN.  Dense ``einsum`` in f32; output
    in ``q.dtype``."""
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
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / safe_l
    return out.reshape(bhq, sq, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,        # (B·Hq, Sq, D), pre-scaled
    k: torch.Tensor,        # (B·Hkv, Sk, D)
    v: torch.Tensor,        # (B·Hkv, Sk, D)
    *,
    heads_q: int,
    heads_kv: int,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention of pre-scaled ``q`` over ``k``/``v`` → ``(B·Hq, Sq, D)``
    in ``q.dtype`` (f32 or bf16).

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
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, heads_q=heads_q,
                                     heads_kv=heads_kv, causal=causal,
                                     q_offset=q_offset)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = LIBRARY.load()

    def launch() -> int:
        return lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], bhq, sq, sk, d, heads_q, heads_kv,
            int(causal), int(q_offset), plan.blocks["block_q"],
            torch.cuda.current_stream(q.device).cuda_stream,
        )

    if q.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(q.device):
            rc = launch()
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(
            f"flash_attention launch failed: {msg} (code {rc}); "
            f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} plan "
            f"{plan.blocks} smem {plan.smem_bytes}")
    with _LOCK:
        launches += 1
    return out
