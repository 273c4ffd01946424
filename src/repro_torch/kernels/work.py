"""The work of each hand-written kernel, and the card's data-sheet peaks
that bound it: one count, read by

* the kernels' ``meta`` branches, which record a call's work with
  :func:`record_kernel` in place of its launch,
* ``chip_smoke.py``'s bound rows (``bound_ms`` of every kernel),
* the dry-run (``launch/dryrun.py``, through ``launch/roofline.py``).

Every rate here is **modeled for an H100 SXM (data sheet)**, none is a
measurement.  A kernel's work is what its inputs need, not what a kernel
happens to do: each input byte read once, each output byte written once,
and the operations of the products the function needs (attention over
the visible (query, key) pairs; the SSD counted over tiles of
:data:`SSD_WORK_TILE` positions whatever tile a kernel walks).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

#: HBM3 bandwidth of one H100 SXM
HBM_BYTES_PER_S = 3.35e12
#: CUDA-core rate: 67 TFLOP/s float32 outside the tensor cores
CUDA_CORE_OPS_PER_S = 67e12
#: CUDA-core 32-bit integer rate: 64 multiply-adds a clock an SM at
#: compute capability 9.0 (the CUDA C++ Programming Guide's arithmetic
#: instruction throughput table; 128 for f32 FMA) × 132 SMs × 1.98 GHz ×
#: 2 operations ≈ 33.4 TOP/s — the ceiling of an int32 conv
CUDA_CORE_INT32_OPS_PER_S = 64 * 132 * 1.98e9 * 2
#: dense bf16 (and fp16) tensor-core rate
TENSOR_CORE_BF16_OPS_PER_S = 989e12

#: the tile over which :func:`ssd_flops` counts a scan's operations (fixed
#: since the first SSD kernel, so that the bound reads the same work)
SSD_WORK_TILE = 32


def peak_rate(dtype: torch.dtype) -> float:
    """Peak operations a second of a product in ``dtype``: bf16 and fp16
    on the tensor cores, anything else (f32: TF32 is off, and the
    kernels' f32 route) on the CUDA cores."""
    if dtype in (torch.bfloat16, torch.float16):
        return TENSOR_CORE_BF16_OPS_PER_S
    return CUDA_CORE_OPS_PER_S


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's operations and bytes (each input read once, each output
    written once), and the peak rate its operations run at."""

    flops: float
    bytes: float
    rate: float

    def bound_ms(self) -> float:
        """The least time the card could take: the larger of bytes over
        HBM and operations over the work's rate."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / self.rate) * 1e3

    def bound_by(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S >= self.flops
                / self.rate else "operations")


# ---------------------------------------------------------------------------
# attention (B2 and its backward B2′)
# ---------------------------------------------------------------------------


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through — the work this input
    needs, not the most it could: query row r sees keys [0, r + q_offset]
    clamped to [0, Sk)."""
    if not causal:
        return sq * sk
    # Σ over t = r + q_offset + 1, r in [0, Sq), of clamp(t, 0, Sk)
    a, b = q_offset + 1, q_offset + sq
    lo, hi = max(a, 1), min(b, sk - 1)
    mid = (lo + hi) * (hi - lo + 1) // 2 if lo <= hi else 0
    return mid + max(0, b - max(a, sk) + 1) * sk


def attention_work(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                   causal: bool, q_offset: int, dtype: torch.dtype, *,
                   lse: bool = False) -> Work:
    """The forward: two products of 2·D operations a visible pair; q, k,
    v read and out written (and with ``lse`` the f32 log-sum-exp)."""
    pairs = b * hq * visible_pairs(sq, sk, causal, q_offset)
    n_bytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * dtype.itemsize
    if lse:
        n_bytes += b * hq * sq * 4
    return Work(4 * d * pairs, n_bytes, peak_rate(dtype))


def attention_bwd_work(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                       causal: bool, q_offset: int,
                       dtype: torch.dtype) -> Work:
    """The backward: five products of 2·D operations a visible pair (S
    recomputed, dP, dV, dS·K, dSᵀ·Q); q, k, v, out, dout and the f32 lse
    read, dq, dk and dv written: four tensors of q's size, four of k's."""
    pairs = b * hq * visible_pairs(sq, sk, causal, q_offset)
    n_bytes = ((4 * b * hq * sq + 4 * b * hkv * sk) * d * dtype.itemsize
               + b * hq * sq * 4)
    return Work(5 * 2 * d * pairs, n_bytes, peak_rate(dtype))


# ---------------------------------------------------------------------------
# the fused MLP (B3 and its backward B3′)
# ---------------------------------------------------------------------------


def mlp_work(m: int, d: int, f: int, gated: bool,
             dtype: torch.dtype) -> Work:
    """The forward: x·Wg, x·Wu and h·Wd (ungated two products); x and the
    weights read, the output written — the (M, F) hidden never is."""
    weights = 3 if gated else 2
    return Work(2 * m * d * f * weights,
                (2 * m * d + weights * d * f) * dtype.itemsize,
                peak_rate(dtype))


def mlp_bwd_work(m: int, d: int, f: int, gated: bool,
                 dtype: torch.dtype) -> Work:
    """The backward: dh, dWd, dWu, dWg and dx's two products, 12·M·D·F
    operations (ungated 8); x, the weights and dy read, dx and the weight
    gradients written: three (M, D) tensors, each weight twice."""
    weights = 3 if gated else 2
    return Work(2 * m * d * f * (6 if gated else 4),
                (3 * m * d + 2 * weights * d * f) * dtype.itemsize,
                peak_rate(dtype))


def mlp_bwd_mma_work(m: int, d: int, f: int, gated: bool) -> dict:
    """Each backward kernel's tensor-core operations with the lo planes
    counted: the hidden kernel's g, u and dh (ungated u and dh), 2·M·D·F
    each; the weight gradients' two or three products and dx's one or two
    terms, each with its hi + lo operand, 4·M·D·F each."""
    p = 2 * m * d * f
    terms = 2 if gated else 1
    return {"mlp_bwd_hidden": (terms + 1) * p,
            "mlp_bwd_wgrad": (terms + 1) * 2 * p,
            "mlp_bwd_dx": terms * 2 * p}


# ---------------------------------------------------------------------------
# the SSD scan (B4 and its backward B4′)
# ---------------------------------------------------------------------------


def _per_tile(l: int, q: int, term) -> int:
    """Σ over the tiles of ``q`` positions of ``term(qv, tri)``, qv the
    tile's positions and tri = qv·(qv+1)/2 its causal pairs."""
    full, rest = divmod(l, q)
    total = full * term(q, q * (q + 1) // 2)
    if rest:
        total += term(rest, rest * (rest + 1) // 2)
    return total


def ssd_flops(b: int, l: int, h: int, p: int, n: int,
              q: int = SSD_WORK_TILE) -> int:
    """Operations of one scan with tiles of ``q`` positions: per tile the
    causal half of c·bᵀ once (shared by the heads), and per head the
    causal intra term, the carried-state term and the state update."""
    return 2 * b * _per_tile(
        l, q, lambda qv, tri: tri * n + h * (tri * p + 2 * qv * n * p))


def ssd_bwd_flops(b: int, l: int, h: int, p: int, n: int,
                  q: int = SSD_WORK_TILE) -> int:
    """Operations of one backward with tiles of ``q`` positions: per tile
    the causal half of c·bᵀ once (shared by the heads) and, per head, the
    causal dy·xᵀ, the intra terms of dx, dc and db, and the four (P, N)
    products (dS·b, xᵀ·dS, dyᵀ·S, the carried dS)."""
    return 2 * b * _per_tile(
        l, q, lambda qv, tri: tri * n + h * (2 * tri * p + 2 * tri * n
                                             + 4 * qv * p * n))


def ssd_work(b: int, l: int, h: int, p: int, n: int, dtype: torch.dtype, *,
             states: bool = False) -> Work:
    """The scan: :func:`ssd_flops`; x, b and c (in ``dtype``), dt, a and
    the initial state (f32) read, y (``dtype``) and the final state (f32)
    written — with ``states`` also the f32 state entering each tile of
    :data:`SSD_WORK_TILE` positions, which the backward reads."""
    xs, bc = b * l * h * p * dtype.itemsize, b * l * n * dtype.itemsize
    state = b * h * p * n * 4
    n_bytes = 2 * xs + 2 * bc + b * l * h * 4 + h * 4 + 2 * state
    if states:
        n_bytes += state * -(-l // SSD_WORK_TILE)
    return Work(ssd_flops(b, l, h, p, n), n_bytes, peak_rate(dtype))


def ssd_bwd_work(b: int, l: int, h: int, p: int, n: int, dtype: torch.dtype,
                 *, state_grad: bool) -> Work:
    """The backward: :func:`ssd_bwd_flops`; x, dt, a, b, c, the initial
    state, dy (and the final state's cotangent) read once, the six
    gradients (dx, db, dc in ``dtype``; ddt, da, the initial state's in
    f32) written once."""
    xs, bc = b * l * h * p * dtype.itemsize, b * l * n * dtype.itemsize
    dts, state = b * l * h * 4, b * h * p * n * 4
    reads = 2 * xs + 2 * bc + dts + h * 4 + state + (state if state_grad
                                                     else 0)
    writes = xs + 2 * bc + dts + h * 4 + state
    return Work(ssd_bwd_flops(b, l, h, p, n), reads + writes,
                peak_rate(dtype))


def ssd_bwd_design_bytes(b: int, l: int, h: int, p: int, n: int,
                         itemsize: int, *, tile: int, heads_per_block: int,
                         state_grad: bool) -> int:
    """Bytes the two-kernel backward moves at one shape, each kernel's
    reads and writes counted once: the pass reads dy, c, dt (and the
    state's cotangent) and writes dS_k for every tile and the initial
    state's gradient; the tile kernel reads x, dy, b, c, dt, the saved
    states and dS_k and writes dx, ddt and the db, dc and da partials;
    the wrapper's sums read the partials and write db, dc and da."""
    nt = -(-l // tile)
    xs = b * l * h * p * itemsize              # x, dy or dx
    bc = b * l * n * itemsize                  # b, c, db or dc
    dts = b * l * h * 4                        # dt or ddt
    tiles = b * h * nt * p * n * 4             # the states or dS_k
    state = b * h * p * n * 4
    parts = 2 * b * -(-h // heads_per_block) * l * n * 4 + b * h * nt * 4
    pass_ = xs + bc + dts + tiles + state + (state if state_grad else 0)
    tile_ = 2 * xs + 2 * bc + dts + 2 * tiles + xs + dts + parts
    sums = parts + 2 * bc + h * 4
    return pass_ + tile_ + sums


# ---------------------------------------------------------------------------
# the streaming conv (B1)
# ---------------------------------------------------------------------------


def conv_work(x_bytes: int, w_bytes: int, out_bytes: int, out_numel: int,
              k: int, c_in: int, floating: bool) -> Work:
    """One conv: a multiply-add per output element, tap and input channel;
    x and w read, the output written.  Floats at the CUDA cores' f32
    rate, integers at their int32 rate (the kernel's CUDA-core route)."""
    macs = out_numel * k * k * c_in
    return Work(2 * macs, x_bytes + w_bytes + out_bytes,
                CUDA_CORE_OPS_PER_S if floating
                else CUDA_CORE_INT32_OPS_PER_S)


def record_kernel(name: str, work: Work, like: torch.Tensor) -> None:
    """What a kernel's wrapper calls on ``meta`` tensors in place of its
    launch: one launch of ``name`` doing ``work`` (``like`` its main
    output), handed to every active dispatch mode that counts kernels —
    one with a ``count_kernel`` method, as
    ``launch.graph_analysis.StepCounter`` has.  With none active nothing
    is recorded."""
    for mode in _get_current_dispatch_mode_stack():
        count = getattr(mode, "count_kernel", None)
        if count is not None:
            count(name, work, like)
