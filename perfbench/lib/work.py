"""The yardstick of the rooflines and of ``mfu``: the card's data-sheet
peaks and the work each hand-written kernel's call needs, frozen here from
the port's ``kernels/work.py`` so that a later change to a kernel shows as
a difference and not as a moved yardstick.

Peaks are NVIDIA's for one H100 SXM (dense, no sparsity) at its full
700 W.  A call's work is what its inputs need: each input byte read once,
each output byte written once, and the operations of the products the
function needs.  Left out of the copy: the SSD forward's tile states
(``ssd_work(states=True)`` in the port), which a kernel chooses to write
for its backward, so that a kernel that stops writing them cannot read
above 100 %.  The SSD's operations are counted over tiles of
:data:`SSD_WORK_TILE` positions, a count fixed since the first SSD kernel
whatever tile a kernel walks.
"""
from __future__ import annotations

import dataclasses

import torch

#: HBM3 bandwidth of one H100 SXM
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores
CUDA_CORE_OPS_PER_S = 67e12
#: dense bf16 (and fp16) on the tensor cores
TENSOR_CORE_BF16_OPS_PER_S = 989e12
#: the SSD's counting tile
SSD_WORK_TILE = 32


def peak_rate(dtype: torch.dtype) -> float:
    if dtype in (torch.bfloat16, torch.float16):
        return TENSOR_CORE_BF16_OPS_PER_S
    return CUDA_CORE_OPS_PER_S


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's operations and bytes, and the rate its operations run
    at."""

    flops: float
    bytes: float
    rate: float

    def bound_s(self) -> float:
        """The least time the card could take."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / self.rate)

    def bound_by(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / self.rate else "operations")

    def __add__(self, other: "Work") -> "Work":
        if self.rate != other.rate:
            raise ValueError("work at two rates")
        return Work(self.flops + other.flops, self.bytes + other.bytes,
                    self.rate)

    def scale(self, n: float) -> "Work":
        return Work(self.flops * n, self.bytes * n, self.rate)


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through."""
    if not causal:
        return sq * sk
    a, b = q_offset + 1, q_offset + sq
    lo, hi = max(a, 1), min(b, sk - 1)
    mid = (lo + hi) * (hi - lo + 1) // 2 if lo <= hi else 0
    return mid + max(0, b - max(a, sk) + 1) * sk


def attention_work(b, hq, hkv, sq, sk, d, causal, q_offset, dtype, *,
                   lse: bool = False) -> Work:
    """B2: two products of 2·D operations a visible pair; q, k, v read and
    out written (with ``lse`` the f32 log-sum-exp too)."""
    pairs = b * hq * visible_pairs(sq, sk, causal, q_offset)
    n_bytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * dtype.itemsize
    if lse:
        n_bytes += b * hq * sq * 4
    return Work(4 * d * pairs, n_bytes, peak_rate(dtype))


def attention_bwd_work(b, hq, hkv, sq, sk, d, causal, q_offset,
                       dtype) -> Work:
    """B2′: five products of 2·D operations a visible pair; q, k, v, out,
    dout and the f32 lse read, dq, dk and dv written."""
    pairs = b * hq * visible_pairs(sq, sk, causal, q_offset)
    n_bytes = ((4 * b * hq * sq + 4 * b * hkv * sk) * d * dtype.itemsize
               + b * hq * sq * 4)
    return Work(5 * 2 * d * pairs, n_bytes, peak_rate(dtype))


def _per_tile(l: int, q: int, term) -> int:
    full, rest = divmod(l, q)
    total = full * term(q, q * (q + 1) // 2)
    if rest:
        total += term(rest, rest * (rest + 1) // 2)
    return total


def ssd_flops(b, l, h, p, n, q: int = SSD_WORK_TILE) -> int:
    return 2 * b * _per_tile(
        l, q, lambda qv, tri: tri * n + h * (tri * p + 2 * qv * n * p))


def ssd_bwd_flops(b, l, h, p, n, q: int = SSD_WORK_TILE) -> int:
    return 2 * b * _per_tile(
        l, q, lambda qv, tri: tri * n + h * (2 * tri * p + 2 * tri * n
                                             + 4 * qv * p * n))


def ssd_work(b, l, h, p, n, dtype) -> Work:
    """B4: x, b and c read (in ``dtype``), dt, a and the initial state
    (f32) read, y and the final state written."""
    xs, bc = b * l * h * p * dtype.itemsize, b * l * n * dtype.itemsize
    state = b * h * p * n * 4
    n_bytes = 2 * xs + 2 * bc + b * l * h * 4 + h * 4 + 2 * state
    return Work(ssd_flops(b, l, h, p, n), n_bytes, peak_rate(dtype))


def ssd_bwd_work(b, l, h, p, n, dtype, *, state_grad: bool) -> Work:
    """B4′: x, dt, a, b, c, the initial state, dy (and the final state's
    cotangent) read, the six gradients written."""
    xs, bc = b * l * h * p * dtype.itemsize, b * l * n * dtype.itemsize
    dts, state = b * l * h * 4, b * h * p * n * 4
    reads = 2 * xs + 2 * bc + dts + h * 4 + state + (state if state_grad
                                                     else 0)
    writes = xs + 2 * bc + dts + h * 4 + state
    return Work(ssd_bwd_flops(b, l, h, p, n), reads + writes,
                peak_rate(dtype))
