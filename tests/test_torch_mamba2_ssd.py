"""The module that holds the SSD kernel.  On the CPU the port's
``ops.mamba2_ssd`` takes the kernel's plain version (``ref.ssd_chunked``);
it and the port's oracles ``ref.ssd``, ``ref.ssd_chunked`` and
``ref.ssd_decode_step`` are held against the reference's ``ops.mamba2_ssd``
(the Pallas kernel in interpret mode) and oracles on the same NumPy
inputs, at the cases of ``tests/test_kernels.py:196-266`` — chunks
4/8/16/32 against the sequential recurrence, the state carried across two
calls, the decode step, random batch and head counts — at the
reference's tolerances (1e-3 kernel vs recurrence, 1e-4 oracle vs
oracle), plus bf16 (1e-2: both round an f32 result to bf16).  The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below."""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: the vendored fallback runs the draws
    from _hypothesis_fallback import given, settings, st

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import dse
from repro_torch.kernels import build
from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)

KERNEL_TOL = dict(atol=1e-3, rtol=1e-3)
ORACLE_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, b=2, l=32, h=4, p=8, n=8):
    """The reference test's distributions, drawn with NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


def _t(arrs, dtype=torch.float32):
    """x, b, c in ``dtype``; dt and a f32 (as the model passes them)."""
    x, dt, a, bm, cm = arrs
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(bm).to(dtype),
            torch.from_numpy(cm).to(dtype))


def _j(arrs, dtype="float32"):
    x, dt, a, bm, cm = arrs
    return (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(bm).astype(dtype), jnp.asarray(cm).astype(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunk_sizes_vs_sequential(chunk):
    arrs = _inputs(0)
    got = tops.mamba2_ssd(*_t(arrs), chunk=chunk)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _close(got, jref.ssd(*_j(arrs)), KERNEL_TOL)
    _close(got, jops.mamba2_ssd(*_j(arrs), chunk=chunk, interpret=True),
           KERNEL_TOL)


def test_chunked_oracle_matches_sequential():
    arrs = _inputs(1)
    y1, s1 = tref.ssd_chunked(*_t(arrs), chunk=8)
    y2, s2 = tref.ssd(*_t(arrs))
    _close((y1, s1), (y2, s2), ORACLE_TOL)
    _close((y1, s1), jref.ssd_chunked(*_j(arrs), chunk=8), ORACLE_TOL)
    _close((y2, s2), jref.ssd(*_j(arrs)), ORACLE_TOL)


def test_init_state_carried():
    """Two calls with the state carried equal one full-length call (the
    prefill/decode contract)."""
    x, dt, a, bm, cm = _t(_inputs(2, l=32))
    y_full, s_full = tops.mamba2_ssd(x, dt, a, bm, cm, chunk=8)
    y1, s1 = tops.mamba2_ssd(x[:, :16], dt[:, :16], a, bm[:, :16],
                             cm[:, :16], chunk=8)
    y2, s2 = tops.mamba2_ssd(x[:, 16:], dt[:, 16:], a, bm[:, 16:],
                             cm[:, 16:], init_state=s1, chunk=8)
    _close((torch.cat([y1, y2], 1), s2), (y_full, s_full), KERNEL_TOL)
    jx, jdt, ja, jb, jc = _j(_inputs(2, l=32))
    _, js1 = jops.mamba2_ssd(jx[:, :16], jdt[:, :16], ja, jb[:, :16],
                             jc[:, :16], chunk=8, interpret=True)
    _close((s1,), (js1,), KERNEL_TOL)


def test_decode_step_matches_scan():
    arrs = _inputs(3, l=8)
    x, dt, a, bm, cm = _t(arrs)
    _, state = tref.ssd(x[:, :7], dt[:, :7], a, bm[:, :7], cm[:, :7])
    y_step, s_step = tref.ssd_decode_step(state, x[:, 7], dt[:, 7], a,
                                          bm[:, 7], cm[:, 7])
    y_full, s_full = tref.ssd(x, dt, a, bm, cm)
    _close((y_step, s_step), (y_full[:, 7], s_full), ORACLE_TOL)
    jx, jdt, ja, jb, jc = _j(arrs)
    jy, js = jref.ssd_decode_step(jnp.asarray(state.numpy()), jx[:, 7],
                                  jdt[:, 7], ja, jb[:, 7], jc[:, 7])
    _close((y_step, s_step), (jy, js), ORACLE_TOL)


@given(st.integers(1, 4), st.integers(1, 3))
@settings(max_examples=10, deadline=None)
def test_property_random_shapes(b, h):
    arrs = _inputs(4, b=b, l=16, h=h)
    got = tops.mamba2_ssd(*_t(arrs), chunk=8)
    _close(got, jref.ssd(*_j(arrs)), KERNEL_TOL)


@pytest.mark.parametrize("chunk", [8, 32])
def test_bfloat16(chunk):
    """x, b and c in bf16, dt and a in f32, as the model passes them."""
    arrs = _inputs(5)
    got = tops.mamba2_ssd(*_t(arrs, torch.bfloat16), chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    want = jops.mamba2_ssd(*_j(arrs, "bfloat16"), chunk=chunk,
                           interpret=True)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("l", [96, 37, 1])
def test_default_chunk_is_the_reference_default(l):
    """The largest divisor of L up to 128, as the reference picks it (1
    for a prime L)."""
    assert tops._pick_block(l, 128) == jops._pick_block(l, 128)
    arrs = _inputs(6, b=1, l=l, h=2)
    _close(tops.mamba2_ssd(*_t(arrs)),
           jops.mamba2_ssd(*_j(arrs), interpret=True), KERNEL_TOL)


def test_chunk_that_does_not_divide_raises_as_in_the_reference():
    arrs = _inputs(7, l=12)
    with pytest.raises(AssertionError):
        jops.mamba2_ssd(*_j(arrs), chunk=5, interpret=True)
    with pytest.raises(ValueError, match="chunk"):
        tops.mamba2_ssd(*_t(arrs), chunk=5)
    with pytest.raises(ValueError, match="chunk"):
        tref.ssd_chunked(*_t(arrs), chunk=5)


def test_column_slices_of_one_projection():
    """The model hands in x, b and c as column slices of one (B, L, C)
    tensor: the same result as contiguous copies."""
    x, dt, a, bm, cm = _t(_inputs(8))
    b, l, h, p = x.shape
    xbc = torch.cat([x.reshape(b, l, h * p), bm, cm], dim=-1)
    xs = xbc[..., :h * p].reshape(b, l, h, p)
    bs, cs = xbc[..., h * p: h * p + 8], xbc[..., h * p + 8:]
    assert not xs.is_contiguous() and not bs.is_contiguous()
    _close(tops.mamba2_ssd(xs, dt, a, bs, cs, chunk=8),
           tops.mamba2_ssd(x, dt, a, bm, cm, chunk=8), dict(atol=0, rtol=0))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, a, bm, cm = _t(_inputs(9))
    s0 = torch.zeros(2, 4, 8, 8)
    with pytest.raises(TypeError):
        tms.mamba2_ssd(x.double(), dt, a, bm.double(), cm.double(), s0,
                       chunk=8)
    with pytest.raises(TypeError):
        tms.mamba2_ssd(x, dt, a, bm.to(torch.bfloat16), cm, s0, chunk=8)
    with pytest.raises(ValueError, match="fit"):
        tms.mamba2_ssd(x, dt[:, :16], a, bm, cm, s0, chunk=8)
    with pytest.raises(ValueError, match="fit"):
        tms.mamba2_ssd(x, dt, a, bm, cm, s0[:, :2], chunk=8)
    with pytest.raises(ValueError, match="wants"):
        tms.mamba2_ssd(x[0], dt, a, bm, cm, s0, chunk=8)
    wide = _t(_inputs(10, b=1, l=4, h=1, p=65, n=8))
    with pytest.raises(ValueError, match="head_dim"):
        tops.mamba2_ssd(*wide, chunk=4)
    deep = _t(_inputs(11, b=1, l=4, h=1, p=8, n=129))
    with pytest.raises(ValueError, match="state_dim"):
        tops.mamba2_ssd(*deep, chunk=4)


def test_cpu_call_never_builds_or_loads_the_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path reached for the CUDA library")

    monkeypatch.setattr(tms.LIBRARY, "load", boom)
    monkeypatch.setattr(build, "build_libraries", boom)
    monkeypatch.setattr(build.subprocess, "Popen", boom)
    before = (tms.launches, tms.plain_cuda_calls)
    y, s = tops.mamba2_ssd(*_t(_inputs(12)), chunk=8)
    assert y.shape == (2, 32, 4, 8) and s.shape == (2, 4, 8, 8)
    assert (tms.launches, tms.plain_cuda_calls) == before


class TestPlanner:
    def test_model_shape(self):
        # bf16, the call mamba2-1.3b makes: the tensor-core route, 64
        # positions and two heads a block, one block an SM
        p = dse.plan_ssd_blocks(batch=4, length=1024, heads=64, head_dim=64,
                                state_dim=128, dtype="bfloat16")
        assert p.blocks == {"route": "mma", "block_l": 64,
                            "heads_per_block": 2}
        assert p.grid == 128 and p.smem_bytes == 178_720
        assert p.smem_bytes <= dse.H100.smem_per_block
        # f32 keeps the CUDA-core kernel: 32 positions, two blocks an SM
        q = dse.plan_ssd_blocks(batch=4, length=1024, heads=64, head_dim=64,
                                state_dim=128, dtype="float32")
        assert q.grid == 256 and q.blocks["block_l"] == dse.SSD_BLOCK_L == 32
        assert q.blocks["route"] == "cuda_core"
        assert q.smem_bytes == 78_980 and 2 * q.smem_bytes < 228 * 1024

    def test_odd_pitch(self):
        even = dse.ssd_smem_bytes(head_dim=16, state_dim=16)
        odd = dse.ssd_smem_bytes(head_dim=16, state_dim=17)
        assert even == odd        # N 16 takes the pitch 17, as N 17 does

    def test_limits(self):
        for dtype in ("float32", "bfloat16"):
            with pytest.raises(ValueError, match="head_dim"):
                dse.plan_ssd_blocks(batch=1, length=8, heads=1, head_dim=65,
                                    state_dim=8, dtype=dtype)
            with pytest.raises(ValueError, match="state_dim"):
                dse.plan_ssd_blocks(batch=1, length=8, heads=1, head_dim=8,
                                    state_dim=129, dtype=dtype)
            with pytest.raises(ValueError, match="empty"):
                dse.plan_ssd_blocks(batch=1, length=0, heads=1, head_dim=8,
                                    state_dim=8, dtype=dtype)

    @pytest.mark.parametrize("batch,tile", [(2, dse.SSD_MMA_NARROW),
                                            (80, dse.SSD_MMA_WIDE)])
    def test_every_bf16_tile_fits_one_block(self, batch, tile):
        # the planner's own choice: two rows of three heads leave the card
        # idle (narrow tile), eighty rows fill it (wide tile)
        q, hb = tile
        p = dse.plan_ssd_blocks(batch=batch, length=100, heads=3, head_dim=8,
                                state_dim=8, dtype="bfloat16")
        assert (p.blocks["block_l"], p.blocks["heads_per_block"]) == tile
        # the tiles are padded: P and N do not change the footprint
        assert p.smem_bytes == dse.ssd_mma_smem_bytes(block_l=q,
                                                      heads_per_block=hb)
        assert p.smem_bytes <= dse.H100.smem_per_block
        assert p.grid == batch * -(-3 // hb)   # an odd H leaves a group idle

    def test_mma_smem_formula(self):
        # c and b, two stages of 32 x 136 bf16; per head x (two stages of
        # 32 x 72), the state's hi and lo (64 x 136 each), dt (two stages)
        # and three f32 vectors of 32, and 16 bytes
        assert dse.ssd_mma_smem_bytes(block_l=32, heads_per_block=1) == (
            2 * 2 * 32 * 136 * 2
            + (2 * 32 * 72 + 2 * 64 * 136) * 2 + 5 * 32 * 4 + 16)

    def test_small_batches_take_the_narrow_tile(self):
        # one batch row of 64 heads in pairs is 32 blocks for 132 SMs
        p = dse.plan_ssd_blocks(batch=1, length=1024, heads=64, head_dim=64,
                                state_dim=128, dtype="bfloat16")
        assert (p.blocks["block_l"], p.blocks["heads_per_block"]) == \
            dse.SSD_MMA_NARROW and p.grid == 64

    def test_tiles_the_route_lacks_raise(self):
        with pytest.raises(ValueError, match="no route"):
            dse.plan_ssd_blocks(batch=1, length=8, heads=1, head_dim=8,
                                state_dim=8, dtype="float16")
        # the launcher takes exactly the tiles the planner may pick (the
        # bf16 kernel's instantiations, and the f32 kernel's one tile)
        # and refuses any other plan
        src = tms.LIBRARY.source.read_text()
        body = src[src.index("int mamba2_ssd_launch("):]
        bf16 = set(re.findall(r"block_l == (\d+) && heads_per_block == (\d+)",
                              body))
        assert {(int(q), int(hb)) for q, hb in bf16} == set(dse.SSD_MMA_TILES)
        assert "if (block_l != QT || heads_per_block != 1) return " \
            "(int)cudaErrorInvalidValue;" in body
        assert re.search(r"constexpr int QT = %d;" % dse.SSD_BLOCK_L, src)


def _tensor_core_walk(x, dt, a, b_mat, c_mat, s0, *, block_l, split):
    """The bf16 kernel's arithmetic written out on the CPU: tiles of
    ``block_l`` positions; c·bᵀ from the bf16 operands with f32 sums
    (exact products); the gated c·bᵀ (G), the state (S) and x·w each fed
    to its product as bf16 — a high part plus a low part where ``split``
    names it, the high part alone where it does not; every sum in f32; y
    rounded to bf16 once.  ``split=None`` feeds every operand unrounded."""
    bf = torch.bfloat16

    def feed(v, name):
        if split is None:
            return v
        hi = v.to(bf).float()
        return hi + (v - hi).to(bf).float() if name in split else hi

    bsz, l, h, p = x.shape
    xf, bf_, cf = x.float(), b_mat.float(), c_mat.float()
    state, ys = s0.clone(), []
    for l0 in range(0, l, block_l):
        sl = slice(l0, min(l, l0 + block_l))
        xq, dq, bq, cq = xf[:, sl], dt[:, sl], bf_[:, sl], cf[:, sl]
        q = xq.shape[1]
        cum = torch.cumsum(dq * a, 1)                          # (B, Q, H)
        tri = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, :, :, None]
        rel = torch.where(tri, cum[:, :, None] - cum[:, None], 0.0)
        cb = torch.einsum("btn,bsn->bts", cq, bq)
        g = torch.where(tri, cb[..., None] * torch.exp(rel) * dq[:, None],
                        0.0)
        y = torch.einsum("btsh,bshp->bthp", feed(g, "G"), xq)
        y = y + torch.einsum("btn,bhpn->bthp", cq, feed(state, "S")) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        w = dq * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bshp,bsn->bhpn", feed(xq * w[..., None], "xw"), bq)
    return torch.cat(ys, 1).to(x.dtype), state


def _share_of_tolerance(got, want, tol):
    """max |got - want| / (tol + tol·|want|): 1.0 is the limit of
    ``chip_smoke._close``."""
    g, w = _np(got), _np(want)
    return float((np.abs(g - w) / (tol + tol * np.abs(w))).max())


def _model_width_inputs(seed):
    """mamba2-1.3b's head and state widths (P 64, N 128), few heads, a
    sequence of 512 — chip_smoke's distributions, drawn with NumPy."""
    arrs = _inputs(seed, b=2, l=512, h=3, p=64, n=128)
    return arrs, _t(arrs, torch.bfloat16)


@pytest.mark.parametrize("block_l", [32, 64])
def test_tensor_core_rounding_meets_the_tolerance(block_l):
    """G, S and x·w as bf16 high + low parts: y stays within 0.7 of
    ``SSD_TOL["bfloat16"]`` of the reference's ``ref.ssd`` on the same
    bf16 inputs (0.57-0.60 on these draws: what remains is one bf16 step
    of y), and the final state within 0.05 of the f32 state tolerance
    (0.004-0.008)."""
    import chip_smoke

    for seed in (20, 21):
        arrs, (x, dt, a, bm, cm) = _model_width_inputs(seed)
        s0 = torch.zeros(2, 3, 64, 128)
        y, s = _tensor_core_walk(x, dt, a, bm, cm, s0, block_l=block_l,
                                 split={"G", "S", "xw"})
        jy, js = jref.ssd(*_j(arrs, "bfloat16"))
        assert _share_of_tolerance(y, jy, chip_smoke.SSD_TOL["bfloat16"]) \
            <= 0.7
        assert _share_of_tolerance(s, js, chip_smoke.SSD_TOL["float32"]) \
            <= 0.05


@pytest.mark.parametrize("alone", ["G", "S", "xw"])
def test_rounding_an_operand_to_bf16_alone_misses_the_tolerance(alone):
    """Why every f32 operand enters as two parts: rounding any one of G,
    S or x·w to bf16 alone (the others split) puts y (G: 1.9-2.1× its
    tolerance, S: 0.9-1.3×) or the state (x·w: 3.2-4.9×) past its
    tolerance against ``ref.ssd`` on at least one of two seeded draws at
    mamba2-1.3b's widths."""
    import chip_smoke

    worst = 0.0
    for seed in (20, 21):
        arrs, (x, dt, a, bm, cm) = _model_width_inputs(seed)
        s0 = torch.zeros(2, 3, 64, 128)
        y, s = _tensor_core_walk(x, dt, a, bm, cm, s0, block_l=64,
                                 split={"G", "S", "xw"} - {alone})
        jy, js = jref.ssd(*_j(arrs, "bfloat16"))
        worst = max(worst,
                    _share_of_tolerance(y, jy, chip_smoke.SSD_TOL["bfloat16"]),
                    _share_of_tolerance(s, js, chip_smoke.SSD_TOL["float32"]))
    assert worst > 1.0


def test_the_walk_without_rounding_is_the_chunked_scan():
    """The emulation above is the chunked scan itself when nothing is
    rounded: it matches ``ref.ssd_chunked`` in f32 (the tests of the
    rounding measure the rounding, not a different algorithm)."""
    arrs = _inputs(22, b=2, l=100, h=3, p=8, n=8)
    x, dt, a, bm, cm = _t(arrs)
    s0 = torch.zeros(2, 3, 8, 8)
    got = _tensor_core_walk(x, dt, a, bm, cm, s0, block_l=32, split=None)
    exact = tref.ssd_chunked(x, dt, a, bm, cm, chunk=25)
    _close(got, exact, ORACLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the sweep is ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, dt, a, bm, cm = (t.cuda() for t in
                        _t(_inputs(13, b=2, l=100, h=3, p=64, n=128),
                           getattr(torch, dtype)))
    s0 = torch.zeros(2, 3, 64, 128, device="cuda")
    got = tms.mamba2_ssd(x, dt, a, bm, cm, s0, chunk=4)
    exp = tms.mamba2_ssd_plain(x, dt, a, bm, cm, s0, chunk=4)
    tol = KERNEL_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got[0].float(), exp[0].float(), **tol)
    torch.testing.assert_close(got[1], exp[1], **KERNEL_TOL)
