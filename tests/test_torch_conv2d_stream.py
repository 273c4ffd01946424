"""The module that holds the kernel.  On the CPU the port's
``ops.conv2d_stream`` takes the kernel's plain version; it is held here
against the reference's ``ops.conv2d_stream`` (the Pallas kernel in
interpret mode) on the same NumPy inputs.  Integers bit-exact; f32
within atol 1e-4 / rtol 1e-2 and bf16 within atol 1e-2 / rtol 1e-2 —
the tolerances of ``tests/test_kernels.py``; the reason is summation
order.  The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.core import dse as tdse
from repro_torch.kernels import conv2d_stream as tcs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _jax_out(x, w, jdtype=None, **kw):
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if jdtype is not None:
        jx, jw = jx.astype(jdtype), jw.astype(jdtype)
    return np.asarray(jops.conv2d_stream(jx, jw, **kw))


def _ints(rng, shape, dtype, lo=-6, hi=6):
    if dtype == np.uint8:
        lo = 0
    return rng.integers(lo, hi, size=shape).astype(dtype)


class TestAgainstTheReferenceKernel:
    @pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
    @pytest.mark.parametrize("k", [1, 3, 5])
    def test_kernel_sizes_dtypes(self, dtype, k):
        rng = np.random.default_rng(0)
        if dtype == "int8":
            x = _ints(rng, (2, 12, 12, 4), np.int8)
            w = _ints(rng, (k, k, 4, 8), np.int8)
            got = tops.conv2d_stream(_t(x), _t(w))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), _jax_out(x, w))
            return
        x = rng.standard_normal((2, 12, 12, 4)).astype(np.float32)
        w = rng.standard_normal((k, k, 4, 8)).astype(np.float32)
        if dtype == "bfloat16":
            # bf16 has no NumPy type: both sides round the same f32 data
            got = tops.conv2d_stream(_t(x, torch.bfloat16),
                                     _t(w, torch.bfloat16))
            want = _jax_out(x, w, jnp.bfloat16)
            atol = 1e-2
        else:
            got = tops.conv2d_stream(_t(x), _t(w))
            want = _jax_out(x, w)
            atol = 1e-4
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                                   atol=atol, rtol=1e-2)

    @pytest.mark.parametrize("hw", [(8, 8), (16, 8), (9, 13), (32, 32)])
    def test_shapes(self, hw):
        h, w_ = hw
        rng = np.random.default_rng(1)
        x = _ints(rng, (1, h, w_, 3), np.int8)
        w = _ints(rng, (3, 3, 3, 16), np.int8)
        got = tops.conv2d_stream(_t(x), _t(w))
        assert tuple(got.shape) == (1, h, w_, 16)
        np.testing.assert_array_equal(got.numpy(), _jax_out(x, w))

    @pytest.mark.parametrize("rows", [1, 2, 4])
    def test_rows_per_block_invariant(self, rows):
        rng = np.random.default_rng(3)
        x = _ints(rng, (1, 10, 10, 3), np.int8)
        w = _ints(rng, (3, 3, 3, 4), np.int8)
        got = tops.conv2d_stream(_t(x), _t(w), rows_per_block=rows)
        np.testing.assert_array_equal(
            got.numpy(), _jax_out(x, w, rows_per_block=rows))
        np.testing.assert_array_equal(
            got.numpy(), tops.conv2d_stream(_t(x), _t(w)).numpy())

    def test_int8_accumulates_int32(self):
        x = np.full((1, 8, 8, 64), 127, np.int8)
        w = np.full((3, 3, 64, 4), 127, np.int8)
        got = tops.conv2d_stream(_t(x), _t(w))
        assert got.dtype == torch.int32
        assert int(got.max()) > np.iinfo(np.int16).max
        np.testing.assert_array_equal(got.numpy(), _jax_out(x, w))

    @pytest.mark.parametrize("epilogue", [None, "relu", "squared_relu"])
    def test_int32_wraparound(self, epilogue):
        rng = np.random.default_rng(4)
        x = rng.integers(-2**31, 2**31 - 1, size=(1, 7, 6, 5)).astype(np.int32)
        w = rng.integers(-2**31, 2**31 - 1, size=(3, 3, 5, 4)).astype(np.int32)
        got = tops.conv2d_stream(_t(x), _t(w), epilogue=epilogue)
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_out(x, w, epilogue=epilogue))

    @pytest.mark.parametrize("stride", [1, 2, 3])
    @pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 3)),
                                         ((0, 0), (2, 1))],
                             ids=["same", "valid", "explicit", "explicit2"])
    @pytest.mark.parametrize("k", [1, 3, 5])
    def test_stride_padding_sweep(self, stride, padding, k):
        rng = np.random.default_rng(5)
        x = _ints(rng, (2, 11, 9, 3), np.int32)
        w = _ints(rng, (k, k, 3, 4), np.int32)
        got = tops.conv2d_stream(_t(x), _t(w), stride=stride, padding=padding)
        np.testing.assert_array_equal(
            got.numpy(), _jax_out(x, w, stride=stride, padding=padding))

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("epilogue", ["relu", "squared_relu"])
    def test_epilogues(self, stride, epilogue):
        rng = np.random.default_rng(6)
        x = _ints(rng, (1, 8, 8, 2), np.int8)
        w = _ints(rng, (3, 3, 2, 4), np.int8)
        got = tops.conv2d_stream(_t(x), _t(w), stride=stride,
                                 epilogue=epilogue)
        np.testing.assert_array_equal(
            got.numpy(), _jax_out(x, w, stride=stride, epilogue=epilogue))
        assert (got.numpy() >= 0).all()
        xf = np.random.default_rng(7).standard_normal((1, 8, 8, 2)).astype(np.float32)
        wf = np.random.default_rng(8).standard_normal((3, 3, 2, 4)).astype(np.float32)
        np.testing.assert_allclose(
            tops.conv2d_stream(_t(xf), _t(wf), stride=stride,
                               epilogue=epilogue).numpy(),
            _jax_out(xf, wf, stride=stride, epilogue=epilogue),
            atol=1e-4, rtol=1e-2)

    def test_fuse_relu_sugar(self):
        rng = np.random.default_rng(9)
        x = _ints(rng, (1, 8, 8, 2), np.int8)
        w = _ints(rng, (3, 3, 2, 4), np.int8)
        a = tops.conv2d_stream(_t(x), _t(w), fuse_relu=True)
        b = tops.conv2d_stream(_t(x), _t(w), epilogue="relu")
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), _jax_out(x, w, fuse_relu=True))
        with pytest.raises(ValueError):
            tops.conv2d_stream(_t(x), _t(w), fuse_relu=True,
                               epilogue="squared_relu")


class TestSameMm:
    """``conv2d_same_mm`` (per-tap products) equals ``conv2d_stream`` and
    the dense oracle bit for bit, for every integer width."""

    @pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.int32],
                             ids=["int8", "uint8", "int16", "int32"])
    @pytest.mark.parametrize("stride", [1, 2])
    def test_mm_matches_stream_and_reference(self, dtype, stride):
        rng = np.random.default_rng(10)
        x = _ints(rng, (2, 8, 8, 5), dtype)
        w = _ints(rng, (3, 3, 5, 4), dtype)
        a = tops.conv2d_stream(_t(x), _t(w), stride=stride)
        b = tops.conv2d_same_mm(_t(x), _t(w), stride=stride)
        c = tref.conv2d(_t(x), _t(w), stride=stride)
        assert a.dtype == b.dtype == c.dtype == torch.int32
        assert torch.equal(a, b) and torch.equal(a, c)
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(jops.conv2d_same_mm(
                jnp.asarray(x), jnp.asarray(w), stride=stride)))

    def test_int8_accumulation_exceeds_input_width(self):
        rng = np.random.default_rng(11)
        x = rng.integers(50, 101, size=(1, 6, 6, 16)).astype(np.int8)
        w = rng.integers(50, 101, size=(3, 3, 16, 2)).astype(np.int8)
        b = tops.conv2d_same_mm(_t(x), _t(w))
        assert b.dtype == torch.int32
        assert int(b.max()) > np.iinfo(np.int16).max
        np.testing.assert_array_equal(b.numpy(), _jax_out(x, w))


class TestPlainVersionAndWrapper:
    def test_strided_weight_slice_is_taken(self):
        rng = np.random.default_rng(12)
        x = _t(_ints(rng, (1, 8, 8, 4), np.int32))
        w = _t(_ints(rng, (3, 3, 4, 12), np.int32))
        whole = tops.conv2d_stream(x, w)
        for t in range(3):
            part = tops.conv2d_stream(x, w.narrow(3, 4 * t, 4))
            assert torch.equal(part, whole[..., 4 * t:4 * t + 4])

    def test_dense_runs_as_a_1x1_conv(self):
        rng = np.random.default_rng(13)
        a = _ints(rng, (3, 7, 33), np.int32, -2**20, 2**20)
        w = _ints(rng, (33, 5), np.int32, -2**20, 2**20)
        got = tops.mac_reduce("ac,cb->ab", [_t(a), _t(w)], [True, False])
        want = np.stack([np.asarray(jnp.einsum(
            "ac,cb->ab", jnp.asarray(a[i]), jnp.asarray(w))) for i in range(3)])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)  # wraps alike

    def test_other_contractions_use_einsum(self):
        rng = np.random.default_rng(14)
        a = rng.standard_normal((2, 4, 6)).astype(np.float32)
        b = rng.standard_normal((2, 6, 3)).astype(np.float32)
        got = tops.mac_reduce("ac,cb->ab", [_t(a), _t(b)], [True, True])
        np.testing.assert_allclose(got.numpy(), a @ b, atol=1e-5)

    def test_line_buffer_rows(self):
        from repro.kernels.conv2d_stream import line_buffer_rows as jlb

        for kh in range(1, 8):
            for s in range(1, 5):
                assert tcs.line_buffer_rows(kh, s) == jlb(kh, s)

    def test_conv_pads_match_the_reference(self):
        for h, w, k, s in [(8, 8, 3, 1), (9, 13, 5, 2), (16, 16, 3, 2),
                           (7, 7, 1, 3), (10, 10, 4, 3)]:
            for padding in ("SAME", "VALID", ((1, 0), (2, 3))):
                assert tops._conv_pads(h, w, k, k, s, padding) == \
                    jops._conv_pads(h, w, k, k, s, padding)
        with pytest.raises(ValueError):
            tops._conv_pads(2, 2, 3, 3, 1, "VALID")

    def test_same_mm_is_a_cpu_function(self):
        assert "CPU" in tops.conv2d_same_mm.__doc__


class TestPlanner:
    """``dse.plan_conv_rows`` for the kernel that streams weights through
    shared memory in Cin chunks (its planner has no counterpart in the
    reference: the Pallas kernel's blocks are the TPU's)."""

    HEADLINE = dict(h_out=224, w_out=224, c_in=136, c_out=136, kh=3, kw=3)

    @staticmethod
    def _work_share(shape, plan):
        """Output elements over the register-tile slots the launch runs."""
        b = plan.blocks
        slots = 0
        for band_i in range(plan.grid[1]):
            rows = min(b["rows"], shape["h_out"] - band_i * b["rows"])
            slots += -(-rows // b["rows_step"])
        slots *= plan.grid[0] * plan.grid[2] * b["threads"] * \
            b["tile_pixels"] * b["tile_channels"]
        return (shape["h_out"] * shape["w_out"] * shape["c_out"]
                * shape.get("batch", 1)) / slots

    @pytest.mark.parametrize("shape", [
        dict(h_out=32, w_out=32, c_in=1, c_out=6, kh=5, kw=5, batch=32),
        dict(h_out=32, w_out=32, c_in=16, c_out=16, kh=3, kw=3, batch=32),
        dict(h_out=8, w_out=8, c_in=8, c_out=16, kh=3, kw=3, stride=2,
             batch=32),
        HEADLINE,
        dict(HEADLINE, batch=4),
        dict(h_out=16, w_out=16, c_in=288, c_out=288, kh=3, kw=3),
        dict(h_out=1, w_out=32, c_in=4096, c_out=10, kh=1, kw=1),
        dict(h_out=1, w_out=512, c_in=128, c_out=256, kh=1, kw=1),
        dict(h_out=11, w_out=13, c_in=33, c_out=10, kh=3, kw=3),
    ], ids=lambda d: "x".join(str(v) for v in d.values()))
    def test_every_plan_fits_one_block(self, shape):
        plan = tdse.plan_conv_rows(**shape)
        assert plan.smem_bytes <= tdse.H100.smem_per_block
        assert plan.blocks["threads"] <= tdse.CONV_BLOCK_THREADS
        # the zoo's convs (Cin <= 32) stay resident, 3x3 convs of 136
        # channels and more stream
        if shape["c_in"] <= 32:
            assert not plan.blocks["streamed"]
        elif shape["kh"] == 3 and shape["c_in"] >= 136:
            assert plan.blocks["streamed"]

    def test_every_thread_has_work_at_the_headline(self):
        plan = tdse.plan_conv_rows(**self.HEADLINE)
        b = plan.blocks
        assert (b["tile_pixels"], b["tile_channels"]) == (8, 8)
        # one 8 x 8 tile per thread per step, seven full warps or more
        assert b["threads"] >= 224
        # and only the ragged edges of the frame and of Cout leave a
        # thread without outputs: over 90 % of the tile slots are outputs
        assert self._work_share(self.HEADLINE, plan) > 0.9

    def test_two_blocks_fit_an_sm_at_the_headline(self):
        plan = tdse.plan_conv_rows(**self.HEADLINE)
        assert plan.smem_bytes <= tdse.CONV_TWO_BLOCKS_SMEM
        assert 2 * plan.smem_bytes + 2 * 1024 <= 228 * 1024
        # and the launch gives every SM its two blocks
        gx, gy, gz = plan.grid
        assert gx * gy * gz >= 2 * tdse.H100.sms

    @pytest.mark.parametrize("c_out", [136, 288, 6, 10])
    def test_cout_is_covered_without_a_mostly_padded_tile(self, c_out):
        shape = dict(self.HEADLINE, c_out=c_out)
        b = tdse.plan_conv_rows(**shape).blocks
        n_ct = -(-c_out // b["c_tile"])
        last = c_out - (n_ct - 1) * b["c_tile"]
        assert 2 * last >= b["c_tile"]
        if c_out == 136:          # the old planner's 4 x 32 + 8
            assert n_ct <= 3

    def test_raises_only_where_nothing_fits(self):
        with pytest.raises(ValueError, match="shared-memory budget"):
            tdse.plan_conv_rows(**self.HEADLINE, smem_budget=1000)
        # the budget of one stage pair of the smallest tile is enough
        smallest = tdse.conv_smem_bytes(kh=3, kw=3, c_in=136, stride=1,
                                        rows_step=1, w_tile=2, c_tile=4,
                                        streamed=True)
        tdse.plan_conv_rows(**self.HEADLINE, smem_budget=smallest)

    def test_fill_bytes_count_halo_rows_and_weights_per_step(self):
        # one band of two 1-row steps, one tile each way: a streamed step
        # reads its 3 input rows of 10 pixels x 16 channels and the whole
        # 3x3x16x8 weight tile, 4 bytes an element
        assert tdse._conv_fill_bytes(
            batch=1, h_out=2, n_bands=1, band=2, n_wt=1, n_ct=1,
            rows_step=1, w_tile=8, c_tile=8, c_in=16, kh=3, kw=3, stride=1,
            streamed=True) == 4 * 2 * (3 * 10 * 16 + 9 * 16 * 8)
        # resident: the band's 4 rows once, the weights once
        assert tdse._conv_fill_bytes(
            batch=1, h_out=2, n_bands=1, band=2, n_wt=1, n_ct=1,
            rows_step=1, w_tile=8, c_tile=8, c_in=16, kh=3, kw=3, stride=1,
            streamed=False) == 4 * (4 * 10 * 16 + 9 * 16 * 8)

    def test_summation_order_is_fixed_by_the_chunk(self):
        """The chunk of the K loop is a constant of the kernel and of the
        planner alike, never a field of the plan: a plan only says how
        many whole chunks a streamed stage holds."""
        assert tdse.CONV_CIN_CHUNK == 8
        src = (tcs.LIBRARY.source).read_text()
        assert "constexpr int CK = 8;" in src
        for shape in (self.HEADLINE, dict(self.HEADLINE, h_out=16, w_out=16,
                                          c_in=288, c_out=48)):
            assert set(tdse.plan_conv_rows(**shape).blocks) == {
                "rows", "rows_step", "w_tile", "c_tile", "tile_pixels",
                "tile_channels", "threads", "streamed", "stage_chunks"}

    def test_a_small_deep_conv_takes_one_wave_of_full_resident_blocks(self):
        # fat_cascade_16's convs, 16²×288→48: the whole weight tile
        # resident, 256 threads of which those past the tiles only load,
        # every block in one wave
        shape = dict(h_out=16, w_out=16, c_in=288, c_out=48, kh=3, kw=3)
        plan = tdse.plan_conv_rows(**shape)
        b = plan.blocks
        tiles = b["rows_step"] * (b["w_tile"] // b["tile_pixels"]) * (
            b["c_tile"] // b["tile_channels"])
        assert not b["streamed"] and b["threads"] == 256 > tiles
        gx, gy, gz = plan.grid
        assert gx * gy * gz <= tdse.H100.sms
        # with six times the channels the launch is no longer one wave:
        # it streams, several chunks a stage
        wide = tdse.plan_conv_rows(**dict(shape, c_out=288)).blocks
        assert wide["streamed"] and wide["stage_chunks"] > 1
        # and Dense layers (1×1) keep streaming their deep Cin
        dense = tdse.plan_conv_rows(h_out=1, w_out=32, c_in=2048, c_out=64,
                                    kh=1, kw=1).blocks
        assert dense["streamed"]
        assert dense["threads"] == dense["rows_step"] * (
            dense["w_tile"] // dense["tile_pixels"]) * (
            dense["c_tile"] // dense["tile_channels"])
