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
