"""``repro_torch.kernels.ref`` and ``repro_torch.passes.interp`` against
the reference package's, on the same NumPy inputs.  Integers are
bit-exact (``assert_array_equal``); floats agree within atol 1e-4 /
rtol 1e-2 (sums are taken in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.api as japi
from repro.kernels import ref as jref
from repro.passes import interp as jinterp

import repro_torch.api as tapi
from repro_torch.kernels import ref as tref
from repro_torch.passes import interp as tinterp

from _torch_port import compiled_pair, int_env

F32 = dict(atol=1e-4, rtol=1e-2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j)


class TestConv2dOracle:
    @pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
    @pytest.mark.parametrize("stride", [1, 2, 3])
    @pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 3))],
                             ids=["same", "valid", "explicit"])
    def test_integer_bit_exact(self, dtype, stride, padding):
        rng = np.random.default_rng(0)
        x = rng.integers(-6, 6, size=(2, 9, 11, 3)).astype(dtype)
        w = rng.integers(-6, 6, size=(3, 3, 3, 5)).astype(dtype)
        _eq(tref.conv2d(_t(x), _t(w), stride=stride, padding=padding),
            jref.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                        padding=padding))

    @pytest.mark.parametrize("epilogue", [None, "relu", "squared_relu"])
    def test_int32_wraps_like_the_reference(self, epilogue):
        rng = np.random.default_rng(1)
        x = rng.integers(-2**31, 2**31 - 1, size=(1, 6, 6, 4)).astype(np.int32)
        w = rng.integers(-2**31, 2**31 - 1, size=(3, 3, 4, 3)).astype(np.int32)
        _eq(tref.conv2d(_t(x), _t(w), epilogue=epilogue),
            jref.conv2d(jnp.asarray(x), jnp.asarray(w), epilogue=epilogue))

    @pytest.mark.parametrize("k", [1, 3, 5])
    def test_float_close(self, k):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 12, 12, 4)).astype(np.float32)
        w = rng.standard_normal((k, k, 4, 8)).astype(np.float32)
        got = tref.conv2d(_t(x), _t(w), fuse_relu=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w),
                                   fuse_relu=True)), **F32)

    def test_conflicting_epilogue_rejected(self):
        x = torch.zeros(1, 4, 4, 1, dtype=torch.int32)
        w = torch.zeros(3, 3, 1, 1, dtype=torch.int32)
        with pytest.raises(ValueError):
            tref.conv2d(x, w, fuse_relu=True, epilogue="squared_relu")
        with pytest.raises(ValueError):
            tref.conv2d(x, w, epilogue="gelu")


class TestPrimitives:
    @pytest.mark.parametrize("kind", ["relu", "squared_relu", "identity", "exp"])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_unary(self, kind, dtype):
        rng = np.random.default_rng(3)
        if dtype == np.int32:
            # squares of these wrap mod 2**32
            x = rng.integers(-70000, 70000, size=(3, 5, 7)).astype(dtype)
            if kind == "exp":
                x = x % 9 - 4
        else:
            x = rng.standard_normal((3, 5, 7)).astype(dtype)
        got, want = tref.unary(kind, _t(x)), jref.unary(kind, jnp.asarray(x))
        if kind == "exp":
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
        else:
            _eq(got, want)

    @pytest.mark.parametrize("kind", ["add", "mul", "max"])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_binary(self, kind, dtype):
        rng = np.random.default_rng(4)
        if dtype == np.int32:
            a = rng.integers(-2**31, 2**31 - 1, size=(2, 4, 6)).astype(dtype)
            b = rng.integers(-2**31, 2**31 - 1, size=(2, 4, 6)).astype(dtype)
        else:
            a = rng.standard_normal((2, 4, 6)).astype(dtype)
            b = rng.standard_normal((2, 4, 6)).astype(dtype)
        _eq(tref.binary(kind, _t(a), _t(b)),
            jref.binary(kind, jnp.asarray(a), jnp.asarray(b)))

    def test_binary_broadcasts_rank1_bias_over_a_batched_value(self):
        rng = np.random.default_rng(5)
        v = rng.integers(-9, 9, size=(5, 1, 4, 4, 6)).astype(np.int32)
        bias = rng.integers(-9, 9, size=(6,)).astype(np.int32)
        got = tref.binary("add", _t(v), _t(bias)).numpy()
        for i in range(5):
            np.testing.assert_array_equal(
                got[i], np.asarray(jref.binary("add", jnp.asarray(v[i]),
                                               jnp.asarray(bias))))

    def test_unknown_kinds_raise(self):
        x = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(NotImplementedError):
            tref.unary("tanh", x)
        with pytest.raises(NotImplementedError):
            tref.binary("sub", x, x)
        with pytest.raises(NotImplementedError):
            tref.pool_reduce("min", x, (2,))

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
    def test_div_exact_floors_negative_sums(self, n):
        x = np.arange(-20, 21, dtype=np.int32)
        _eq(tref._div_exact(_t(x), n), jref._div_exact(jnp.asarray(x), n))
        if n > 1:  # floor, not truncation
            assert int(tref._div_exact(_t(np.array([-1], np.int32)), n)) == -1
        xf = x.astype(np.float32)
        np.testing.assert_allclose(
            tref._div_exact(_t(xf), n).numpy(),
            np.asarray(jref._div_exact(jnp.asarray(xf), n)), rtol=1e-6)

    @pytest.mark.parametrize("kind", ["max", "add", "avg"])
    @pytest.mark.parametrize("window", [(1, 2, 2, 1), (1, 4, 1, 1),
                                        (1, 2, 4, 2), (1, 1, 1, 1)])
    def test_pool_reduce(self, kind, window):
        rng = np.random.default_rng(6)
        x = rng.integers(-50, 20, size=(1, 8, 8, 4)).astype(np.int32)
        _eq(tref.pool_reduce(kind, _t(x), window),
            jref.pool_reduce(kind, jnp.asarray(x), window))
        xf = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
        np.testing.assert_allclose(
            tref.pool_reduce(kind, _t(xf), window).numpy(),
            np.asarray(jref.pool_reduce(kind, jnp.asarray(xf), window)),
            rtol=1e-5, atol=1e-6)

    def test_pool_reduce_passes_leading_batch_axes_through(self):
        rng = np.random.default_rng(7)
        x = rng.integers(-50, 20, size=(3, 1, 8, 8, 4)).astype(np.int32)
        got = tref.pool_reduce("avg", _t(x), (1, 2, 2, 1)).numpy()
        for i in range(3):
            np.testing.assert_array_equal(got[i], np.asarray(
                jref.pool_reduce("avg", jnp.asarray(x[i]), (1, 2, 2, 1))))

    @pytest.mark.parametrize("khs", [(2, 2, 2), (3, 2, 1)])
    def test_avgpool_int8_accumulates_in_int32(self, khs):
        kh, kw, s = khs
        x = np.random.default_rng(8).integers(
            -128, 127, size=(2, 9, 10, 3)).astype(np.int8)
        got = tref.avgpool2d(_t(x), kh, kw, s)
        assert got.dtype == torch.int32
        _eq(got, jref.avgpool2d(jnp.asarray(x), kh, kw, s))
        assert tref.maxpool2d(_t(x), kh, kw, s).dtype == torch.int8

    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    @pytest.mark.parametrize("khs", [(2, 2, 2), (3, 3, 1), (3, 2, 2), (4, 4, 4)])
    def test_standalone_pools(self, dtype, khs):
        kh, kw, s = khs
        rng = np.random.default_rng(8)
        if dtype == np.float32:
            x = rng.standard_normal((2, 9, 10, 3)).astype(dtype)
        else:
            x = rng.integers(-100, 30, size=(2, 9, 10, 3)).astype(dtype)
        _eq(tref.maxpool2d(_t(x), kh, kw, s),
            jref.maxpool2d(jnp.asarray(x), kh, kw, s))
        got = tref.avgpool2d(_t(x), kh, kw, s)
        want = jref.avgpool2d(jnp.asarray(x), kh, kw, s)
        if dtype == np.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        else:
            _eq(got, want)  # int32 sums, floor division

    def test_apply_epilogue_chain(self):
        _, art = compiled_pair("conv_avgpool_32", "kv260")
        jart, _ = compiled_pair("conv_avgpool_32", "kv260")
        op = next(o for o in art.source.topo_order() if o.epilogue)
        jop = next(o for o in jart.source.topo_order() if o.epilogue)
        rng = np.random.default_rng(9)
        x = rng.integers(-40, 40, size=(1, 32, 32, 16)).astype(np.int32)
        _eq(tref.apply_epilogue(_t(x), op.epilogue, {}),
            jref.apply_epilogue(jnp.asarray(x), jop.epilogue, {}))


INT_GRAPHS = ["conv_relu_32", "cascade_conv_32", "residual_block_32",
              "feed_forward", "conv_pool_32", "conv_avgpool_32",
              "lenet5", "tiny_vgg_32", "edge_residual_32", "resnet_mini_16"]


class TestInterpreter:
    @pytest.mark.parametrize("name", INT_GRAPHS)
    def test_execute_dfg_integer_bit_exact(self, name):
        """Every value of the environment, not only the outputs — on the
        unfused source graph, so each node kind runs on its own."""
        jd, td = japi.suite()[name](), tapi.suite()[name]()
        inputs, params = int_env(jd, seed=10)
        env = {**inputs, **params}
        jenv = jinterp.execute_dfg(jd, {k: jnp.asarray(v) for k, v in env.items()})
        tenv = tinterp.execute_dfg(td, env, device="cpu")
        assert set(jenv) == set(tenv)
        for k in jenv:
            _eq(tenv[k], jenv[k])

    @pytest.mark.parametrize("name", ["lenet5", "resnet_mini_16",
                                      "conv_avgpool_32"])
    def test_compiled_source_matches_too(self, name):
        ja, ta = compiled_pair(name, "kv260")
        inputs, params = int_env(ja.source, seed=11)
        env = {**inputs, **params}
        jout = jinterp.graph_outputs(
            ja.source, {k: jnp.asarray(v) for k, v in env.items()})
        tout = tinterp.graph_outputs(ta.source, env, device="cpu")
        for k in jout:
            _eq(tout[k], jout[k])

    @pytest.mark.parametrize("name", ["cascade_conv_32", "edge_residual_32",
                                      "feed_forward"])
    def test_float_env_close(self, name):
        jd, td = japi.suite()[name](), tapi.suite()[name]()
        rng = np.random.default_rng(12)
        env = {n: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
               for n, v in jd.values.items()
               if v.is_constant or n in jd.graph_inputs}
        jout = jinterp.graph_outputs(
            jd, {k: jnp.asarray(v) for k, v in env.items()})
        tout = tinterp.graph_outputs(td, env, device="cpu")
        for k in jout:
            assert tout[k].dtype == torch.float32
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       **F32)

    @pytest.mark.parametrize("perm", [(0, 3, 1, 2), (0, 2, 3, 1), (0, 2, 1, 3)])
    def test_execute_reorder_transpose(self, perm):
        import repro.api.builder as jb
        import repro_torch.api.builder as tb

        def build(b):
            return b.Sequential([b.Transpose(perm), b.ReLU()],
                                input_shape=(1, 4, 6, 3), name="tr").build()

        jd, td = build(jb), build(tb)
        x = np.random.default_rng(13).integers(-9, 9, size=(1, 4, 6, 3)).astype(np.int32)
        jop = jd.topo_order()[0]
        top = td.topo_order()[0]
        _eq(tinterp.execute_reorder(top, _t(x)),
            jinterp.execute_reorder(jop, jnp.asarray(x)))

    @pytest.mark.parametrize("order", [None, (3, 1, 2), (2, 1, 3)])
    def test_execute_reorder_flatten(self, order):
        import repro.api.builder as jb
        import repro_torch.api.builder as tb
        from repro_torch.kernels import ops as tops

        def build(b):
            return b.Sequential([b.Flatten(order), b.Dense(5)],
                                input_shape=(1, 4, 6, 3), name="fl").build()

        jd, td = build(jb), build(tb)
        x = np.random.default_rng(14).integers(-9, 9, size=(1, 4, 6, 3)).astype(np.int32)
        jop, top = jd.topo_order()[0], td.topo_order()[0]
        want = jinterp.execute_reorder(jop, jnp.asarray(x))
        _eq(tinterp.execute_reorder(top, _t(x)), want)
        # the batched twin of the device lowering shifts every axis by one
        xb = np.stack([x, x + 1, x - 3])
        got = tops.execute_reorder_batched(top, _t(xb)).numpy()
        for i in range(3):
            np.testing.assert_array_equal(got[i], np.asarray(
                jinterp.execute_reorder(jop, jnp.asarray(xb[i]))))

    def test_random_env_same_distribution_and_seeded(self):
        ja, ta = compiled_pair("lenet5", "kv260")
        a = tinterp.random_env(ta.source, seed=3, device="cpu")
        b = tinterp.random_env(ta.source, seed=3, device="cpu")
        c = tinterp.random_env(ta.source, seed=4, device="cpu")
        j = jinterp.random_env(ja.source, seed=3)
        assert set(a) == set(j)
        for k in a:
            assert a[k].dtype == torch.int32
            assert tuple(a[k].shape) == tuple(j[k].shape)
            assert int(a[k].min()) >= -4 and int(a[k].max()) <= 4
            assert torch.equal(a[k], b[k])
        assert any(not torch.equal(a[k], c[k]) for k in a)
        big = torch.cat([v.flatten() for v in a.values()])
        assert sorted(big.unique().tolist()) == list(range(-4, 5))
