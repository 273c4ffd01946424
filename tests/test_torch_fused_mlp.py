"""The module that holds the fused-MLP kernel.  On the CPU the port's
``ops.fused_mlp`` takes the kernel's plain version; it is held here
against the reference's ``ops.fused_mlp`` (the Pallas kernel in
interpret mode) and its oracle ``ref.mlp`` on the same NumPy inputs, at
the cases of ``tests/test_kernels.py:147-187`` — the four activations
gated and ungated, the three tilings, leading dims — at the reference's
tolerance (atol = rtol = 5e-4, sums in another order), plus bf16 (1e-2:
both round an f32 result to bf16, one step is 2^-8 relative).  The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import dse
from repro_torch.kernels import build
from repro_torch.kernels import fused_mlp as tfm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)

F32_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
ACTS = ["silu", "gelu", "relu", "squared_relu"]


def _inputs(seed, m, d, f, gated=True, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead or (m, d)).astype(np.float32)
    wg = (rng.standard_normal((d, f)) * 0.1).astype(np.float32) if gated \
        else None
    wu = (rng.standard_normal((d, f)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((f, d)) * 0.1).astype(np.float32)
    return x, wg, wu, wd


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype="float32"):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gated", [True, False])
def test_acts_gating(act, gated):
    x, wg, wu, wd = _inputs(0, 32, 64, 128, gated)
    got = tops.fused_mlp(_t(x), _t(wg), _t(wu), _t(wd), act=act,
                         block_m=16, block_f=32)
    want = jops.fused_mlp(_j(x), _j(wg), _j(wu), _j(wd), act=act,
                          block_m=16, block_f=32, interpret=True)
    oracle = jref.mlp(_j(x), _j(wg), _j(wu), _j(wd), act=act)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), **F32_TOL)
    np.testing.assert_allclose(
        _np(tref.mlp(_t(x), _t(wg), _t(wu), _t(wd), act=act)), _np(oracle),
        **F32_TOL)


@pytest.mark.parametrize("m,f,bm,bf", [
    (8, 32, 8, 32), (64, 256, 16, 64), (128, 512, 128, 128),
])
def test_tilings(m, f, bm, bf):
    x, wg, wu, wd = _inputs(1, m, 32, f)
    got = tops.fused_mlp(_t(x), _t(wg), _t(wu), _t(wd), block_m=bm,
                         block_f=bf)
    want = jops.fused_mlp(_j(x), _j(wg), _j(wu), _j(wd), block_m=bm,
                          block_f=bf, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(got), _np(jref.mlp(_j(x), _j(wg), _j(wu), _j(wd))), **F32_TOL)


def test_leading_dims():
    x, wg, wu, wd = _inputs(2, 16, 32, 64, lead=(2, 8, 32))
    got = tops.fused_mlp(_t(x), _t(wg), _t(wu), _t(wd), block_m=8,
                         block_f=32)
    assert got.shape == x.shape
    want = jops.fused_mlp(_j(x), _j(wg), _j(wu), _j(wd), block_m=8,
                          block_f=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    exp = jref.mlp(_j(x).reshape(16, 32), _j(wg), _j(wu), _j(wd))
    np.testing.assert_allclose(_np(got), _np(exp).reshape(2, 8, 32),
                               **F32_TOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gated", [True, False])
def test_bfloat16(act, gated):
    x, wg, wu, wd = _inputs(3, 32, 64, 128, gated)
    bf = torch.bfloat16
    got = tops.fused_mlp(_t(x, bf), _t(wg, bf), _t(wu, bf), _t(wd, bf),
                         act=act)
    want = jops.fused_mlp(_j(x, "bfloat16"), _j(wg, "bfloat16"),
                          _j(wu, "bfloat16"), _j(wd, "bfloat16"), act=act,
                          interpret=True)
    assert got.dtype == bf
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_default_blocks_take_any_shape():
    """``None`` checks nothing: a prime M and an F of no power of two run."""
    x, wg, wu, wd = _inputs(4, 7, 24, 100)
    got = tops.fused_mlp(_t(x), _t(wg), _t(wu), _t(wd))
    want = jops.fused_mlp(_j(x), _j(wg), _j(wu), _j(wd), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("kw", [dict(block_m=5), dict(block_f=48)])
def test_same_blocks_raise_as_in_the_reference(kw):
    x, wg, wu, wd = _inputs(5, 16, 32, 64)
    with pytest.raises(AssertionError):
        jops.fused_mlp(_j(x), _j(wg), _j(wu), _j(wd), interpret=True,
                       **dict(dict(block_m=16, block_f=32), **kw))
    with pytest.raises(ValueError, match="block_"):
        tops.fused_mlp(_t(x), _t(wg), _t(wu), _t(wd), **kw)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wg, wu, wd = (_t(a) for a in _inputs(6, 4, 32, 64))
    with pytest.raises(ValueError, match="activation"):
        tfm.fused_mlp(x, wg, wu, wd, act="tanh")
    with pytest.raises(TypeError):
        tfm.fused_mlp(x.double(), wg.double(), wu.double(), wd.double())
    with pytest.raises(TypeError):
        tfm.fused_mlp(x, wg.to(torch.bfloat16), wu, wd)
    with pytest.raises(ValueError, match="do not fit"):
        tfm.fused_mlp(x, wg, wu, wd[:32])
    with pytest.raises(ValueError, match="empty"):
        tfm.fused_mlp(x[:0], wg, wu, wd)
    wide = torch.zeros(1, dse.MLP_MAX_D + 1)
    w = torch.zeros(dse.MLP_MAX_D + 1, 8)
    with pytest.raises(ValueError, match="limit"):
        tfm.fused_mlp(wide, None, w, w.T)


def test_cpu_call_never_builds_or_loads_the_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path reached for the CUDA library")

    monkeypatch.setattr(tfm.LIBRARY, "load", boom)
    monkeypatch.setattr(build, "build_libraries", boom)
    monkeypatch.setattr(build.subprocess, "Popen", boom)
    before = (tfm.launches, tfm.plain_cuda_calls)
    x, wg, wu, wd = (_t(a) for a in _inputs(7, 4, 32, 64))
    assert tfm.fused_mlp(x, wg, wu, wd).shape == (4, 32)
    assert (tfm.launches, tfm.plain_cuda_calls) == before


def test_streamed_lm_matches_the_reference(monkeypatch):
    """llama3.2-1b's smoke config with ``mlp_impl="streamed"``: prefill and
    two decode steps against the reference's streamed LM (unsharded, its
    attention the Pallas kernel in interpret mode), one fused-MLP call per
    layer and step."""
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    from repro_torch.configs import registry as treg
    from repro_torch.models import lm as tlm

    jcfg = jreg.get_config("llama3.2-1b", smoke=True).with_(
        dtype="float32", attn_impl="pallas", mlp_impl="streamed")
    tcfg = treg.get_config("llama3.2-1b", smoke=True).with_(
        dtype="float32", mlp_impl="streamed")
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    calls = []
    real = tfm.fused_mlp
    monkeypatch.setattr(tfm, "fused_mlp",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a,
                                                                         **k))
    toks = np.random.default_rng(9).integers(0, 256, (2, 16), dtype=np.int32)
    jl, jc = jlm.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    assert calls == [(32, 64)] * tcfg.num_layers
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, 2), (0, 0)]), jc)
    tcache = tlm.init_cache(tcfg, 2, 18, device="cpu")
    for kv in ("k", "v"):
        tcache["b0"][kv][:, :, :, :16] = tc["b0"][kv]
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(2):
        calls.clear()
        jl, jcache = jlm.lm_decode(jp, jcfg, jcache, jnp.asarray(tok),
                                   jnp.asarray(16 + i, jnp.int32))
        tl, _ = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(tok), 16 + i)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
        assert calls == [(2, 64)] * tcfg.num_layers
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


class TestPlanner:
    def test_model_shapes(self):
        pre = dse.plan_mlp_blocks(m=4096, d=2048, f=8192)
        assert pre.blocks["rows"] == 8 and pre.blocks["cols"] == 8
        assert pre.blocks["splits"] == 1 and pre.grid == 512
        dec = dse.plan_mlp_blocks(m=4, d=2048, f=8192)
        # decode splits F until the grid covers the card
        assert dec.blocks["splits"] == 128 and dec.grid == 128
        assert dse.plan_mlp_blocks(m=1, d=8192, f=29568).blocks["cols"] == 32

    @pytest.mark.parametrize("m,d,f", [(1, 64, 64), (4, 896, 4864),
                                       (100, 4096, 11008), (37, 200, 1000),
                                       (4096, 896, 4864)])
    def test_splits_cover_f_and_none_is_empty(self, m, d, f):
        b = dse.plan_mlp_blocks(m=m, d=d, f=f).blocks
        tiles = -(-f // b["block_f"])
        assert b["splits"] * b["tiles_per_split"] >= tiles
        assert (b["splits"] - 1) * b["tiles_per_split"] < tiles
        assert 256 * b["cols"] >= d and b["rows"] * b["cols"] <= 64

    def test_smem_formula_and_limit(self):
        p = dse.plan_mlp_blocks(m=4096, d=2048, f=8192)
        assert p.smem_bytes == 4 * (2048 * 8 + 2 * 4 * 64 * 8 + 64 * 8)
        assert p.smem_bytes <= dse.H100.smem_per_block
        with pytest.raises(ValueError, match="limit"):
            dse.plan_mlp_blocks(m=1, d=dse.MLP_MAX_D + 1, f=64)
        with pytest.raises(ValueError, match="empty"):
            dse.plan_mlp_blocks(m=0, d=64, f=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the sweep is ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tdt = getattr(torch, dtype)
    x, wg, wu, wd = (_t(a, tdt).cuda() for a in _inputs(8, 37, 896, 1000))
    got = tfm.fused_mlp(x, wg, wu, wd, act="gelu")
    exp = tfm.fused_mlp_plain(x, wg, wu, wd, act="gelu")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), exp.float(), **tol)
