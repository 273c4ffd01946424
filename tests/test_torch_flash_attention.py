"""The module that holds the flash-attention kernel.  On the CPU the
port's ``ops.flash_attention`` takes the kernel's plain version; it is
held here against the reference's ``ops.flash_attention`` (the Pallas
kernel in interpret mode) on the same NumPy inputs, at the shapes of
``tests/test_kernels.py`` and more: a GQA group of 7, a query offset
with Sq < Sk, ragged lengths, other block choices.  Tolerances are the
reference's own: f32 atol = rtol = 2e-5, bf16 3e-2 (the sums run in
another order).  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and by the ``cuda``-marked test
below."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.configs import registry as treg
from repro_torch.core import dse
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _both(q, k, v, dtype="float32", **kw):
    """(port, reference) outputs as f32 NumPy arrays."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == q.shape
    want = jops.flash_attention(*(jnp.asarray(a).astype(dtype)
                                  for a in (q, k, v)), interpret=True, **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_gqa_causal(causal, group):
    q, k, v = _qkv(0, 2, 2 * group, 2, 32, 32, 16)
    got, want = _both(q, k, v, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("sq,sk,bq,bk", [
    (16, 16, 16, 16), (64, 64, 16, 32), (32, 64, 32, 16), (128, 128, 64, 64),
])
def test_block_shapes(sq, sk, bq, bk):
    q, k, v = _qkv(1, 1, 4, 4, sq, sk, 32)
    got, want = _both(q, k, v, causal=False, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("sq,sk,q_offset,bq,bk", [
    (8, 32, 24, 8, 16),      # decode-style: the new rows see the prefix
    (8, 32, 10, 8, 32),      # offset inside the keys: some keys hidden
    (16, 96, 80, 16, 32),    # GQA group 7 below
])
def test_q_offset(sq, sk, q_offset, bq, bk):
    hq, hkv = (14, 2) if sk == 96 else (2, 2)
    q, k, v = _qkv(2, 1, hq, hkv, sq, sk, 16)
    got, want = _both(q, k, v, causal=True, q_offset=q_offset,
                      block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16(causal):
    q, k, v = _qkv(3, 1, 2, 2, 32, 32, 32)
    got, want = _both(q, k, v, "bfloat16", causal=causal, block_q=16,
                      block_k=16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("d", [8, 40, 64, 96, 128])
def test_head_dims_and_default_blocks(d):
    """Heads up to the kernel's 128, blocks left to the planner."""
    q, k, v = _qkv(4, 2, 4, 2, 24, 24, d)
    got, want = _both(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("blocks", [(None, None), (10, 20), (50, 100),
                                    (100, 25)])
def test_blocks_change_nothing(blocks):
    """Ragged lengths (100, not a tile multiple) and other blocks: the
    port's result does not depend on the caller's blocks."""
    q, k, v = _qkv(5, 1, 6, 3, 100, 100, 16)
    bq, bk = blocks
    got, want = _both(q, k, v, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, **F32_TOL)
    base = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_array_equal(got, base.numpy())


def test_row_with_no_visible_key_is_zero():
    """A negative offset hides every key from the first rows: the kernel's
    masking gives 0 there (the oracle's -inf masking gives NaN)."""
    q, k, v = _qkv(6, 1, 2, 1, 8, 8, 16)
    got, want = _both(q, k, v, causal=True, q_offset=-3, block_q=8,
                      block_k=8)
    np.testing.assert_array_equal(got[:, :, :3], 0.0)
    np.testing.assert_array_equal(want[:, :, :3], 0.0)
    np.testing.assert_allclose(got, want, **F32_TOL)
    oracle = tref.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, q_offset=-3)
    assert torch.isnan(oracle[:, :, :3]).all()
    assert not torch.isnan(oracle[:, :, 3:]).any()


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 5)])
def test_ref_attention_matches_reference_oracle(causal, q_offset):
    q, k, v = _qkv(7, 2, 4, 2, 12, 17, 16)
    got = tref.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal, q_offset=q_offset)
    want = jref.attention(*(jnp.asarray(a) for a in (q, k, v)),
                          causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_plain_version_agrees_with_the_oracle_where_rows_see_keys():
    q, k, v = _qkv(8, 2, 4, 2, 16, 16, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale = 32 ** -0.5
    plain = tfa.flash_attention_plain(
        (tq * scale).reshape(8, 16, 32), tk.reshape(4, 16, 32),
        tv.reshape(4, 16, 32), heads_q=4, heads_kv=2)
    oracle = tref.attention(tq, tk, tv)
    np.testing.assert_allclose(plain.reshape(2, 4, 16, 32).numpy(),
                               oracle.numpy(), **F32_TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 16)
    kv = torch.zeros(1, 4, 16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), kv.double(), kv.double(),
                            heads_q=2, heads_kv=1)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, kv.bfloat16(), kv, heads_q=2, heads_kv=1)
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention(q, kv, kv, heads_q=2, heads_kv=3)
    with pytest.raises(ValueError, match="do not fit"):
        tfa.flash_attention(q, torch.zeros(2, 4, 16), kv, heads_q=2,
                            heads_kv=1)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(torch.zeros(2, 4, 256), torch.zeros(1, 4, 256),
                            torch.zeros(1, 4, 256), heads_q=2, heads_kv=1)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], kv, kv, heads_q=2, heads_kv=1)


@pytest.mark.parametrize("kw,shapes", [
    (dict(block_q=16, block_k=16), ((1, 2, 24, 16), (1, 2, 32, 16))),
    (dict(block_q=8, block_k=12), ((1, 2, 24, 16), (1, 2, 32, 16))),
    (dict(), ((1, 3, 8, 16), (1, 2, 8, 16))),
])
def test_same_inputs_raise_as_in_the_reference(kw, shapes):
    """Blocks that do not divide the lengths, heads that are not a whole
    group: the reference asserts, the port raises ValueError."""
    (qs, ks) = shapes
    rng = np.random.default_rng(9)
    q = rng.standard_normal(qs).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    with pytest.raises(AssertionError):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                             interpret=True, **kw)
    with pytest.raises(ValueError):
        tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), **kw)


def test_cpu_call_never_builds_or_loads_the_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path reached for the CUDA library")

    monkeypatch.setattr(tfa.LIBRARY, "load", boom)
    monkeypatch.setattr(tfa.LIBRARY, "build", boom)
    monkeypatch.setattr(build, "build_libraries", boom)
    monkeypatch.setattr(build.subprocess, "Popen", boom)
    before = (tfa.launches, tfa.plain_cuda_calls)
    q, k, v = _qkv(10, 1, 4, 2, 16, 16, 16)
    out = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (1, 4, 16, 16)
    assert (tfa.launches, tfa.plain_cuda_calls) == before


#: every config with attention: (arch, query heads, head_dim)
_ATTN_HEADS = [(a, c.num_heads, c.resolved_head_dim)
               for a in treg.all_archs()
               for c in [treg.get_config(a)] if c.num_heads]


class TestPlanner:
    """The tiles of both routes: every attention of the ten configs gets
    a plan that covers Sq, fits the H100's shared memory and the
    registers the kernel assumes."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("seq", [1, 100, 1024, 4096])
    @pytest.mark.parametrize("arch,heads,d", _ATTN_HEADS)
    def test_every_config_gets_a_plan(self, arch, heads, d, seq, dtype):
        plan = dse.plan_attention_blocks(seq_q=seq, seq_k=seq, head_dim=d,
                                         batch_heads=4 * heads, dtype=dtype)
        b = plan.blocks
        assert plan.grid == 4 * heads * -(-seq // b["block_q"])
        assert b["block_k"] == dse.ATTN_BLOCK_K
        assert plan.smem_bytes <= dse.H100.smem_per_block
        assert plan.acc_regs <= dse.ATTN_ACC_REGS
        if dtype == "bfloat16":
            assert plan.kind == "attention_mma"
            assert b["block_q"] == dse.ATTN_MMA_BLOCK_Q
            assert b["head_pad"] % 16 == 0 and b["head_pad"] >= d
        else:
            assert plan.kind == "attention" and b["head_pad"] == d
            assert b["block_q"] in dse.ATTN_BLOCK_Q

    def test_f32_tiles(self):
        # the model shapes take the large tile; small grids and short
        # queries the small one
        for d, bh in ((64, 128), (64, 56), (128, 128)):
            plan = dse.plan_attention_blocks(seq_q=1024, seq_k=1024,
                                             head_dim=d, batch_heads=bh,
                                             dtype="float32")
            assert plan.blocks["block_q"] == 64 and plan.grid == bh * 16
        assert dse.plan_attention_blocks(
            seq_q=100, seq_k=100, head_dim=128, batch_heads=4,
            dtype="float32").blocks["block_q"] == 32
        assert dse.plan_attention_blocks(
            seq_q=1, seq_k=1, head_dim=64, batch_heads=1024,
            dtype="float32").blocks["block_q"] == 32

    def test_smem_formulas(self):
        # f32: qT + kT (D x 68) + vs (64 x 64) + ps (64 x 68)
        assert dse.attention_smem_bytes(head_dim=64, block_q=64) == 4 * (
            64 * 68 + 64 * 68 + 64 * 64 + 64 * 68)
        assert dse.attention_smem_bytes(head_dim=16, block_q=32) == 4 * (
            16 * 36 + 16 * 68 + 64 * 32 + 32 * 68)
        # bf16: the query tile and two stages of K and V, rows of the
        # padded head + 8
        assert dse.attention_mma_smem_bytes(head_dim=64) == 2 * (
            64 + 4 * 64) * 72
        assert dse.attention_mma_smem_bytes(head_dim=40) == 2 * (
            64 + 4 * 64) * 72
        assert dse.attention_mma_smem_bytes(head_dim=8) == 2 * (
            64 + 4 * 64) * 24

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_raises_beyond_the_widest_head(self, dtype):
        with pytest.raises(ValueError, match="head_dim"):
            dse.plan_attention_blocks(seq_q=8, seq_k=8, head_dim=129,
                                      dtype=dtype)
        with pytest.raises(ValueError, match="empty"):
            dse.plan_attention_blocks(seq_q=0, seq_k=8, head_dim=64,
                                      dtype=dtype)
        for d in (1, 40, 64, dse.ATTN_MAX_HEAD_DIM):
            plan = dse.plan_attention_blocks(seq_q=4096, seq_k=4096,
                                             head_dim=d, batch_heads=1024,
                                             dtype=dtype)
            assert plan.smem_bytes <= dse.H100.smem_per_block


def _attention_p_in_bf16(q, k, v, *, heads_q, heads_kv, causal=True,
                         q_offset=0, block_k=64):
    """The bf16 kernel's arithmetic, written out: key tiles of
    ``block_k``, the online softmax in f32, P rounded to bf16 for P·V
    while l sums the f32 p."""
    bhq, sq, d = q.shape
    b, g = bhq // heads_q, heads_q // heads_kv
    qf = q.float().reshape(b, heads_kv, g, sq, d)
    kf = k.float().reshape(b, heads_kv, -1, d)
    vf = v.float().reshape(b, heads_kv, -1, d)
    sk = kf.shape[2]
    m = torch.full((b, heads_kv, g, sq, 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, heads_kv, g, sq, d)
    qpos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, sk, block_k):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k0 + block_k])
        vis = torch.ones(sq, s.shape[-1], dtype=torch.bool)
        if causal:
            vis = qpos >= torch.arange(k0, k0 + s.shape[-1])[None, :]
        s = torch.where(vis, s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + block_k])
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)
    return out.reshape(bhq, sq, d).to(q.dtype)


def test_rounding_p_to_bf16_meets_the_tolerance():
    """The bf16 kernel rounds P to bf16 for P·V (FA2's choice; the Pallas
    kernel keeps P in f32).  Done here by hand at llama3.2-1b's heads on a
    short prefill, on numpy-seeded bf16 inputs, it stays within
    ``chip_smoke.ATTN_TOL`` of ``ref.attention``."""
    import chip_smoke

    tol = chip_smoke.ATTN_TOL["bfloat16"]
    cfg = treg.get_config("llama3.2-1b")
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(12, 2, hq, hkv, 200, 200, d)
    bf = torch.bfloat16
    qs = tops.scale_in_dtype(torch.from_numpy(q).to(bf), d ** -0.5)
    got = _attention_p_in_bf16(
        qs.reshape(2 * hq, 200, d),
        *(torch.from_numpy(a).to(bf).reshape(2 * hkv, 200, d)
          for a in (k, v)), heads_q=hq, heads_kv=hkv)
    want = jref.attention(*(jnp.asarray(a).astype("bfloat16")
                            for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy().reshape(q.shape),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the full sweep is
    ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2 * 14, 100, 64, generator=g).to(tdt).cuda()
    k = torch.randn(2 * 2, 130, 64, generator=g).to(tdt).cuda()
    v = torch.randn(2 * 2, 130, 64, generator=g).to(tdt).cuda()
    got = tfa.flash_attention(q, k, v, heads_q=14, heads_kv=2, q_offset=30)
    want = tfa.flash_attention_plain(q, k, v, heads_q=14, heads_kv=2,
                                     q_offset=30)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
