"""The attention gradient of the port held against the reference's on
the CPU: ``jax.grad`` through ``repro.models.layers.blockwise_attention``
(its streaming custom VJP, ``layers.py:209-275``) against autograd
through the port's ``"blockwise"`` (its ``torch.autograd.Function``, or
plain autograd through the block loop with ``streaming_bwd=False``) and
``"cuda"`` (``FlashAttention``: on a CPU tensor the forward and backward
kernels' plain versions).  Shapes are ``tests/test_layers.py``'s (B 2, 8
query heads over 2 KV heads, S 64, D 16, blocks of 16) and its tolerance,
atol = rtol = 2e-4.

The reference comparisons use ``q_offset = 0``, causal or not, where
every query row sees at least one key.  A row that sees no key (a
negative offset) is where the two conventions part: ``blockwise`` — the
reference's — gives it the mean of v and a gradient of its own, the
kernel gives it 0 and no gradient; that convention is pinned on the port
alone below.  The CUDA kernel itself is held against its plain version
by the ``cuda``-marked test here and by ``chip_smoke.py``'s
``attn_bwd_check``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as JL

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL

from _torch_port import to_np  # noqa: F401  (sets torch threads)

TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, b=2, hq=8, hkv=2, sq=64, sk=64, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _ref_grads(q, k, v, causal, dtype="float32", streaming=True):
    def loss(q, k, v):
        o = JL.blockwise_attention(q, k, v, causal=causal, block_q=16,
                                   block_k=16, streaming_bwd=streaming)
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(fn, q, k, v, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (q, k, v)]
    out = fn(*ts)
    assert out.dtype == dtype
    grads = torch.autograd.grad(torch.sin(out.float()).sum(), ts)
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


PORT_IMPLS = {
    "blockwise": lambda causal: lambda q, k, v: TL.blockwise_attention(
        q, k, v, causal=causal, block_q=16, block_k=16),
    "blockwise-autograd": lambda causal: lambda q, k, v:
        TL.blockwise_attention(q, k, v, causal=causal, block_q=16,
                               block_k=16, streaming_bwd=False),
    "cuda": lambda causal: lambda q, k, v: TL.attention_cuda(
        q, k, v, causal=causal, block_q=16, block_k=16),
}


@pytest.mark.parametrize("impl", list(PORT_IMPLS))
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_the_reference_streaming_vjp(impl, causal):
    q, k, v = _qkv(4)
    want = _ref_grads(q, k, v, causal)
    got = _port_grads(PORT_IMPLS[impl](causal), q, k, v)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["blockwise", "cuda"])
def test_grads_match_the_reference_in_bf16(impl):
    """bf16 inputs, f32 arithmetic inside, grads rounded to bf16 in both
    packages: the reference's bf16 tolerance (``test_models.py``)."""
    q, k, v = _qkv(5, sq=32, sk=32)
    want = _ref_grads(q, k, v, True, "bfloat16")
    got = _port_grads(PORT_IMPLS[impl](True), q, k, v, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **BF16_TOL, err_msg=f"d{name}")


def test_the_reference_keeps_both_of_its_vjps_equal():
    """The reference's own before/after pair, streaming against the
    default scan VJP, agrees with the port's grads at the same tolerance."""
    q, k, v = _qkv(6)
    a = _ref_grads(q, k, v, True, streaming=True)
    b = _ref_grads(q, k, v, True, streaming=False)
    got = _port_grads(PORT_IMPLS["cuda"](True), q, k, v)
    for x, y, g in zip(a, b, got):
        np.testing.assert_allclose(x, y, **TOL)
        np.testing.assert_allclose(g, y, **TOL)


def test_forward_lse_matches_the_reference():
    """The forward kernel's lse (plain version) against the reference's
    ``_blockwise_attention_fwd`` residual, per query row."""
    q, k, v = _qkv(7)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    _, res = JL._blockwise_attention_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), True, 0, 16, 16)
    want = np.asarray(res[4]).reshape(b, hq, s)
    qs = tops.scale_in_dtype(torch.from_numpy(q), d ** -0.5)
    _, lse = tfa.flash_attention(
        qs.reshape(b * hq, s, d), torch.from_numpy(k).reshape(b * hkv, s, d),
        torch.from_numpy(v).reshape(b * hkv, s, d), heads_q=hq,
        heads_kv=hkv, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b * hq, s)
    np.testing.assert_allclose(lse.reshape(b, hq, s).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    _, lse_bw = TL._blockwise_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), True, 0, 16, 16)
    np.testing.assert_allclose(lse_bw.reshape(b, hq, s).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sq,sk,hq,hkv,causal,q_offset,block", [
    (37, 37, 4, 2, True, 0, 8),      # ragged blocks
    (20, 33, 6, 2, True, 13, 8),     # a query offset, Sq < Sk
    (20, 33, 4, 1, False, 0, 16),    # non-causal, GQA group 4
    (64, 64, 8, 2, True, 0, 512),    # one block
    (16, 48, 8, 8, True, 32, 16),    # group 1, decode-like offset
])
def test_plain_backward_equals_autograd_of_the_dense_forward(
        sq, sk, hq, hkv, causal, q_offset, block):
    """``flash_attention_bwd_plain`` (the kernel's plain version) against
    autograd through the dense plain forward, at lengths, offsets and
    groups the reference comparisons above do not reach."""
    rng = np.random.default_rng(sq + sk)
    b, d = 2, 8
    q = torch.from_numpy(rng.standard_normal((b * hq, sq, d)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((b * hkv, sk, d)).astype(
        np.float32)).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((b * hkv, sk, d)).astype(
        np.float32)).requires_grad_(True)
    kw = dict(heads_q=hq, heads_kv=hkv, causal=causal, q_offset=q_offset)
    out = tfa.flash_attention_plain(q * 0.3, k, v, **kw)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    want = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        o2, lse = tfa.flash_attention(q * 0.3, k, v, return_lse=True, **kw)
        got = tfa.flash_attention_bwd_plain(q * 0.3, k, v, o2, lse, dout,
                                            scale=0.3, block=block, **kw)
        again = tfa.flash_attention_bwd(q * 0.3, k, v, o2, lse, dout,
                                        scale=0.3, **kw)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_a_row_that_sees_no_key_passes_no_gradient():
    """The kernel's convention (its forward gives such a row 0): a
    negative offset hides every key from the first rows, whose dq is 0
    and whose dout reaches no dk or dv; the reference's ``blockwise``
    convention gives those rows a gradient."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    kw = dict(heads_q=2, heads_kv=1, causal=True, q_offset=-3)
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert not out[:, :3].any()
    np.testing.assert_array_equal(lse[:, :3].numpy(), np.float32(-1e30))
    dout = torch.zeros_like(out)
    dout[:, :3] = 1.0                 # only the hidden rows carry a cotangent
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, dout, scale=1.0,
                                         **kw)
    assert not dq.any() and not dk.any() and not dv.any()
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    dq, _, _ = tfa.flash_attention_bwd(q, k, v, out, lse, dout, scale=1.0,
                                       **kw)
    assert not dq[:, :3].any() and dq[:, 3:].abs().min() > 0
    tq = q.reshape(1, 2, 8, 16).requires_grad_(True)
    bw = TL.blockwise_attention(tq, k.reshape(1, 1, 8, 16),
                                v.reshape(1, 1, 8, 16), q_offset=-3,
                                block_q=8, block_k=8)
    assert bw[:, :, :3].abs().sum() > 0   # the mean of v, not 0


def test_serving_launches_the_forward_alone_without_lse(monkeypatch):
    """With no gradient wanted ``ops.flash_attention`` calls the forward
    wrapper once with no ``lse`` — serving's launch is unchanged; under
    autograd it asks for ``lse`` and the backward runs once."""
    calls, bwd = [], []
    real, real_bwd = tfa.flash_attention, tfa.flash_attention_bwd

    def fwd(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)

    def back(*a, **kw):
        bwd.append(a[0].shape)
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", back)
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, sq=16, sk=16))
    with torch.no_grad():
        tops.flash_attention(q.requires_grad_(True), k, v)
    assert calls == [False] and bwd == []
    tops.flash_attention(q, k, v).sum().backward()
    assert calls == [False, True] and bwd == [(2 * 8, 16, 16)]
    assert q.grad is not None


def test_the_function_saves_the_unscaled_query():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(10, sq=16, sk=16))
    out = tops.flash_attention(q, k, v)
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert torch.equal(saved[0], q.detach().reshape(16, 16, 16))


def _rounded_like_the_tensor_cores(q, k, v, out, lse, dout, hq, hkv, scale,
                                   block=512):
    """The backward with P rounded to bf16 for dV and dS for dK and dQ —
    where the bf16 tensor-core kernel rounds them — every other step f32
    (causal, offset 0), a block of query rows at a time."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b, g = bhq // hq, hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf = k.float().reshape(b, hkv, sk, d)
    vf = v.float().reshape(b, hkv, sk, d)
    dof = dout.float().reshape(b, hkv, g, sq, d)
    delta = (dof * out.float().reshape(b, hkv, g, sq, d)).sum(-1)
    lsef = lse.reshape(b, hkv, g, sq, 1)
    r = lambda t: t.bfloat16().float()
    dq, dk, dv = (torch.zeros_like(qf), torch.zeros_like(kf),
                  torch.zeros_like(vf))
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        qc, doc = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf[:, :, :q1])
        vis = tfa.causal_mask(q1 - q0, q1, q0, q.device)
        p = torch.where(vis, torch.exp(s - lsef[:, :, :, q0:q1]), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vf[:, :, :q1])
        ds = p * (dp - delta[:, :, :, q0:q1, None])
        dv[:, :, :q1] += torch.einsum("bhgqk,bhgqd->bhkd", r(p), doc)
        dk[:, :, :q1] += torch.einsum("bhgqk,bhgqd->bhkd", r(ds), qc)
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", r(ds),
                                          kf[:, :, :q1]) * scale
    return (dq.reshape(q.shape).bfloat16(), dk.reshape(k.shape).bfloat16(),
            dv.reshape(v.shape).bfloat16())


def _emulated_case(hq, hkv, s, d):
    """bf16 inputs at one shape, the plain backward and the emulated
    tensor-core one, and what the planted faults need."""
    g = torch.Generator().manual_seed(s)
    q = (torch.randn(hq, s, d, generator=g) * d ** -0.5).bfloat16()
    k = torch.randn(hkv, s, d, generator=g).bfloat16()
    v = torch.randn(hkv, s, d, generator=g).bfloat16()
    dout = torch.randn(hq, s, d, generator=g).bfloat16()
    fwd = dict(heads_q=hq, heads_kv=hkv, causal=True, q_offset=0)
    kw = dict(fwd, scale=d ** -0.5)
    out, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **fwd)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    got = _rounded_like_the_tensor_cores(q, k, v, out, lse, dout, hq, hkv,
                                         d ** -0.5)
    return q, k, v, out, lse, dout, kw, got, want


#: (Hq, Hkv, S, D): GQA 4 at D 64 with S 512 and at the train shape's
#: S 4096 (llama3.2-1b, train_4k), and D 128 without GQA
ROUNDING_CASES = [(8, 2, 512, 64), (4, 4, 256, 128), (4, 1, 4096, 64)]


@pytest.mark.parametrize("hq,hkv,s,d", ROUNDING_CASES)
def test_rounding_p_and_ds_to_bf16_meets_the_card_tolerance(hq, hkv, s, d):
    """The bf16 kernel rounds P and dS to bf16 as they become tensor-core
    operands, where the plain version keeps f32.  Emulated here, that
    rounding stays within the rule ``chip_smoke.py`` holds the kernel to
    on the card — |err| ≤ 2e-2·|plain| + 1e-2·max(rowmax, 1e-3·max), per
    query row for dq and per key row for dk and dv — with room: it needs
    at most 3.4e-3 of the row's scale, at the train shape's S 4096 too,
    where late rows are some 60 times smaller than the tensor's largest."""
    import chip_smoke

    *_, got, want = _emulated_case(hq, hkv, s, d)
    rule = chip_smoke.ATTN_BWD_TOL["bfloat16"][1]
    for a, w in zip(got, want):
        assert chip_smoke._row_need(a, w) <= 0.34 * rule


def test_the_card_rule_catches_planted_faults():
    """``chip_smoke.py``'s planted faults, made in the emulated gradients at
    the train shape's S 4096 (GQA 4, D 64): the last key tile skipped (its
    share taken out of dq, its dk and dv rows 0), dv 0 for the last
    quarter of the keys, dq 30 % off past the first quarter.  Each fails
    the bf16 row rule by a wide margin (≥ 0.29 of the row's scale against
    the rule's 1e-2); 1e-2 of the tensor's largest gradient alone lets
    the skipped tile's dv through.  The last key tile is the planner's
    (``ATTN_BWD_KEY_TILE``, 128 on the ``"wgmma"`` route); ``q_stale``,
    a stale ring slot of the dK/dV walk, adds its effect to dk and dv."""
    import chip_smoke

    q, k, v, out, lse, dout, kw, got, want = _emulated_case(4, 1, 4096, 64)
    report = chip_smoke._planted_faults(tfa, q, k, v, out, lse, dout, got,
                                        want, kw)
    assert len(report) == 7
    for name, r in report.items():
        assert r["caught"] and r["need_per_row"] >= 0.25, name
    assert report["last key tile skipped: dv"]["need_per_tensor"] <= 1e-2


def _tiled_like_the_wgmma_kernels(q, k, v, out, lse, dout, hq, hkv, scale,
                                  *, causal=True, q_offset=0, stale=False):
    """The ``"wgmma"`` route's tiling: dK and dV per block of
    ``chip_smoke.ATTN_BWD_KEY_TILE`` keys, walking the query tiles of
    ``ATTN_BWD_Q_STEP`` rows that see it for each head of the group in
    turn; dQ per block of 128 query rows, walking the key tiles of 64 in
    order; every sum in f32 a tile at a time in that order, P rounded to
    bf16 for dV and dS for dK and dQ.  With ``stale`` the last tile of
    each key block's walk is read from the slot before it (the previous
    tile's q, dout, lse and delta under the last one's positions)."""
    import chip_smoke

    kt, qs = chip_smoke.ATTN_BWD_KEY_TILE, chip_smoke.ATTN_BWD_Q_STEP
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b, g = bhq // hq, hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf = k.float().reshape(b, hkv, sk, d)
    vf = v.float().reshape(b, hkv, sk, d)
    dof = dout.float().reshape(b, hkv, g, sq, d)
    delta = (dof * out.float().reshape(b, hkv, g, sq, d)).sum(-1)
    lsef = lse.float().reshape(b, hkv, g, sq)
    r = lambda t: t.bfloat16().float()

    def tile(gd, rd, ra, k0, k1):
        """P and dS of the rows ``rd`` of head ``gd`` against keys k0..k1,
        masked at the positions of rows ``ra``."""
        qc, doc = qf[:, :, gd, rd], dof[:, :, gd, rd]
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf[:, :, k0:k1])
        p = torch.exp(s - lsef[:, :, gd, rd, None])
        if causal:
            vis = tfa.causal_mask(ra.stop - ra.start, k1 - k0,
                                  ra.start + q_offset - k0, q.device)
            p = torch.where(vis, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf[:, :, k0:k1])
        return qc, doc, p, p * (dp - delta[:, :, gd, rd, None])

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    n_qt = -(-sq // qs)
    for k0 in range(0, sk, kt):
        k1 = min(sk, k0 + kt)
        qt0 = (max(0, k0 - q_offset) if causal else 0) // qs
        walk = [(gi, t) for gi in range(g) for t in range(qt0, n_qt)]
        for i, (gi, t) in enumerate(walk):
            ra = slice(t * qs, min(sq, t * qs + qs))
            gd, rd = gi, ra
            if stale and i == len(walk) - 1 and i > 0:
                gd, td = walk[i - 1]
                n = min(ra.stop - ra.start, sq - td * qs)
                rd = slice(td * qs, td * qs + n)
                ra = slice(ra.start, ra.start + n)
            qc, doc, p, ds = tile(gd, rd, ra, k0, k1)
            dv[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", r(p), doc)
            dk[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", r(ds), qc)
    dq = torch.zeros_like(qf)
    for q0 in range(0, sq, 128):
        q1 = min(sq, q0 + 128)
        k_end = min(sk, q1 + q_offset) if causal else sk
        for k0 in range(0, max(k_end, 0), 64):
            k1 = min(sk, k0 + 64)
            for gi in range(g):
                _, _, _, ds = tile(gi, slice(q0, q1), slice(q0, q1), k0, k1)
                dq[:, :, gi, q0:q1] += torch.einsum(
                    "bhqk,bhkd->bhqd", r(ds), kf[:, :, k0:k1])
    return ((dq * scale).reshape(q.shape).bfloat16(),
            dk.reshape(k.shape).bfloat16(), dv.reshape(v.shape).bfloat16())


@pytest.mark.parametrize("hq,hkv,s,d", ROUNDING_CASES)
def test_the_wgmma_tiling_needs_no_more_of_the_rule(hq, hkv, s, d):
    """The ``"wgmma"`` kernels' tiling (128 keys a dK/dV block walked 64
    query rows at a time; 128 query rows a dQ block walked 64 keys at a
    time), P and dS rounded to bf16 as they become operands, needs no more
    of the card's bf16 rule than ``_rounded_like_the_tensor_cores``: the
    order of the tile sums moves only f32 roundings, below the bf16
    rounding of the gradients (a share of the rule within 2e-4 of the
    untiled emulation's, both under its 0.34)."""
    import chip_smoke

    q, k, v, out, lse, dout, kw, untiled, want = _emulated_case(hq, hkv, s,
                                                                d)
    tiled = _tiled_like_the_wgmma_kernels(q, k, v, out, lse, dout, hq, hkv,
                                          d ** -0.5)
    rule = chip_smoke.ATTN_BWD_TOL["bfloat16"][1]
    for a, u, w in zip(tiled, untiled, want):
        need = chip_smoke._row_need(a, w) / rule
        assert need <= chip_smoke._row_need(u, w) / rule + 2e-4
        assert need <= 0.34


def test_q_stale_is_a_stale_slot_of_the_dkdv_walk():
    """``chip_smoke.attn_bwd_q_stale``, the planted fault's effect, is the
    difference the tiled emulation shows when the last query tile of each
    key block's walk is read from the slot before it — at a ragged length
    with a query offset, GQA 4."""
    import chip_smoke

    g = torch.Generator().manual_seed(3)
    hq, hkv, sq, sk, d, off = 8, 2, 200, 230, 16, 30
    q = (torch.randn(hq, sq, d, generator=g) * d ** -0.5).bfloat16()
    k = torch.randn(hkv, sk, d, generator=g).bfloat16()
    v = torch.randn(hkv, sk, d, generator=g).bfloat16()
    dout = torch.randn(hq, sq, d, generator=g).bfloat16()
    fwd = dict(heads_q=hq, heads_kv=hkv, causal=True, q_offset=off)
    out, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **fwd)
    args = (q, k, v, out, lse, dout, hq, hkv, d ** -0.5)
    clean = _tiled_like_the_wgmma_kernels(*args, q_offset=off)
    bad = _tiled_like_the_wgmma_kernels(*args, q_offset=off, stale=True)
    dk, dv = chip_smoke.attn_bwd_q_stale(q, k, v, out, lse, dout, **fwd)
    assert dk.abs().max() > 0.1 and dv.abs().max() > 0.1
    for eff, b_, c in ((dk, bad[1], clean[1]), (dv, bad[2], clean[2])):
        torch.testing.assert_close(c.float() + eff, b_.float(), atol=0.05,
                                   rtol=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the full sweep is
    ``chip_smoke.py``'s ``attn_bwd_check``): ragged, GQA 7, an offset;
    two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q = (torch.randn(2 * 14, 100, 64, generator=g) / 8).to(tdt).cuda()
    k = torch.randn(2 * 2, 130, 64, generator=g).to(tdt).cuda()
    v = torch.randn(2 * 2, 130, 64, generator=g).to(tdt).cuda()
    dout = torch.randn(2 * 14, 100, 64, generator=g).to(tdt).cuda()
    kw = dict(heads_q=14, heads_kv=2, q_offset=30)
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, scale=0.125,
                                  **kw)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, dout, scale=0.125,
                                    **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         scale=0.125, **kw)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        if dtype == "float32":
            torch.testing.assert_close(a, w, atol=2e-4, rtol=2e-4)
        else:
            torch.testing.assert_close(
                a.float(), w.float(), rtol=2e-2,
                atol=1e-2 * float(w.float().abs().max()))
