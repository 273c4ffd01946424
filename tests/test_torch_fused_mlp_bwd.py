"""The fused MLP's backward (B3′, ``kernels/fused_mlp.py``: the plain
version ``fused_mlp_bwd_plain``, the wrapper ``fused_mlp_bwd``, the
autograd route ``FusedMlp`` behind ``ops.fused_mlp``) held against the
reference on the CPU: ``jax.vjp`` of its streamed MLP
(``repro.models.layers._mlp_streamed``, a scan over ``d_ff`` tiles) on
the same NumPy inputs, the four activations gated and ungated, a ragged
M, f32 and bf16.

Tolerances are ``test_torch_fused_mlp.py``'s: f32 atol = rtol = 5e-4
(sums in another order).  bf16 1e-2, and for a gradient taken relative
to its largest value as ``test_torch_lm_train.py`` takes its bf16
gradients (|err| ≤ 1e-2·max|ref| + 1e-2·|ref|): the reference rounds
every product and each tile's sum to bf16, the plain version sums in
f32 and rounds once, so the two differ by the reference's rounding.  The
CUDA kernels themselves are held against the plain version on the card
by ``chip_smoke.py``'s ``mlp_bwd_check`` and by the ``cuda``-marked
tests below; here ``chip_smoke.mlp_bwd_split``, the kernels' formula with
their bf16 roundings, sets the card's hi + lo bound."""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.optim import adamw as JA

from repro_torch.core import dse
from repro_torch.kernels import build
from repro_torch.kernels import fused_mlp as tfm
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw as TA

import chip_smoke
from _torch_port import flat
from test_torch_lm_train import (_assert_trees, _batch, _jb, _models, _opt,
                                 _ref_step, _ref_value_and_grad, _tb)

ACTS = ["silu", "gelu", "relu", "squared_relu"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 5e-4, "bfloat16": 1e-2}
M, D, F, BLOCK_F = 37, 64, 256, 64       # M ragged against every tile


def _inputs(seed, m=M, d=D, f=F, gated=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    wg = (rng.standard_normal((d, f)) * 0.1).astype(np.float32) if gated \
        else None
    wu = (rng.standard_normal((d, f)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((f, d)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    return x, wg, wu, wd, dy


def _t(a, dtype="float32"):
    return None if a is None else torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ref_grads(x, wg, wu, wd, dy, act, dtype):
    """(dx, dWg or None, dWu, dWd) of the reference's ``_mlp_streamed`` by
    ``jax.vjp``, tiles of ``BLOCK_F``."""
    cfg = jreg.get_config("llama3.2-1b", smoke=True).with_(
        d_ff=wu.shape[1], act=act, gated_mlp=wg is not None, dtype=dtype)
    p = {"wu": jnp.asarray(wu).astype(dtype),
         "wd": jnp.asarray(wd).astype(dtype)}
    if wg is not None:
        p["wg"] = jnp.asarray(wg).astype(dtype)
    _, vjp = jax.vjp(lambda p, x: JL._mlp_streamed(p, cfg, x, BLOCK_F), p,
                     jnp.asarray(x).astype(dtype))
    gp, gx = vjp(jnp.asarray(dy).astype(dtype))
    return gx, gp.get("wg"), gp["wu"], gp["wd"]


def _assert_grads(got, want, dtype, what):
    tol = TOL[dtype]
    for name, g, w in zip(("dx", "dwg", "dwu", "dwd"), got, want):
        if w is None:
            assert g is None, f"{what} {name}"
            continue
        w = _np(w)
        atol = tol if dtype == "float32" else tol * float(np.abs(w).max())
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_plain_backward_matches_the_reference(act, gated, dtype):
    x, wg, wu, wd, dy = _inputs(0, gated=gated)
    got = tfm.fused_mlp_bwd_plain(*(_t(a, dtype) for a in (x, wg, wu, wd,
                                                           dy)),
                                  act=act)
    for g, ref in zip(got, (x, wg, wu, wd)):
        assert (g is None) == (ref is None)
        if g is not None:
            assert g.dtype == getattr(torch, dtype) and g.shape == ref.shape
    _assert_grads(got, _ref_grads(x, wg, wu, wd, dy, act, dtype), dtype,
                  f"{act} gated={gated} {dtype}")


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_the_plain_backward_is_autograd_of_the_plain_forward(act, gated):
    """The sums of ``fused_mlp_bwd_plain`` are the gradients autograd takes
    through ``fused_mlp_plain`` (f32, the order of the sums aside)."""
    ins = [_t(a) for a in _inputs(1, gated=gated)]
    x, wg, wu, wd, dy = ins
    leaves = [t.clone().requires_grad_(True) if t is not None else None
              for t in (x, wg, wu, wd)]
    out = tfm.fused_mlp_plain(*leaves, act=act)
    auto = torch.autograd.grad(out, [t for t in leaves if t is not None], dy)
    got = [g for g in tfm.fused_mlp_bwd_plain(*ins, act=act)
           if g is not None]
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_act_grad_is_the_derivative_of_the_activation(act):
    from repro_torch.kernels import ref

    v = torch.linspace(-4, 4, 801, dtype=torch.float64)
    v = v[v.abs() > 1e-3]              # relu's kink
    v.requires_grad_(True)
    (auto,) = torch.autograd.grad(ref._act(act, v).sum(), v)
    torch.testing.assert_close(tfm.act_grad(act, v.detach()), auto)


# ---------------------------------------------------------------------------
# the autograd route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_gives_the_plain_gradients_on_the_cpu(act, gated, dtype):
    """``ops.fused_mlp`` under autograd is ``FusedMlp``: its gradients are
    ``fused_mlp_bwd_plain``'s bit for bit, and its output the forward's."""
    x, wg, wu, wd, dy = (_t(a, dtype) for a in _inputs(2, gated=gated))
    leaves = [t.requires_grad_(True) for t in (x, wg, wu, wd)
              if t is not None]
    out = tops.fused_mlp(x, wg, wu, wd, act=act, block_f=BLOCK_F)
    assert torch.equal(out.detach(), tfm.fused_mlp(
        x.detach(), None if wg is None else wg.detach(), wu.detach(),
        wd.detach(), act=act))
    got = torch.autograd.grad(out, leaves, dy)
    want = [g for g in tfm.fused_mlp_bwd_plain(
        x.detach(), None if wg is None else wg.detach(), wu.detach(),
        wd.detach(), dy, act=act) if g is not None]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_route_takes_fused_mlp_only_under_autograd(monkeypatch):
    """One forward call and no backward without a gradient; under
    autograd the forward once, the backward once, leading axes folded."""
    calls = {"fwd": 0, "bwd": 0}
    real, real_bwd = tfm.fused_mlp, tfm.fused_mlp_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(tfm, "fused_mlp", fwd)
    monkeypatch.setattr(tfm, "fused_mlp_bwd", bwd)
    x, wg, wu, wd, _ = (_t(a) for a in _inputs(3))
    x3 = x[:36].reshape(2, 18, D)
    out = tops.fused_mlp(x3, wg, wu, wd)
    assert out.grad_fn is None and calls == {"fwd": 1, "bwd": 0}
    wu.requires_grad_(True)
    with torch.no_grad():
        tops.fused_mlp(x3, wg, wu, wd)
    assert calls == {"fwd": 2, "bwd": 0}
    out = tops.fused_mlp(x3, wg, wu, wd)
    assert out.shape == x3.shape
    out.sum().backward()
    assert calls == {"fwd": 3, "bwd": 1} and wu.grad.shape == wu.shape


def test_the_backward_saves_no_hidden():
    """``FusedMlp`` keeps x and the weights for its backward, nothing of
    the (M, F) hidden."""
    x, wg, wu, wd, _ = (_t(a).requires_grad_(True) for a in _inputs(4)
                        if a is not None)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tfm.FusedMlp.apply(x, wg, wu, wd, "silu")
    assert sorted(saved) == sorted([(M, D), (D, F), (D, F), (F, D)])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wg, wu, wd, dy = (_t(a) for a in _inputs(5))
    with pytest.raises(ValueError, match="dy"):
        tfm.fused_mlp_bwd(x, wg, wu, wd, dy[:5])
    with pytest.raises(ValueError, match="activation"):
        tfm.fused_mlp_bwd(x, wg, wu, wd, dy, act="tanh")
    with pytest.raises(TypeError):
        tfm.fused_mlp_bwd(x.double(), wg.double(), wu.double(), wd.double(),
                          dy.double())
    wide = torch.zeros(1, dse.MLP_MAX_D + 1)
    w = torch.zeros(dse.MLP_MAX_D + 1, 8)
    with pytest.raises(ValueError, match="limit"):
        tfm.fused_mlp_bwd(wide, None, w, w.T, wide)


def test_cpu_call_never_builds_or_loads_the_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path reached for the CUDA library")

    monkeypatch.setattr(tfm.BWD_LIBRARY, "load", boom)
    monkeypatch.setattr(build, "build_libraries", boom)
    monkeypatch.setattr(build.subprocess, "Popen", boom)
    before = (tfm.bwd_launches, tfm.bwd_plain_cuda_calls)
    ins = [_t(a) for a in _inputs(6)]
    dx, *_ = tfm.fused_mlp_bwd(*ins)
    assert dx.shape == (M, D)
    assert (tfm.bwd_launches, tfm.bwd_plain_cuda_calls) == before


# ---------------------------------------------------------------------------
# the planner and the kernels' constants
# ---------------------------------------------------------------------------


def _cu_source() -> str:
    return (build.CSRC / "fused_mlp_bwd.cu").read_text()


def _cu_constant(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", _cu_source()).group(1))


def _expr(src, start):
    """The expression from ``start`` to the next ``;``, whitespace cut."""
    return " ".join(src[src.index(start):].split(";")[0].split())


def test_the_kernels_tiles_are_the_planners():
    """Every tile, chunk, stage and thread constant of the three routes is
    the planner's, and each route's shared memory is the formula of
    ``dse.mlp_bwd_smem_bytes``."""
    # "wgmma": warp-specialised, TMA into a ring
    assert (_cu_constant("HWM"), _cu_constant("HWN")) == \
        dse.MLP_BWD_HIDDEN_TILE["bfloat16"]
    assert (_cu_constant("GWM"), _cu_constant("GWN")) == \
        dse.MLP_BWD_GEMM_TILE["bfloat16"]
    assert _cu_constant("BK") == dse.MLP_BWD_CHUNK_K["bfloat16"]
    assert _cu_constant("HBK") == dse.MLP_BWD_HIDDEN_CHUNK_K
    assert _cu_constant("H_STAGES") == dse.MLP_BWD_STAGES["hidden"]
    assert _cu_constant("G_STAGES") == dse.MLP_BWD_STAGES["gemm"]
    assert _cu_constant("WG_THREADS") == dse.MLP_BWD_WG_THREADS
    # "mma": the mma.sync kernels, kept for what TMA cannot read
    assert (_cu_constant("HM"), _cu_constant("HN")) == \
        dse.MLP_BWD_MMA_HIDDEN_TILE
    assert (_cu_constant("GM"), _cu_constant("GN")) == \
        dse.MLP_BWD_MMA_GEMM_TILE
    assert _cu_constant("KC") == dse.MLP_BWD_MMA_CHUNK_K
    assert _cu_constant("STAGES") == dse.MLP_BWD_MMA_STAGES
    # "cuda_core": f32
    assert (_cu_constant("FT"),) * 2 == dse.MLP_BWD_HIDDEN_TILE["float32"] \
        == dse.MLP_BWD_GEMM_TILE["float32"]
    assert _cu_constant("FK") == dse.MLP_BWD_CHUNK_K["float32"]
    assert _cu_constant("THREADS") == dse.MLP_THREADS

    src = _cu_source()
    assert _expr(src, "constexpr int H_STAGE_BYTES =") == (
        "constexpr int H_STAGE_BYTES = 2 * H_X + 3 * H_W")
    assert _expr(src, "constexpr int G_STAGE_BYTES =") == (
        "constexpr int G_STAGE_BYTES = 2 * G_A + G_B")
    assert _expr(src, "constexpr int H_OUT_BYTES =") == (
        "constexpr int H_OUT_BYTES = 2 * 6 * (HWN / 64) * SLAB")
    assert _expr(src, "constexpr int H_RING =") == (
        "constexpr int H_RING = H_STAGES * H_STAGE_BYTES > H_OUT_BYTES ? "
        "H_STAGES * H_STAGE_BYTES : H_OUT_BYTES")
    assert _expr(src, "constexpr size_t H_WG_SMEM =") == (
        "constexpr size_t H_WG_SMEM = (size_t)H_RING + 1024")
    assert _expr(src, "constexpr size_t G_WG_SMEM =") == (
        "constexpr size_t G_WG_SMEM = (size_t)G_STAGES * G_STAGE_BYTES + "
        "1024")
    assert "uint64_t full[H_STAGES], empty[H_STAGES];" in src
    assert src.count("uint64_t full[G_STAGES], empty[G_STAGES];") == 2
    assert "constexpr int ROW_BYTES = BK * 2;" in src
    assert "constexpr int H_ROW = HBK * 2;" in src
    assert "constexpr int SLAB = 64 * ROW_BYTES;" in src
    assert _expr(src, "constexpr int H_X =") == (
        "constexpr int H_X = HWM * H_ROW, H_W = HWN * H_ROW, "
        "H_WBOX = HBK * H_ROW")
    assert _expr(src, "constexpr int G_A =") == (
        "constexpr int G_A = GWM * ROW_BYTES, G_B = GWN * ROW_BYTES")
    (hm, hn), (gm, gn) = (dse.MLP_BWD_HIDDEN_TILE["bfloat16"],
                          dse.MLP_BWD_GEMM_TILE["bfloat16"])
    row = 2 * dse.MLP_BWD_CHUNK_K["bfloat16"]
    hrow = 2 * dse.MLP_BWD_HIDDEN_CHUNK_K
    hs, gs = dse.MLP_BWD_STAGES["hidden"], dse.MLP_BWD_STAGES["gemm"]
    slab = 64 * row
    assert dse.mlp_bwd_smem_bytes("wgmma") == {
        "hidden": max(hs * (2 * hm + 3 * hn) * hrow,
                      2 * 6 * (hn // 64) * slab) + 1024 + 2 * 8 * hs,
        "gemm": gs * (2 * gm + gn) * row + 1024 + 2 * 8 * gs}
    # the producer's 40 registers and the consumers' 232 within the SM's
    assert "constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;" in src
    assert 128 * 40 + 2 * 128 * 232 <= 65536


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_the_train_shape_gets_a_plan(dtype, gated):
    """llama3.2-1b's train microbatch: bf16 on ``"wgmma"`` — the hidden
    kernel's (128, 64) tiles, the weight gradients' 128 x 256 tiles of (F,
    D) for each of the two or three products, dx's of (M, D) — f32 on the
    CUDA cores; the scratch h, du (and dg) at 4 bytes an element, each
    kernel's shared memory within one block's."""
    m, d, f = 16384, 2048, 8192
    plan = dse.plan_mlp_bwd_blocks(m=m, d=d, f=f, gated=gated, dtype=dtype)
    (hm, hn), (gm, gn) = (dse.MLP_BWD_HIDDEN_TILE[dtype],
                          dse.MLP_BWD_GEMM_TILE[dtype])
    terms = 3 if gated else 2
    if dtype == "bfloat16":
        assert plan.route == "wgmma"
        assert plan.grids == {"hidden": (m // 128) * (f // 64),
                              "wgrad": terms * (f // 128) * (d // 256),
                              "dx": (m // 128) * (d // 256)}
        assert plan.grids["wgrad"] == (1536 if gated else 1024)
        assert plan.grids["dx"] == 1024
        assert plan.smem_bytes == dse.mlp_bwd_smem_bytes("wgmma")
    else:
        assert plan.route == "cuda_core"
        assert plan.grids == {
            "hidden": (m // hm) * (f // hn),
            "wgrad": terms * (f // gm) * (d // gn),
            "dx": (m // gm) * (d // gn)}
    assert plan.hidden_bytes == terms * 4 * m * f
    assert all(v <= dse.H100.smem_per_block
               for v in plan.smem_bytes.values())
    with pytest.raises(ValueError, match="limit"):
        dse.plan_mlp_bwd_blocks(m=1, d=dse.MLP_MAX_D + 1, f=8, gated=gated,
                                dtype=dtype)


@pytest.mark.parametrize("m,d,f,aligned", [(37, 895, 999, True),
                                           (100, 256, 1000, False),
                                           (100, 896, 1004, True),
                                           (16384, 2048, 8192, False)])
def test_what_tma_cannot_read_plans_mma(m, d, f, aligned):
    """D or F off a multiple of 8 bf16 (16 bytes), or a base off 16 bytes,
    takes the ``"mma"`` route with its own tiles; bf16 alone has the
    choice."""
    plan = dse.plan_mlp_bwd_blocks(m=m, d=d, f=f, gated=True,
                                   dtype="bfloat16", aligned=aligned)
    (hm, hn), (gm, gn) = (dse.MLP_BWD_MMA_HIDDEN_TILE,
                          dse.MLP_BWD_MMA_GEMM_TILE)

    def tiles(r, c, tr, tc):
        return -(-r // tr) * -(-c // tc)

    assert plan.route == "mma"
    assert plan.grids == {
        "hidden": tiles(m, f, hm, hn),
        "wgrad": tiles(f, d, gm, gn) + 2 * tiles(d, f, gm, gn),
        "dx": tiles(m, d, gm, gn)}
    assert plan.smem_bytes == dse.mlp_bwd_smem_bytes("mma")
    assert dse.plan_mlp_bwd_blocks(m=m, d=d, f=f, gated=True,
                                   dtype="float32",
                                   aligned=aligned).route == "cuda_core"
    assert dse.plan_mlp_bwd_blocks(m=m, d=1024, f=1024, gated=True,
                                   dtype="bfloat16").route == "wgmma"


def test_the_launchers_alignment_test_is_the_planners():
    """The launcher takes the wgmma route only where its own test holds —
    D and F multiples of ``MLP_BWD_TMA_ALIGN``, every base 16-byte aligned
    — the planner's rule; refuses the route elsewhere rather than take
    another; and the wrapper hands the planner the bases' alignment and
    the launcher the planner's route."""
    src = _cu_source()
    a = dse.MLP_BWD_TMA_ALIGN
    assert a * 2 == 16
    assert (f"const bool tma_ok = D % {a} == 0 && F % {a} == 0 && "
            "(bases & 15) == 0;") in src
    assert _expr(src, "if (route == 2) {") == (
        "if (route == 2) { if (!tma_ok) return (int)cudaErrorInvalidValue")
    assert "(dtype == 0 ? route != 0 : route != 1 && route != 2))" in src
    for name, addr in (("x", "x"), ("wg", "wg"), ("wu", "wu"), ("wd", "wd"),
                       ("dy", "dy"), ("dx", "dx"), ("dwg", "dwg"),
                       ("dwu", "dwu"), ("dwd", "dwd"), ("hidden", "hidden")):
        assert f"reinterpret_cast<uintptr_t>({addr})" in src, name
    assert tfm.BWD_ROUTE_CODES == {"cuda_core": 0, "mma": 1, "wgmma": 2}
    py = pathlib.Path(tfm.__file__).read_text()
    assert "t.data_ptr() % 16 == 0" in py
    assert "BWD_ROUTE_CODES[plan.route]" in py
    assert "plan = bwd_plan(x, w_gate, w_up, w_down, dy)" in py
    # bwd_plan's alignment on tensors: one element off is two bytes off
    x, wg, wu, wd, dy = (_t(a, "bfloat16") for a in _inputs(11, 100, 256,
                                                              1000))
    assert tfm.bwd_plan(x, wg, wu, wd, dy).route == "wgmma"
    buf = torch.zeros(100 * 256 + 1, dtype=torch.bfloat16)
    off = buf[1:].view(100, 256)
    assert off.data_ptr() % 16 != 0
    assert tfm.bwd_plan(off, wg, wu, wd, dy).route == "mma"
    assert tfm.bwd_plan(*(t.float() for t in (x, wg, wu, wd, dy))).route \
        == "cuda_core"


# ---------------------------------------------------------------------------
# the kernels' formula and the card's rule
# ---------------------------------------------------------------------------


def _bf16_inputs(seed, m, d, f, gated):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, d, generator=g).bfloat16()
    wg = (torch.randn(d, f, generator=g) * d ** -0.5).bfloat16() if gated \
        else None
    wu = (torch.randn(d, f, generator=g) * d ** -0.5).bfloat16()
    wd = (torch.randn(f, d, generator=g) * f ** -0.5).bfloat16()
    dy = torch.randn(m, d, generator=g).bfloat16()
    return x, wg, wu, wd, dy


def _emulated(inputs, act, **kw):
    return [None if t is None else t.to(torch.bfloat16)
            for t in chip_smoke.mlp_bwd_split(*inputs, act=act, **kw)]


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("squared_relu", True),
                                       ("relu", False)])
def test_the_split_formula_is_the_plain_backward(act, gated):
    inputs = [t.float() if t is not None else None
              for t in _bf16_inputs(7, 100, 64, 320, gated)]
    got = chip_smoke.mlp_bwd_split(*inputs, act=act)
    want = tfm.fused_mlp_bwd_plain(*inputs, act=act)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("squared_relu", True)])
def test_each_hilo_operand_in_bf16_alone_exceeds_the_card_bound(act, gated):
    """The bf16 kernels take h, du and dg as hi + lo.  Emulated here
    (M 1024, D 256, F 1024): hi + lo needs far less than
    ``MLP_BWD_HILO_SHARE`` of the 1e-2 rule, and each of them rounded to
    bf16 alone needs more (measured 0.15-0.28): ``_mlp_bwd_hilo_check``
    passes the first and refuses each of the second."""
    inputs = _bf16_inputs(8, 1024, 256, 1024, gated)
    want = tfm.fused_mlp_bwd_plain(*inputs, act=act)
    got = _emulated(inputs, act, hilo=True)
    row = chip_smoke._mlp_bwd_close(got, want, "bfloat16", act)
    report = chip_smoke._mlp_bwd_hilo_check(inputs, act, got, want,
                                            row["need"])
    assert report["share"] <= 0.1 * chip_smoke.MLP_BWD_HILO_SHARE
    ops = set(chip_smoke.MLP_BWD_HILO) - (set() if gated else {"dg"})
    assert set(report["lo_dropped"]) == ops
    assert min(report["lo_dropped"].values()) >= 0.1
    for op in ops:
        alone = _emulated(inputs, act, hilo=True, bf16_alone=op)
        needs = chip_smoke._mlp_bwd_close(alone, want, "bfloat16", op)
        with pytest.raises(AssertionError, match="beyond the"):
            chip_smoke._mlp_bwd_hilo_check(inputs, act, alone, want,
                                           needs["need"])


def test_the_rule_catches_the_planted_faults():
    inputs = _bf16_inputs(9, 512, 128, 512, True)
    want = tfm.fused_mlp_bwd_plain(*inputs, act="silu")
    got = _emulated(inputs, "silu", hilo=True)
    report = chip_smoke._mlp_bwd_faults(inputs, "silu", got, want)
    assert set(report) == set(chip_smoke.MLP_BWD_FAULTS)
    assert {"act_grad", "f_shift", "k_stale"} <= set(report)
    assert all(r["caught"] for r in report.values())


def test_k_stale_is_a_stale_chunk_of_the_weight_gradient_walk():
    """``k_stale`` plants one chunk of ``MLP_BWD_CHUNK_K`` rows of the
    weight gradients' walk over M read again from the slot before it: dx
    is untouched, each weight gradient moves by exactly that chunk's
    terms."""
    inputs = [t.float() for t in _bf16_inputs(12, 256, 64, 128, True)]
    k = dse.MLP_BWD_CHUNK_K["bfloat16"]
    clean = chip_smoke.mlp_bwd_split(*inputs, act="silu")
    bad = chip_smoke.mlp_bwd_split(*inputs, act="silu", fault="k_stale")
    assert torch.equal(bad[0], clean[0])
    x, wg, wu, wd, dy = inputs
    h, du, dg = tfm.mlp_bwd_hidden(x, wg, wu, wd, dy, act="silu")
    last, prev = slice(-k, None), slice(-2 * k, -k)
    want_dwd = clean[3] - h[last].T @ dy[last] + h[prev].T @ dy[prev]
    torch.testing.assert_close(bad[3], want_dwd, atol=1e-4, rtol=1e-5)
    want_dwu = clean[2] - x[last].T @ du[last] + x[prev].T @ du[prev]
    torch.testing.assert_close(bad[2], want_dwu, atol=1e-4, rtol=1e-5)
    want_dwg = clean[1] - x[last].T @ dg[last] + x[prev].T @ dg[prev]
    torch.testing.assert_close(bad[1], want_dwg, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the streamed LM trains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_loss_and_every_grad_match_the_reference(dtype):
    """llama3.2-1b's smoke config with ``mlp_impl="streamed"``: the loss and
    every gradient leaf against ``jax.value_and_grad`` of the reference's
    unsharded ``lm_loss`` (its streamed MLP differentiated by XLA)."""
    jcfg, tcfg, jp, tp = _models("llama3.2-1b", dtype,
                                 mlp_impl="streamed")
    b = _batch(tcfg.vocab_size)
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = TS._value_and_grad(tcfg, tp, _tb(b))
    np.testing.assert_allclose(float(lt), float(lj),
                               rtol=1e-5 if dtype == "float32" else 3e-2)
    _assert_trees(gt, gj, dtype, f"streamed {dtype} grad", grads=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_streamed_train_step_matches_the_reference(dtype):
    """One step with two microbatches against the reference's unsharded
    ``jax.jit(make_train_step)``: loss, grad norm, lr and every
    parameter."""
    jcfg, tcfg, jp, tp = _models("llama3.2-1b", dtype,
                                 mlp_impl="streamed")
    b = _batch(tcfg.vocab_size)
    jp, _, jm = _ref_step(jcfg, 2)(jp, JA.init(jp, _opt(JA)), _jb(b))
    tp, _, tm = TS.make_train_step(tcfg, _opt(TA), grad_accum=2)(
        tp, TA.init(tp, _opt(TA)), _tb(b))
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=rtol, err_msg=name)
    _assert_trees(tp, jp, dtype, f"streamed {dtype} step", grads=False)


def test_streamed_remat_on_equals_remat_off():
    _, tcfg, _, tp = _models("llama3.2-1b", "float32", mlp_impl="streamed")
    b = _tb(_batch(tcfg.vocab_size))
    l1, g1 = TS._value_and_grad(tcfg.with_(remat=True), tp, b)
    l0, g0 = TS._value_and_grad(tcfg.with_(remat=False), tp, b)
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the sweep is ``chip_smoke.py``'s):
    the backward kernels against their plain version, and twice the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    ins = [None if a is None else _t(a, dtype).cuda()
           for a in _inputs(10, 100, 896, 1000)]
    got = tfm.fused_mlp_bwd(*ins, act="gelu")
    again = tfm.fused_mlp_bwd(*ins, act="gelu")
    want = tfm.fused_mlp_bwd_plain(*ins, act="gelu")
    tol = TOL[dtype]
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=tol * float(
            c.float().abs().max()), rtol=tol)
