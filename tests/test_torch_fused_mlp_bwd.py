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


def _cu_constant(name: str) -> int:
    src = (build.CSRC / "fused_mlp_bwd.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_the_kernels_tiles_are_the_planners():
    assert (_cu_constant("HM"), _cu_constant("HN")) == \
        dse.MLP_BWD_HIDDEN_TILE["bfloat16"]
    assert (_cu_constant("GM"), _cu_constant("GN")) == \
        dse.MLP_BWD_GEMM_TILE["bfloat16"]
    assert _cu_constant("KC") == dse.MLP_BWD_CHUNK_K["bfloat16"]
    assert _cu_constant("STAGES") == dse.MLP_BWD_STAGES
    assert (_cu_constant("FT"),) * 2 == dse.MLP_BWD_HIDDEN_TILE["float32"] \
        == dse.MLP_BWD_GEMM_TILE["float32"]
    assert _cu_constant("FK") == dse.MLP_BWD_CHUNK_K["float32"]
    assert _cu_constant("THREADS") == dse.MLP_THREADS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_the_train_shape_gets_a_plan(dtype, gated):
    """llama3.2-1b's train microbatch: every output tile a block, the
    scratch h, du (and dg) at 4 bytes an element, each kernel's shared
    memory within one block's."""
    m, d, f = 16384, 2048, 8192
    plan = dse.plan_mlp_bwd_blocks(m=m, d=d, f=f, gated=gated, dtype=dtype)
    (hm, hn), (gm, gn) = (dse.MLP_BWD_HIDDEN_TILE[dtype],
                          dse.MLP_BWD_GEMM_TILE[dtype])
    assert plan.route == ("mma" if dtype == "bfloat16" else "cuda_core")
    assert plan.grids == {
        "hidden": (m // hm) * (f // hn),
        "wgrad": (3 if gated else 2) * (f // gm) * (d // gn),
        "dx": (m // gm) * (d // gn)}
    assert plan.hidden_bytes == (3 if gated else 2) * 4 * m * f
    assert all(v <= dse.H100.smem_per_block
               for v in plan.smem_bytes.values())
    with pytest.raises(ValueError, match="limit"):
        dse.plan_mlp_bwd_blocks(m=1, d=dse.MLP_MAX_D + 1, f=8, gated=gated,
                                dtype=dtype)


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
    assert all(r["caught"] for r in report.values())


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
