"""The SSM family's train path of the port (mamba2-1.3b's smoke config: 2
layers, d_model 64, SSM heads of P 16 and N 16, chunk 8) held against the
reference on the CPU: ``lm_loss`` and every gradient leaf against
``jax.value_and_grad`` of the reference's **unsharded** ``lm_loss``, and
train steps against its ``jax.jit(make_train_step)`` with no mesh (its
mesh train step fails on this jax, ROADMAP §C), in f32 and bf16, at the
tolerances of ``test_torch_lm_train.py``.

The reference differentiates its SSD by XLA's autodiff of
``ref.ssd_chunked``; the port's scan goes through ``SsdScan`` (on the
card the forward kernel saving its tile states and the backward kernel;
on a CPU tensor the plain versions, autograd through its own
``ssd_chunked``).  The depthwise conv's f32 tap loop, SiLU, softplus,
the gated RMSNorm and the f32 leaves ``a_log``, ``dt_bias`` and
``skip_d`` differentiate through autograd as they are."""
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA

from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.launch import steps as TS
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as TM
from repro_torch.optim import adamw as TA

from _torch_port import flat
from test_torch_lm_train import (_assert_trees, _batch, _jb, _models, _opt,
                                 _ref_step, _ref_value_and_grad, _tb)

ARCH = "mamba2-1.3b"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_loss_and_every_grad_match_the_reference(dtype):
    jcfg, tcfg, jp, tp = _models(ARCH, dtype)
    b = _batch(tcfg.vocab_size)
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = TS._value_and_grad(tcfg, tp, _tb(b))
    np.testing.assert_allclose(float(lt), float(lj),
                               rtol=1e-5 if dtype == "float32" else 3e-2)
    for path, g in flat(gt):
        want = torch.float32 if path.endswith(TM.F32_LEAVES) else \
            tcfg.param_dtype
        assert g.dtype == want, path
    _assert_trees(gt, gj, dtype, f"{ARCH} {dtype} grad", grads=True)


def test_every_mamba_leaf_gets_a_gradient():
    """The conv taps, the f32 decay, step bias and skip, the gated norm and
    both projections of every layer: none is left at zero."""
    _, tcfg, _, tp = _models(ARCH, "float32")
    _, g = TS._value_and_grad(tcfg, tp, _tb(_batch(tcfg.vocab_size)))
    leaves = dict(flat(g))
    for name in ("in_proj", "conv_w", "a_log", "dt_bias", "skip_d", "norm_w",
                 "out_proj"):
        grad = leaves[f"blocks/b0/mamba/{name}"]
        assert all(bool(layer.abs().max() > 0) for layer in grad), name


def test_remat_on_equals_remat_off_and_counts_the_scans(monkeypatch):
    """``cfg.remat`` recomputes each superblock in the backward: the same
    loss and gradient bits, and — the count the card's launches follow —
    two forward scans a layer with remat (each saving its tile states) and
    one without, one backward a layer either way."""
    _, tcfg, _, tp = _models(ARCH, "float32")
    b = _tb(_batch(tcfg.vocab_size))
    runs = {}
    for remat in (True, False):
        calls = {"fwd": [], "bwd": 0}
        real, real_bwd = tms.mamba2_ssd, tms.mamba2_ssd_bwd

        def fwd(*a, **kw):
            calls["fwd"].append(kw.get("return_states", False))
            return real(*a, **kw)

        def bwd(*a, **kw):
            calls["bwd"] += 1
            return real_bwd(*a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tms, "mamba2_ssd", fwd)
            mp.setattr(tms, "mamba2_ssd_bwd", bwd)
            runs[remat] = TS._value_and_grad(tcfg.with_(remat=remat), tp, b)
        n = tcfg.num_layers
        assert calls["fwd"] == [True] * n * (2 if remat else 1), remat
        assert calls["bwd"] == n, remat
    (l1, g1), (l0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


def test_serving_takes_one_scan_without_states(monkeypatch):
    """Prefill runs without autograd: one forward scan a layer and no
    saved states — serving launches as before."""
    _, tcfg, _, tp = _models(ARCH, "bfloat16")
    calls = []
    real = tms.mamba2_ssd

    def fwd(*a, **kw):
        calls.append(kw.get("return_states", False))
        return real(*a, **kw)

    monkeypatch.setattr(tms, "mamba2_ssd", fwd)
    tlm.lm_prefill(tp, tcfg, {"tokens": torch.zeros(2, 16,
                                                    dtype=torch.int32)})
    assert calls == [False] * tcfg.num_layers


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 2)])
def test_train_steps_match_the_reference(dtype, accum):
    """Three steps on the data pipeline's batches of 4 rows (``grad_accum``
    2: two microbatches of 2, their f32 gradients summed and halved):
    loss, grad norm, lr and every parameter."""
    jcfg, tcfg, jp, tp = _models(ARCH, dtype)
    jstep = _ref_step(jcfg, accum)
    tstep = TS.make_train_step(tcfg, _opt(TA), grad_accum=accum)
    js, ts = JA.init(jp, _opt(JA)), TA.init(tp, _opt(TA))
    for step in range(3):
        b = _batch(tcfg.vocab_size, step)
        jp, js, jm = jstep(jp, js, _jb(b))
        tp, ts, tm = tstep(tp, ts, _tb(b))
        rtol = 1e-5 if dtype == "float32" else 3e-2
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=rtol, err_msg=name)
        if step in (0, 2):
            _assert_trees(tp, jp, dtype, f"{ARCH} {dtype} step {step + 1}",
                          grads=False)
    assert int(ts.step) == 3


def test_a_step_leaves_its_state_and_repeats_bit_for_bit():
    _, tcfg, _, tp = _models(ARCH, "bfloat16")
    step = TS.make_train_step(tcfg, _opt(TA), grad_accum=2)
    st = TA.init(tp, _opt(TA))
    b = _tb(_batch(tcfg.vocab_size))
    before = {p: t.clone() for p, t in flat(tp)}
    p1, _, m1 = step(tp, st, b)
    p2, _, m2 = step(tp, st, b)
    assert all(torch.equal(t, before[p]) for p, t in flat(tp))
    assert torch.equal(m1["loss"], m2["loss"])
    for (path, a), (_, c) in zip(flat(p1), flat(p2)):
        assert torch.equal(a, c), path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_a_train_step_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, tcfg, _, tp = _models(ARCH, "float32")
    b = _batch(tcfg.vocab_size)
    step = TS.make_train_step(tcfg, _opt(TA))
    pc, _, mc = step(tp, TA.init(tp, _opt(TA)), _tb(b))
    tg = TA.tree_map(lambda t: t.cuda(), tp)
    before = tms.bwd_launches
    pg, _, mg = step(tg, TA.init(tg, _opt(TA)),
                     {k: v.cuda() for k, v in _tb(b).items()})
    assert tms.bwd_launches - before == tcfg.num_layers
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    for (path, a), (_, c) in zip(flat(pg), flat(pc)):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=path)
