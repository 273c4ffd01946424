"""The hybrid's train path of the port (Jamba's superblock: 7 Mamba-2
layers and 1 attention layer, MoE on every second layer, through
``lm_loss`` → autograd → ``make_train_step``) held against the reference
on the CPU, at the smoke config of jamba-1.5-large-398b (one superblock
of 8 layers, d_model 64, 4/2 heads of 16, 4 experts top-2, d_ff 128,
state 16, chunk 8, vocab 256).

The reference runs **unsharded**: ``jax.value_and_grad`` of its
``lm_loss`` and ``jax.jit(make_train_step(...))`` with no mesh (its mesh
train step fails on this jax, ROADMAP §C), its attention
``"blockwise"``.  Tolerances are ``test_torch_lm_train.py``'s.  As in
``test_torch_moe_train.py``, the routing must agree first: in f32 each
test asserts that both packages choose the same experts; in bf16 the
port replays the reference's choices (its gates from its own f32
logits), remat off, since a replay follows call order.

Two properties of this model shape the comparisons.  In bf16 stacked
Mamba-2 layers at the reference's init have ill-conditioned gradients:
rounding only the weights to bf16 moves them far, and both packages'
bf16 gradients lie far from their f32 ones (``chip_smoke.BF16_GAP_RULE``
gives the readings).  So each leaf of the port's bf16 gradients is held
to the reference's f32 gradients on the same bf16-rounded weights, at
most ``BF16_GAP_RULE``'s multiple of the reference's own bf16 distance
for that leaf plus its floor, and that limit under 1.  And in f32 some
gradient elements lie near AdamW's eps (1e-8) within the two packages'
rounding, where one step moves them anywhere in ±lr: the parameters
after a step are held to the rule plus
``chip_smoke.adam_first_step_slack``, which is 0 but where both
packages' gradients lie under ``chip_smoke.ADAM_SLACK_BELOW``."""
import numpy as np
import pytest
import torch

import jax

from repro.optim import adamw as JA

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw as TA

import chip_smoke
from _torch_port import flat, to_np
from test_torch_lm_train import (_assert_trees, _batch, _jb, _models, _opt,
                                 _ref_step, _ref_value_and_grad, _tb)
from test_torch_moe_train import (_assert_same_routing, _port_choices,
                                  _ref_choices)

ARCH = "jamba-1.5-large-398b"
DTYPES = ["float32", "bfloat16"]


def _value_and_grad(jcfg, tcfg, jp, tp, b, dtype):
    ref = _ref_choices(jcfg, jp, b)
    if dtype == "float32":
        _assert_same_routing(_port_choices(tcfg, tp, b), ref, ARCH)
        return TS._value_and_grad(tcfg, tp, _tb(b))
    with chip_smoke._ReplayingChoices(ref):
        return TS._value_and_grad(tcfg.with_(remat=False), tp, _tb(b))


def _rel_l2(got, want) -> dict:
    """Per leaf ||got − want|| / ||want||, in f32."""
    w = dict(flat(jax.tree.map(to_np, want)))
    return {p: float(np.linalg.norm(to_np(g) - w[p])
                     / max(np.linalg.norm(w[p]), 1e-30))
            for p, g in flat(got)}


def test_lm_loss_and_every_grad_match_the_reference():
    """f32: the loss and every gradient leaf at the f32 rule."""
    jcfg, tcfg, jp, tp = _models(ARCH, "float32")
    assert tcfg.family == "hybrid"
    b = _batch(tcfg.vocab_size)
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = _value_and_grad(jcfg, tcfg, jp, tp, b, "float32")
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    f32 = ("router", "a_log", "dt_bias", "skip_d")
    for path, g in flat(gt):
        want = torch.float32 if path.endswith(f32) else tcfg.param_dtype
        assert g.dtype == want, path
    _assert_trees(gt, gj, "float32", f"{ARCH} f32 grad", grads=True)


def test_bf16_grads_are_as_near_the_f32_reference_as_the_reference():
    """bf16 (the module's docstring): the loss at 3e-2 of the reference's
    bf16 loss, and each leaf of the port's gradients — the reference's
    bf16 routing replayed — within ``BF16_GAP_RULE`` of the reference's f32
    gradients on the same bf16 weights, against that leaf's own distance in
    the reference's bf16 gradients."""
    jcfg32, _, _, _ = _models(ARCH, "float32")
    jcfg, tcfg, jp, tp = _models(ARCH, "bfloat16")
    b = _batch(tcfg.vocab_size)
    rounded = jax.tree.map(lambda a: a.astype(np.float32), jp)
    _, truth = _ref_value_and_grad(jcfg32)(rounded, jcfg32, _jb(b))
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = _value_and_grad(jcfg, tcfg, jp, tp, b, "bfloat16")
    np.testing.assert_allclose(float(lt), float(lj), rtol=3e-2)
    k, floor = chip_smoke.BF16_GAP_RULE
    ref_gap, port_gap = _rel_l2(gj, truth), _rel_l2(gt, truth)
    assert ref_gap.keys() == port_gap.keys()
    for path, gap in ref_gap.items():
        limit = k * gap + floor
        assert 0 < gap and limit < 1, (path, gap)
        assert port_gap[path] <= limit, (path, port_gap[path], gap)


def test_stacked_mamba_gradients_are_ill_conditioned_at_init():
    """Why the bf16 rule above is per leaf against the reference's own
    distance: at 8 layers (the superblock's depth), rounding only the
    weights to bf16 moves a Mamba-2 stack's gradients several times as far
    as a dense stack's (``scripts/bf16_conditioning.py`` at its cuts: 0.10
    against 0.012), and more with depth."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).parents[1] / "scripts"
            / "bf16_conditioning.py")
    spec = importlib.util.spec_from_file_location("bf16_conditioning", path)
    bc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bc)
    mamba = {n: bc.gaps("mamba2-1.3b", n, seq=64)["weights"][0]
             for n in (2, 8)}
    dense = bc.gaps("llama3.2-1b", 8, seq=64)["weights"][0]
    assert mamba[8] > 2 * mamba[2] and mamba[8] > 4 * dense, (mamba, dense)


def test_remat_on_equals_remat_off():
    """The superblock recomputed in the backward: the same loss and
    gradient bits, each attention and SSD forward twice with remat and
    once without, one backward call a layer either way."""
    _, tcfg, _, tp = _models(ARCH, "float32")
    b = _tb(_batch(tcfg.vocab_size))
    runs = {}
    for remat in (True, False):
        calls = {"attn": 0, "attn_bwd": 0, "ssd": 0, "ssd_bwd": 0}

        def counting(name, real):
            def f(*a, **kw):
                calls[name] += 1
                return real(*a, **kw)
            return f

        with pytest.MonkeyPatch.context() as mp:
            for mod, fn, name in ((tfa, "flash_attention", "attn"),
                                  (tfa, "flash_attention_bwd", "attn_bwd"),
                                  (tms, "mamba2_ssd", "ssd"),
                                  (tms, "mamba2_ssd_bwd", "ssd_bwd")):
                mp.setattr(mod, fn, counting(name, getattr(mod, fn)))
            runs[remat] = TS._value_and_grad(tcfg.with_(remat=remat), tp, b)
        k = 2 if remat else 1
        assert calls == {"attn": k, "attn_bwd": 1, "ssd": 7 * k,
                         "ssd_bwd": 7}, remat
    (l1, g1), (l0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


def _step_grads(jcfg, tcfg, jp, tp, b, accum, dtype):
    """The step's gradients in both packages (the mean over ``accum``
    microbatches), the reference's routing checked (f32) or replayed."""
    rows = 4 // accum
    got, want = [], []
    for i in range(accum):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
        want.append(dict(flat(jax.tree.map(
            to_np, _ref_value_and_grad(jcfg)(jp, jcfg, _jb(mb))[1]))))
        got.append(dict(flat(_value_and_grad(jcfg, tcfg, jp, tp, mb,
                                             dtype)[1])))
    return ({p: sum(g[p].float() for g in got) / accum for p in got[0]},
            {p: torch.from_numpy(sum(w[p] for w in want) / accum)
             for p in want[0]})


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 2)])
def test_a_train_step_matches_the_reference(dtype, accum):
    """One step on the data pipeline's batch of 4 rows: loss, grad norm,
    lr, and every parameter — in f32 to the rule plus AdamW's first-step
    slack of the two packages' gradients (the module's docstring); the
    reference's routing checked (f32) or replayed (bf16)."""
    jcfg, tcfg, jp, tp = _models(ARCH, dtype)
    b = _batch(tcfg.vocab_size)
    ref = _ref_choices(jcfg, jp, b, accum)
    if dtype == "float32":
        rows = 4 // accum
        port = sum((_port_choices(tcfg, tp, {k: v[i * rows:(i + 1) * rows]
                                             for k, v in b.items()})
                    for i in range(accum)), [])
        _assert_same_routing(port, ref, ARCH)
        tstep = TS.make_train_step(tcfg, _opt(TA), grad_accum=accum)
        tp2, ts, tm = tstep(tp, TA.init(tp, _opt(TA)), _tb(b))
    else:
        tstep = TS.make_train_step(tcfg.with_(remat=False), _opt(TA),
                                   grad_accum=accum)
        with chip_smoke._ReplayingChoices(ref):
            tp2, ts, tm = tstep(tp, TA.init(tp, _opt(TA)), _tb(b))
    jp2, _, jm = _ref_step(jcfg, accum)(jp, JA.init(jp, _opt(JA)), _jb(b))
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=rtol, err_msg=name)
    assert int(ts.step) == 1
    if dtype == "bfloat16":
        _assert_trees(tp2, jp2, dtype, f"{ARCH} bf16 step", grads=False)
        return
    gt, gj = _step_grads(jcfg, tcfg, jp, tp, b, accum, dtype)
    opt = _opt(TA)
    clips = [min(1.0, opt.grad_clip / (float(m["grad_norm"]) + 1e-9))
             for m in (tm, jm)]
    want = dict(flat(jax.tree.map(to_np, jp2)))
    for path, p in flat(tp2):
        slack = chip_smoke.adam_first_step_slack(
            gt[path], gj[path], lr=float(tm["lr"]), clips=clips,
            eps=opt.eps).numpy()
        w = want[path]
        diff = np.abs(to_np(p) - w)
        assert (diff <= 1e-4 + 1e-4 * np.abs(w) + slack).all(), (
            path, float(diff.max()))


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


def test_the_card_cut_keeps_the_superblock_and_names_itself():
    """``chip_smoke.py``'s hybrid train run cuts the width only: the
    8-layer pattern, 16 experts top-2, the SSM heads (P 64, N 128) and
    chunk and the vocabulary as published, ≈ 0.6 B parameters."""
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.models import lm as tlm

    pub = treg.get_config(ARCH)
    cut = pub.with_(**chip_smoke.HYBRID_TRAIN_CUT)
    assert cut.num_layers == 8 and tlm.num_superblocks(cut) == 1
    assert [(s.mixer, s.ffn) for s in tlm.superblock_pattern(cut)] == [
        (s.mixer, s.ffn) for s in tlm.superblock_pattern(pub)]
    assert (cut.moe, cut.ssm, cut.vocab_size) == (pub.moe, pub.ssm,
                                                  pub.vocab_size)
    assert cut.d_model < pub.d_model and cut.d_ff < pub.d_ff
    assert 0.5e9 < tbase.count_params(cut) < 0.7e9


@pytest.mark.parametrize("g_a,g_b,free", [
    (1.6e-7, 1.4e-8, True), (-2.0e-8, 1.2e-7, True), (-8.3e-8, -7.1e-7, True),
    (1.6e-7, 2e-6, False), (3e-6, -3e-6, False), (0.5, -0.5, False)])
def test_the_adam_slack_frees_only_gradients_below_its_threshold(
        g_a, g_b, free):
    """``adam_first_step_slack`` is the two first steps' distance where
    both gradients lie under ``ADAM_SLACK_BELOW`` (the first three: the
    elements the card and the CPU took apart) and 0 elsewhere, a sign
    flip included."""
    lr, eps = 1e-4, 1e-8
    slack = chip_smoke.adam_first_step_slack(
        torch.tensor([g_a]), torch.tensor([g_b]), lr=lr, clips=(1.0, 1.0),
        eps=eps)
    u = lambda g: g / (abs(g) + eps)
    want = lr * abs(u(g_a) - u(g_b)) if free else 0.0
    assert float(slack[0]) == pytest.approx(want, rel=1e-5, abs=0)
