"""The MoE family's train path of the port (granite-moe-1b-a400m's smoke
config: 2 layers, d_model 64, 8 experts top 2) held against the reference
on the CPU: ``lm_loss`` and every gradient leaf against
``jax.value_and_grad`` of the reference's **unsharded** ``lm_loss``, and
train steps against its ``jax.jit(make_train_step)`` with no mesh (its
mesh train step fails on this jax, ROADMAP §C), in f32 and bf16, at the
tolerances of ``test_torch_lm_train.py``.

The gates' gradient flows through ``softmax`` of the top-k logits and the
sort's backward into the f32 router; a dropped choice gets a zero
cotangent.  What must agree first is the routing itself: each test
asserts that both packages choose the same experts and positions.  In
f32 they do.  In bf16 each package's attention rounds in its own order,
and a near-tied choice in layer 1 flips (a discrete difference
of the inputs, not of the gradient; routing on equal inputs is held bit
for bit by ``test_torch_moe_serve.py``), so the bf16 comparisons replay
the reference's choices in the port (``chip_smoke._ReplayingChoices``:
expert indices, positions and drops; the gate weights recomputed from the
port's own f32 logits, so the router's gradient flows) — no tolerance is
widened.  A replay follows call order, so those runs take ``remat`` off
(remat on equals remat off bit for bit below)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.models import moe as JMOE
from repro.optim import adamw as JA

from repro_torch.configs import base as tbase
from repro_torch.launch import steps as TS
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as TA

import chip_smoke
from _torch_port import flat
from test_torch_lm_train import (_assert_trees, _batch, _jb, _models, _opt,
                                 _ref_step, _ref_value_and_grad, _tb)
from test_torch_moe_serve import _ref_routing

ARCH = "granite-moe-1b-a400m"
DTYPES = ["float32", "bfloat16"]


def _ref_choices(jcfg, jp, batch, accum: int = 1) -> list:
    """The reference's choices ``(gate_i, pos, keep)`` of each MoE layer
    of ``lm_loss`` on each of ``accum`` microbatches, in call order: its
    own routing lines (``_ref_routing``) read out of a forward through
    ``jax.debug.callback`` (``moe.moe_layer`` wrapped for the call, not
    changed)."""
    got = []
    real = JMOE.moe_layer

    def wrapped(p, cfg, x):
        _, gi, pos, keep = _ref_routing(p, cfg, x.reshape(-1, x.shape[-1]))
        jax.debug.callback(lambda *a: got.append(tuple(
            torch.from_numpy(np.array(t)) for t in a)), gi, pos, keep)
        return real(p, cfg, x)

    rows = next(iter(batch.values())).shape[0] // accum
    try:
        JMOE.moe_layer = wrapped
        for i in range(accum):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            jlm.lm_loss(jp, jcfg.with_(remat=False), _jb(mb))
        jax.effects_barrier()
    finally:
        JMOE.moe_layer = real
    return got


def _port_choices(tcfg, tp, batch) -> list:
    with torch.no_grad(), chip_smoke._choices() as rec:
        TS.model_loss(tp, tcfg, _tb(batch))
    return rec.calls


def _assert_same_routing(port, ref, what):
    assert len(port) == len(ref), what
    for i, ((gi, pos, keep), (rgi, rpos, rkeep)) in enumerate(zip(port,
                                                                  ref)):
        for name, a, b in (("experts", gi, rgi), ("positions", pos, rpos),
                           ("drops", keep, rkeep)):
            assert torch.equal(a.long(), b.long()), (
                f"{what}: the two packages route MoE layer {i} differently "
                f"({name}; {float((a.long() != b.long()).float().mean()):.3%}"
                " differ) — a flip of near-tied logits, not a gradient "
                "error")


def _value_and_grad(jcfg, tcfg, jp, tp, b, dtype):
    """The port's loss and gradients on ``b``: in f32 after asserting that
    it routes as the reference does, in bf16 replaying the reference's
    choices (the module docstring says why)."""
    ref = _ref_choices(jcfg, jp, b)
    if dtype == "float32":
        _assert_same_routing(_port_choices(tcfg, tp, b), ref, ARCH)
        return TS._value_and_grad(tcfg, tp, _tb(b))
    with chip_smoke._ReplayingChoices(ref):
        return TS._value_and_grad(tcfg.with_(remat=False), tp, _tb(b))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_loss_and_every_grad_match_the_reference(dtype):
    jcfg, tcfg, jp, tp = _models(ARCH, dtype)
    b = _batch(tcfg.vocab_size)
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = _value_and_grad(jcfg, tcfg, jp, tp, b, dtype)
    np.testing.assert_allclose(float(lt), float(lj),
                               rtol=1e-5 if dtype == "float32" else 3e-2)
    for path, g in flat(gt):
        want = torch.float32 if path.endswith("router") else \
            tcfg.param_dtype
        assert g.dtype == want, path
    _assert_trees(gt, gj, dtype, f"{ARCH} {dtype} grad", grads=True)


def test_bf16_routing_differs_from_the_reference_by_a_flip_at_most():
    """What the bf16 comparisons replay: the port's own bf16 routing
    agrees with the reference's on ≥ 99 % of the (token, choice) pairs of
    every layer, and on every one of layer 0 (the first attention output
    rounds alike)."""
    jcfg, tcfg, jp, tp = _models(ARCH, "bfloat16")
    b = _batch(tcfg.vocab_size)
    port, ref = _port_choices(tcfg, tp, b), _ref_choices(jcfg, jp, b)
    _assert_same_routing(port[:1], ref[:1], f"{ARCH} bf16 layer 0")
    for (gi, _, _), (rgi, _, _) in zip(port, ref):
        assert float((gi.long() == rgi.long()).float().mean()) >= 0.99


def test_remat_on_equals_remat_off():
    """Recomputing each superblock in the backward routes again, to the
    same choices: the same loss and gradient bits."""
    _, tcfg, _, tp = _models(ARCH, "float32")
    b = _tb(_batch(tcfg.vocab_size))
    l1, g1 = TS._value_and_grad(tcfg.with_(remat=True), tp, b)
    l0, g0 = TS._value_and_grad(tcfg.with_(remat=False), tp, b)
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


def test_replaying_the_choices_keeps_the_routers_gradient():
    """Replaying a run's own choices gives that run's loss and gradients,
    the router's included (a replay of the recorded gates would have
    frozen them, and the router's gradient would be 0)."""
    _, tcfg, _, tp = _models(ARCH, "float32")
    cfg = tcfg.with_(remat=False)
    b = _tb(_batch(tcfg.vocab_size))
    with chip_smoke._choices() as rec:
        l0, g0 = TS._value_and_grad(cfg, tp, b)
    with chip_smoke._ReplayingChoices(rec.calls):
        l1, g1 = TS._value_and_grad(cfg, tp, b)
    torch.testing.assert_close(l1, l0, atol=0, rtol=0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        torch.testing.assert_close(a, c, atol=1e-7, rtol=1e-6, msg=path)
    assert all(g.abs().max() > 0 for p, g in flat(g1) if "router" in p)


# ---------------------------------------------------------------------------
# the routing's gradient at one layer
# ---------------------------------------------------------------------------


def _layer_grads(tcfg, x, router, ct):
    """Gradients of ``Σ ct · moe_layer(x)`` by the MoE parameters and x,
    in both packages, the port's routing and gates alongside."""
    from test_torch_moe_serve import _moe_params, _with_router

    jcfg2, tcfg2, jpm, tpm = _moe_params(ARCH, "float32", moe=tcfg.moe)
    if router is not None:
        tpm, jpm = _with_router(tpm, jpm, router)
    xj = jnp.asarray(x)
    gj = jax.grad(lambda p, x: jnp.sum(
        JMOE.moe_layer(p, jcfg2, x) * ct), argnums=(0, 1))(jpm, xj)
    tp = {k: v.detach().clone().requires_grad_(True)
          for k, v in tpm.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    gates = []

    def keep_gates(p, cfg, xf, real=TMOE.route):
        out = real(p, cfg, xf)
        out[0].retain_grad()
        gates.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMOE, "route", keep_gates)
        y = TMOE.moe_layer(tp, tcfg2, xt)
    (y * torch.from_numpy(ct)).sum().backward()
    want = {**{k: np.asarray(v) for k, v in gj[0].items()},
            "x": np.asarray(gj[1])}
    got = {**{k: t.grad.numpy() for k, t in tp.items()},
           "x": xt.grad.numpy()}
    return got, want, gates[0]


def test_dropped_choices_get_a_zero_gate_gradient():
    """Capacity factor 0.25 at 128 tokens (8 slots an expert for 256
    choices): most (token, choice) pairs overflow their expert's buffer.
    A dropped choice is weighted 0 in the combine, so its gate's cotangent
    is exactly 0; the kept ones carry the gradient, and every gradient —
    the router's through the softmax that still couples a token's k gates
    — equals the reference's."""
    tcfg = dataclasses.replace(
        _models(ARCH, "float32")[1],
        moe=tbase.MoeConfig(8, 2, capacity_factor=0.25))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 32, 64)).astype(np.float32)
    ct = rng.standard_normal((4, 32, 64)).astype(np.float32)
    got, want, (gate_w, _, _, keep) = _layer_grads(tcfg, x, None, ct)
    assert (~keep).float().mean() > 0.5
    assert not gate_w.grad[~keep].any() and gate_w.grad[keep].abs().min() > 0
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_tied_router_logits_differentiate_as_the_reference():
    """Integer inputs and a router with identical columns made dominant:
    every token's logits tie exactly on them in both packages, the lower
    index wins in each, and the gradients (the router's tied columns
    among them) equal the reference's."""
    from test_torch_moe_serve import _integer_inputs

    tcfg = dataclasses.replace(
        _models(ARCH, "float32")[1],
        moe=tbase.MoeConfig(8, 2, capacity_factor=8.0))
    x, router = _integer_inputs(2)
    x[..., 0] = 3.0
    for c in (2, 5):
        router[:, c] = router[:, 2]
        router[0, c] = 50.0
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    got, want, (_, gate_i, _, _) = _layer_grads(tcfg, x, router, ct)
    assert (gate_i == torch.tensor([2, 5])).all()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 2)])
def test_train_steps_match_the_reference(dtype, accum):
    """Three steps on the data pipeline's batches of 4 rows (``grad_accum``
    2: two microbatches of 2, their f32 gradients summed and halved):
    loss, grad norm, lr and every parameter.  Each step first checks (f32)
    or replays (bf16) the reference's routing at the reference's own
    parameters of that step."""
    jcfg, tcfg, jp, tp = _models(ARCH, dtype)
    jstep = _ref_step(jcfg, accum)
    js, ts = JA.init(jp, _opt(JA)), TA.init(tp, _opt(TA))
    for step in range(3):
        b = _batch(tcfg.vocab_size, step)
        ref = _ref_choices(jcfg, jp, b, accum)
        if dtype == "float32":
            tstep = TS.make_train_step(tcfg, _opt(TA), grad_accum=accum)
            mbs = [{k: v[i * (4 // accum):(i + 1) * (4 // accum)]
                    for k, v in b.items()} for i in range(accum)]
            port = sum((_port_choices(tcfg, tp, mb) for mb in mbs), [])
            _assert_same_routing(port, ref, f"{ARCH} step {step + 1}")
            tp, ts, tm = tstep(tp, ts, _tb(b))
        else:
            tstep = TS.make_train_step(tcfg.with_(remat=False), _opt(TA),
                                       grad_accum=accum)
            with chip_smoke._ReplayingChoices(ref):
                tp, ts, tm = tstep(tp, ts, _tb(b))
        jp, js, jm = jstep(jp, js, _jb(b))
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


def test_moe_flops_count_the_active_parameters():
    """The model-FLOP share ``chip_smoke.py`` reports for granite counts 6
    × the *active* parameters (8 of 32 experts) a token, as the
    reference's ``model_flops_per_token`` does."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg

    tcfg, jcfg = treg.get_config(ARCH), jreg.get_config(ARCH)
    got = tbase.model_flops_per_token(tcfg, training=True)
    assert got == jbase.model_flops_per_token(jcfg, training=True)
    assert got < 6 * 0.6 * tbase.count_params(tcfg)
