"""The encoder–decoder's train path of the port (``models/encdec.py``:
``encdec_loss`` = ``encode`` → the teacher-forced ``decode_train``, its
cross-attention through ``attention_layer(kv_override=...)`` → the
streaming chunked cross-entropy; ``launch/steps.py`` dispatches it) held
against the reference on the CPU, at the smoke config of
seamless-m4t-medium (2 + 2 layers, d_model 64, 4/4 heads of 16, d_ff
128, vocab 256).

Both packages get the same parameters (``_torch_port.ref_and_port``) and
the same NumPy frames, tokens and labels.  The reference runs
**unsharded**: ``jax.value_and_grad`` of ``encdec_loss`` and
``jax.jit(make_train_step(...))`` with no mesh — its own mesh train step
fails on this jax (ROADMAP §C) — with its training attention
``"blockwise"`` against the port's default ``"cuda"`` (on a CPU tensor
the kernels' plain versions).

Tolerances are ``test_torch_lm_train.py``'s: f32 loss rtol 1e-5, every
gradient leaf and parameter atol = rtol = 1e-4; bf16 3e-2, a gradient
leaf relative to its largest value.  The pieces (``attention_layer``
with ``kv_override``, ``decode_train``) take the serving tests'
(``_torch_port``: f32 1e-4, bf16 ``BF16_TOL``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch import steps as JS
from repro.models import encdec as jed
from repro.models import layers as JL
from repro.optim import adamw as JA

from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as TS
from repro_torch.models import encdec as ted
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as TA

from _torch_port import BF16_TOL, F32_TOL, flat, ref_and_port, to_np
from test_torch_lm_train import _assert_trees, _opt

ARCH = "seamless-m4t-medium"
DTYPES = ["float32", "bfloat16"]
T, S, D = 32, 16, 64        # frames, targets, the smoke config's d_model


def _models(dtype, **kw):
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, dtype, **kw)
    return jcfg.with_(attn_impl="blockwise"), tcfg, jp, tp


def _batch(seed, rows=4, vocab=256):
    rng = np.random.default_rng(seed)
    block = rng.integers(0, vocab, (rows, S + 1), dtype=np.int32)
    return {"frames": rng.standard_normal((rows, T, D)).astype(np.float32),
            "tokens": block[:, :-1], "labels": block[:, 1:]}


def _jb(b, dtype="float32"):
    return {k: jnp.asarray(v).astype(dtype) if k == "frames"
            else jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_layer_with_kv_override_matches_the_reference(dtype):
    """Cross-attention over a whole sequence: the query alone projected,
    no RoPE (the positions change nothing), the given (k, v) returned."""
    jcfg, tcfg, jp, tp = _models(dtype)
    jpa = jax.tree.map(lambda a: a[0], jp["decoder"]["blocks"]["cross_attn"])
    tpa = tlm._layer(tp["decoder"]["blocks"], 0)["cross_attn"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    k = rng.standard_normal((2, 4, T, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4, T, 16)).astype(np.float32)
    tk, tv = (torch.from_numpy(a).to(tcfg.param_dtype) for a in (k, v))
    pos = torch.arange(S, dtype=torch.int32).expand(2, S)
    outs = []
    for shift in (0, 7):
        out, kv = TL.attention_layer(
            tpa, tcfg, torch.from_numpy(x).to(tcfg.param_dtype), pos + shift,
            causal=False, kv_override=(tk, tv))
        assert kv[0] is tk and kv[1] is tv
        outs.append(out)
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    want, (wk, _) = JL.attention_layer(
        jpa, jcfg, jnp.asarray(x).astype(dtype), jnp.asarray(pos.numpy()),
        causal=False, kv_override=(jnp.asarray(k).astype(dtype),
                                   jnp.asarray(v).astype(dtype)))
    np.testing.assert_allclose(to_np(outs[0]), to_np(want), **_tol(dtype))
    np.testing.assert_allclose(to_np(tk), to_np(wk), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_train_matches_the_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    b = _batch(2)
    memory = jed.encode(jp, jcfg, jnp.asarray(b["frames"]).astype(dtype))
    want = jed.decode_train(jp, jcfg, memory, jnp.asarray(b["tokens"]))
    tmem = torch.from_numpy(np.array(to_np(memory))).to(tcfg.param_dtype)
    got = ted.decode_train(tp, tcfg, tmem, torch.from_numpy(b["tokens"]))
    assert got.dtype == tcfg.param_dtype and got.shape == (4, S, D)
    np.testing.assert_allclose(to_np(got), to_np(want), **_tol(dtype))


def test_decode_train_is_the_token_by_token_decode():
    """The port's teacher-forced decoder and its cached decode agree on
    every position (f32, 1e-4): the two read the memory the same way."""
    _, tcfg, _, tp = _models("float32")
    b = _batch(3, rows=2)
    memory = ted.encode(tp, tcfg, torch.from_numpy(b["frames"]))
    h = ted.decode_train(tp, tcfg, memory, torch.from_numpy(b["tokens"]))
    want = (h @ tp["lm_head"]).float()
    cache = ted.init_cache(tcfg, 2, mem_len=T, max_len=S, device="cpu")
    for li in range(tcfg.dec_layers):
        ck, cv = ted._cross_kv(
            tlm._layer(tp["decoder"]["blocks"], li)["cross_attn"], tcfg,
            memory)
        cache["ck"][li], cache["cv"][li] = ck, cv
    for t in range(S):
        logits, cache = ted.encdec_decode(
            tp, tcfg, cache, torch.from_numpy(b["tokens"][:, t]), t)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(),
                                   **F32_TOL)


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------


def _ref_value_and_grad():
    return jax.jit(jax.value_and_grad(jed.encdec_loss), static_argnums=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_loss_and_every_grad_match_the_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    b = _batch(4)
    lj, gj = _ref_value_and_grad()(jp, jcfg, _jb(b, dtype))
    lt, gt = TS._value_and_grad(tcfg, tp, _tb(b))
    assert lt.dtype == torch.float32 and lt.ndim == 0
    np.testing.assert_allclose(float(lt), float(lj),
                               rtol=1e-5 if dtype == "float32" else 3e-2)
    for path, g in flat(gt):
        assert g.dtype == tcfg.param_dtype, path
    _assert_trees(gt, gj, dtype, f"encdec {dtype} grad", grads=True)


def test_model_loss_dispatches_the_encdec_family():
    jcfg, tcfg, jp, tp = _models("float32")
    b = _batch(5)
    got = TS.model_loss(tp, tcfg, _tb(b))
    assert torch.equal(got, ted.encdec_loss(tp, tcfg, _tb(b)))
    np.testing.assert_allclose(float(got), float(JS.model_loss(
        jp, jcfg, _jb(b))), rtol=1e-5)


def test_remat_on_equals_remat_off():
    """``cfg.remat`` recomputes every encoder and decoder layer in the
    backward: the same loss and gradient bits, and every attention
    layer's forward twice (2 + 2 × 2 layers: 12 forward calls with remat,
    6 without; one backward call a layer either way)."""
    _, tcfg, _, tp = _models("float32")
    b = _tb(_batch(6))
    runs = {}
    for remat in (True, False):
        calls = {"fwd": 0, "bwd": 0}
        real, real_bwd = tfa.flash_attention, tfa.flash_attention_bwd

        def fwd(*a, **kw):
            calls["fwd"] += 1
            return real(*a, **kw)

        def bwd(*a, **kw):
            calls["bwd"] += 1
            return real_bwd(*a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfa, "flash_attention", fwd)
            mp.setattr(tfa, "flash_attention_bwd", bwd)
            runs[remat] = TS._value_and_grad(tcfg.with_(remat=remat), tp, b)
        n = tcfg.enc_layers + 2 * tcfg.dec_layers
        assert calls == {"fwd": n * (2 if remat else 1), "bwd": n}, remat
    (l1, g1), (l0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


def test_the_decoder_embedding_grad_sums_repeats_in_f32(monkeypatch):
    """The decoder's tokens enter through ``lm._EmbedRows``: a repeated
    token's rows summed in f32 and rounded once, as the LM's."""
    _, tcfg, _, tp = _models("bfloat16")
    used = []
    real = tlm._EmbedRows.apply
    monkeypatch.setattr(tlm._EmbedRows, "apply",
                        lambda *a: used.append(a[1].shape) or real(*a))
    b = _batch(7)
    b["tokens"][:] = 3
    _, g = TS._value_and_grad(tcfg, tp, _tb(b))
    assert used == [(4, S)]
    assert g["embed"][3].any() and not g["embed"][:3].any()


def test_split_microbatches_splits_the_encdec_batch():
    b = _batch(8)
    want = JS._split_microbatches(_jb(b), 2)
    got = TS._split_microbatches(_tb(b), 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        assert sorted(mb) == ["frames", "labels", "tokens"]
        for name, t in mb.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(want[name][i]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_steps_match_the_reference(dtype, accum):
    """Two steps on batches of 4 rows (``grad_accum`` 2: microbatches of
    2): loss, grad norm, lr, and every parameter."""
    jcfg, tcfg, jp, tp = _models(dtype)
    jstep = jax.jit(JS.make_train_step(jcfg, _opt(JA), grad_accum=accum))
    tstep = TS.make_train_step(tcfg, _opt(TA), grad_accum=accum)
    js, ts = JA.init(jp, _opt(JA)), TA.init(tp, _opt(TA))
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for step in range(2):
        b = _batch(10 + step)
        jp, js, jm = jstep(jp, js, _jb(b, dtype))
        tp, ts, tm = tstep(tp, ts, _tb(b))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=rtol, err_msg=name)
    _assert_trees(tp, jp, dtype, f"encdec {dtype} after 2 steps",
                  grads=False)
    assert int(ts.step) == 2
