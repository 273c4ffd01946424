"""The dense family's train path of the port (``lm_loss`` → autograd →
gradient accumulation → AdamW, ``launch.steps.make_train_step``) held
against the reference on the CPU, at the smoke configs of llama3.2-1b
and qwen2-0.5b (2 layers, d_model 64; qwen2 has QKV biases and tied
embeddings) in f32 and bf16, on batches of the data pipeline.

Both packages get the same parameters (the reference draws them; they
cross as NumPy).  The reference runs **unsharded**: ``jax.value_and_grad``
of ``lm.lm_loss`` and ``jax.jit(make_train_step(...))`` with no mesh — its
own mesh train step fails on this jax (ROADMAP §C,
``test_sharding.py::TestMultiDeviceParity``) — with its training
attention, ``"blockwise"`` (the streaming custom VJP), against the port's
default ``"cuda"`` (``FlashAttention``: on a CPU tensor the forward and
backward kernels' plain versions).

Tolerances.  f32: loss rtol 1e-5, every gradient leaf and every
parameter after AdamW steps atol = rtol = 1e-4 (sums in another order).
bf16: the reference's ``test_models.py`` 3e-2 — for a gradient leaf
taken relative to the leaf's largest value (gradients are small, so a
bare atol of 3e-2 would hold nothing): |err| ≤ 3e-2·max|ref| +
3e-2·|ref|; for parameters as the reference states it, atol = rtol =
3e-2.  At bf16 a parameter element whose gradient lies within the
rounding noise of both packages takes Adam's first steps of ±lr in
either direction (the zero-initialised QKV biases show it), so the bf16
parameters are held only that far; the update itself is held to one
bf16 step on equal gradients in ``test_torch_optim.py``.  The steps use
AdamWConfig's own lr (3e-4) after one warmup step: in f32 too Adam turns
a gradient element near ``eps`` (1e-8; one wk element of llama's smoke
gradient is 8e-9) into a step that rests on the gradient's last digits,
a share of lr, well inside 1e-4 at that lr."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.models import lm as jlm
from repro.optim import adamw as JA

from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as TS
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as TA

from _torch_port import flat, ref_and_port, to_np

ARCHS = ["llama3.2-1b", "qwen2-0.5b"]
DTYPES = ["float32", "bfloat16"]


def _batch(vocab: int, step: int = 0, rows: int = 4, seq: int = 32):
    """A batch of the data pipeline, as NumPy."""
    return JP.lm_batch(JP.DataConfig(seed=3, vocab_size=vocab, seq_len=seq,
                                     global_batch=rows), step)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _models(arch, dtype, **kw):
    jcfg, tcfg, jp, npp, tp = ref_and_port(arch, dtype, **kw)
    return jcfg.with_(attn_impl="blockwise"), tcfg, jp, tp


def _assert_close(got, want, dtype, what, *, of_max: bool):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=what)
    else:
        atol = 3e-2 * float(np.abs(want).max()) if of_max else 3e-2
        np.testing.assert_allclose(got, want, atol=atol, rtol=3e-2,
                                   err_msg=what)


def _assert_trees(got, want, dtype, what, *, grads: bool):
    """Every leaf of ``got`` against ``want``'s; gradients (``grads``) in
    bf16 relative to each leaf's largest value."""
    fw = dict(flat(jax.tree.map(to_np, want)))
    fg = dict(flat(got))
    assert set(fg) == set(fw), what
    for path, w in fw.items():
        _assert_close(to_np(fg[path]), w, dtype, f"{what} {path}",
                      of_max=grads)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(jlm.lm_loss), static_argnums=1)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_grad_match_the_reference(arch, dtype):
    jcfg, tcfg, jp, tp = _models(arch, dtype)
    b = _batch(tcfg.vocab_size)
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, _jb(b))
    lt, gt = TS._value_and_grad(tcfg, tp, _tb(b))
    assert lt.dtype == torch.float32 and lt.ndim == 0
    if dtype == "float32":
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    else:
        np.testing.assert_allclose(float(lt), float(lj), rtol=3e-2)
    for path, g in flat(gt):
        assert g.dtype == tcfg.param_dtype or path.endswith(("a_log",)), path
    _assert_trees(gt, gj, dtype, f"{arch} {dtype} grad", grads=True)


def test_vlm_loss_and_grads_match_the_reference():
    """qwen2-vl (family vlm): stub embeddings in, M-RoPE positions, from
    the data pipeline's ``batch_for_model``."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs.base import SHAPES as TSHAPES
    from repro_torch.data import pipeline as TP

    jcfg, tcfg, jp, tp = _models("qwen2-vl-72b", "float32")
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=16,
                                 global_batch=2)
    tshape = dataclasses.replace(TSHAPES["train_4k"], seq_len=16,
                                 global_batch=2)
    jb = JP.batch_for_model(jcfg, jshape, JP.DataConfig(seed=1), 0)
    tb = TP.batch_for_model(tcfg, tshape, TP.DataConfig(seed=1), 0,
                            device="cpu")
    assert "mrope_positions" in tb and "embeds" in tb
    lj, gj = _ref_value_and_grad(jcfg)(jp, jcfg, jb)
    lt, gt = TS._value_and_grad(tcfg, tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    _assert_trees(gt, gj, "float32", "qwen2-vl grad", grads=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_remat_off(arch):
    """``cfg.remat`` recomputes each superblock in the backward: the same
    loss and the same gradient bits, and on the card one more forward
    launch of the attention kernel per layer (counted here on the
    wrapper: 2 × layers forward calls with remat, 1 × without; one
    backward call a layer either way)."""
    _, tcfg, _, tp = _models(arch, "float32")
    b = _tb(_batch(tcfg.vocab_size))
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
        n = tcfg.num_layers
        assert calls == {"fwd": n * (2 if remat else 1), "bwd": n}, remat
    (l1, g1), (l0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for (path, a), (_, c) in zip(flat(g1), flat(g0)):
        assert torch.equal(a, c), path


def test_blockwise_and_cuda_train_paths_agree():
    """The port's two training attentions — ``"blockwise"`` (streaming
    Function) and ``"cuda"`` (the kernels' plain versions) — give the same
    gradients (every row sees a key: the conventions agree)."""
    _, tcfg, _, tp = _models("llama3.2-1b", "float32")
    b = _tb(_batch(tcfg.vocab_size))
    la, ga = TS._value_and_grad(tcfg, tp, b)
    lb, gb = TS._value_and_grad(tcfg.with_(attn_impl="blockwise"), tp, b)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    for (path, a), (_, c) in zip(flat(ga), flat(gb)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=path)


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_ce_matches_the_reference(chunk, streaming):
    """The reference's own CE tolerances (``test_layers.py``): loss rtol
    1e-6, grads atol = rtol = 1e-5."""
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 32)).astype(np.int32)
    lj, gj = jax.value_and_grad(
        lambda h, w: jlm.chunked_ce_loss(h, w, jnp.asarray(labels), chunk,
                                         streaming), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    lt = tlm.chunked_ce_loss(th, tw, torch.from_numpy(labels), chunk,
                             streaming_bwd=streaming)
    gt = torch.autograd.grad(lt, (th, tw))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for g, w_ in zip(gt, gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("streaming", [True, False])
def test_padded_vocab_columns_never_win(streaming):
    """Columns past ``valid_vocab`` are masked to -1e30 in both packages:
    the loss and grads equal the reference's, and the padded columns get
    no gradient."""
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((8, 24)) * 0.5).astype(np.float32)
    w[:, 20:] = 5.0                    # padded columns that would win
    labels = rng.integers(0, 20, (2, 16)).astype(np.int32)
    lj, gj = jax.value_and_grad(
        lambda h, w: jlm.chunked_ce_loss(h, w, jnp.asarray(labels), 8,
                                         streaming, valid_vocab=20),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    lt = tlm.chunked_ce_loss(th, tw, torch.from_numpy(labels), 8,
                             streaming_bwd=streaming, valid_vocab=20)
    gt = torch.autograd.grad(lt, (th, tw))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for g, w_ in zip(gt, gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                   rtol=1e-5)
    assert not gt[1][:, 20:].any()


def test_chunk_must_divide_the_sequence():
    with pytest.raises(ValueError, match="does not divide"):
        tlm.chunked_ce_loss(torch.zeros(1, 12, 4), torch.zeros(4, 8),
                            torch.zeros(1, 12, dtype=torch.int32), 5)


def test_embedding_grad_sums_repeats_in_f32():
    """The data pipeline's Zipf draw repeats token 0 thousands of times a
    batch.  The port sums an embedding row's repeats in f32 and rounds
    once to bf16 — exactly the f32 sum rounded; a sum in bf16 (the
    reference's ``params["embed"][tokens]`` cotangent) rounds at every
    add and drifts."""
    table = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.zeros(3000, dtype=torch.long)
    g = torch.full((3000, 8), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    out = tlm._EmbedRows.apply(table, idx)
    (grad,) = torch.autograd.grad(out, table, g)
    exact = torch.tensor(3000 * (1.0 + 2 ** -7)).to(torch.bfloat16)
    assert torch.equal(grad[0], exact.expand(8)) and not grad[1:].any()
    naive = torch.zeros((), dtype=torch.bfloat16)
    for _ in range(3000):
        naive = naive + torch.tensor(1.0 + 2 ** -7, dtype=torch.bfloat16)
    assert not torch.equal(naive, exact)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_step(jcfg, accum: int):
    return jax.jit(JS.make_train_step(jcfg, _opt(JA), grad_accum=accum))


def _opt(mod):
    return mod.AdamWConfig(warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch, dtype, accum):
    """One and three steps on the data pipeline's batches of 4 rows
    (``grad_accum`` 2: two microbatches of 2, their f32 gradients summed
    and halved): loss, grad norm, lr, and every parameter."""
    jcfg, tcfg, jp, tp = _models(arch, dtype)
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
            _assert_trees(tp, jp, dtype, f"{arch} {dtype} step {step + 1}",
                          grads=False)
    assert int(ts.step) == 3


def test_split_microbatches_matches_the_reference():
    rng = np.random.default_rng(0)
    batch = {"embeds": rng.standard_normal((4, 6, 8)).astype(np.float32),
             "labels": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "mrope_positions": rng.integers(0, 6, (3, 4, 6)).astype(
                 np.int32)}
    want = JS._split_microbatches(_jb(batch), 2)
    got = TS._split_microbatches(_tb(batch), 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        for name, t in mb.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(want[name][i]))
    with pytest.raises(ValueError, match="microbatches"):
        TS._split_microbatches(_tb(batch), 3)


def test_a_step_leaves_its_state_and_repeats_bit_for_bit():
    _, tcfg, _, tp = _models("qwen2-0.5b", "bfloat16")
    step = TS.make_train_step(tcfg, _opt(TA), grad_accum=2)
    st = TA.init(tp, _opt(TA))
    b = _tb(_batch(tcfg.vocab_size))
    before = {p: t.clone() for p, t in flat(tp)}
    p1, s1, m1 = step(tp, st, b)
    p2, s2, m2 = step(tp, st, b)
    assert all(torch.equal(t, before[p]) for p, t in flat(tp))
    assert int(st.step) == 0
    assert torch.equal(m1["loss"], m2["loss"])
    for (path, a), (_, c) in zip(flat(p1), flat(p2)):
        assert torch.equal(a, c), path


def _smoke_batch(cfg, rows: int = 2, seq: int = 16) -> dict:
    """A batch of ``cfg``'s family on the CPU: the data pipeline's, or for
    the encoder–decoder seeded frames and the pipeline's tokens."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.data import pipeline as TP

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=rows)
    if cfg.family != "encdec":
        return TP.batch_for_model(cfg, shape, TP.DataConfig(seed=2), 0,
                                  device="cpu")
    toks = _tb(_batch(cfg.vocab_size, rows=rows, seq=seq))
    frames = np.random.default_rng(2).standard_normal(
        (rows, seq, cfg.d_model)).astype(np.float32)
    return {"frames": torch.from_numpy(frames), **toks}


@pytest.mark.parametrize("arch", treg.all_archs())
def test_every_config_trains(arch):
    """Every family trains: for each of the ten configs' smoke versions
    ``make_train_step`` builds, and one step (two microbatches) gives a
    finite loss and leaves every parameter and moment finite and of its
    dtype."""
    cfg = treg.get_config(arch, smoke=True)
    params = TS.model_init(torch.Generator().manual_seed(0), cfg)
    state = TA.init(params, _opt(TA))
    step = TS.make_train_step(cfg, _opt(TA), grad_accum=2)
    new_p, new_s, m = step(params, state, _smoke_batch(cfg))
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    for (path, p), (_, q) in zip(flat(new_p), flat(params)):
        assert p.dtype == q.dtype and bool(torch.isfinite(p).all()), path
    for path, t in flat({"mu": new_s.mu, "nu": new_s.nu}):
        assert bool(torch.isfinite(t).all()), path
    assert any(not torch.equal(p, q)
               for (_, p), (_, q) in zip(flat(new_p), flat(params)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_autograd_on_the_card():
    """A kernel output leaves autograd: B1 (conv) raises on CUDA tensors
    that require grad, and runs without grad.  B3 (fused MLP) and B4 (SSD)
    have their backward kernels: under autograd on the card they go
    through ``FusedMlp`` and ``SsdScan``, and their gradients match the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = "cuda"
    x = torch.randn(1, 8, 8, 4, device=dev, requires_grad=True)
    w = torch.randn(3, 3, 4, 8, device=dev)
    with pytest.raises(NotImplementedError, match="conv2d_stream"):
        tops.conv2d_stream(x, w)
    with torch.no_grad():
        tops.conv2d_stream(x, w)
    g = torch.Generator().manual_seed(0)
    mlp = [torch.randn(16, 64, generator=g),
           torch.randn(64, 128, generator=g) * 0.1,
           torch.randn(64, 128, generator=g) * 0.1,
           torch.randn(128, 64, generator=g) * 0.1]
    grads = {}
    for d in ("cpu", dev):
        leaves = [t.to(d).requires_grad_(True) for t in mlp]
        out = tops.fused_mlp(*leaves)
        assert type(out.grad_fn.next_functions[0][0]).__name__ == \
            "FusedMlpBackward"
        out.sum().backward()
        grads[d] = [t.grad.cpu() for t in leaves]
    for c, k in zip(grads["cpu"], grads[dev]):
        torch.testing.assert_close(k, c, atol=5e-4, rtol=5e-4)
    ins = [torch.randn(1, 16, 2, 8, generator=g),
           torch.rand(1, 16, 2, generator=g), -torch.rand(2, generator=g),
           torch.randn(1, 16, 4, generator=g),
           torch.randn(1, 16, 4, generator=g)]
    grads = {}
    for d in ("cpu", dev):
        leaves = [t.to(d).requires_grad_(True) for t in ins]
        y, _ = tops.mamba2_ssd(*leaves)
        assert type(y.grad_fn).__name__ == "SsdScanBackward"
        y.sum().backward()
        grads[d] = [t.grad.cpu() for t in leaves]
    for c, k in zip(grads["cpu"], grads[dev]):
        torch.testing.assert_close(k, c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_a_train_step_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, tcfg, _, tp = _models("llama3.2-1b", "float32")
    b = _batch(tcfg.vocab_size)
    step = TS.make_train_step(tcfg, _opt(TA))
    pc, _, mc = step(tp, TA.init(tp, _opt(TA)), _tb(b))
    tg = TA.tree_map(lambda t: t.cuda(), tp)
    pg, _, mg = step(tg, TA.init(tg, _opt(TA)),
                     {k: v.cuda() for k, v in _tb(b).items()})
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    for (path, a), (_, c) in zip(flat(pg), flat(pc)):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=path)
