"""The encoder–decoder serving path of the port (``models/encdec.py``
through ``launch/steps.py``'s family dispatch) held against the
reference on the CPU, at the smoke config of seamless-m4t-medium (2 + 2
layers, d_model 64, 4/4 heads of 16, d_ff 128, vocab 256).

Both packages get the same parameters (the reference draws them with
``attn_impl="pallas"``, its kernel in interpret mode; they cross as
NumPy through ``lm_params_from_numpy``) and the same seeded stub frame
embeddings.  The reference runs unsharded.  ``ServeEngine.generate``
refuses this family in both packages (frames in, ``embeds_input``), so
the path is driven through the step functions, and the 1-long self
cache of the prefill is laid into the bounded one by
``ServeEngine._expand_cache``.

Tolerances: f32 atol = rtol = 1e-4 for memory, logits and every cache
leaf (sums in another order); bf16 the dense path's ``BF16_TOL`` (atol
0.08 + rtol 0.03)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch import steps as JS
from repro.models import encdec as jed
from repro.models import layers as JL

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TS
from repro_torch.models import encdec as ted
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

from _torch_port import BF16_TOL, F32_TOL, flat, ref_and_port, to_np

ARCH = "seamless-m4t-medium"
T = 16          # frames
D = 64          # the smoke config's d_model


def _frames(seed, b=2, t=T):
    return np.random.default_rng(seed).standard_normal((b, t, D)).astype(
        np.float32)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


# ---------------------------------------------------------------------------
# parameters and dispatch
# ---------------------------------------------------------------------------


def test_init_params_layout_matches_the_reference():
    """``{"encoder": {"blocks", "final_norm"}, "decoder": {...}, "embed",
    "lm_head"}``, the vocabulary unpadded, every leaf the reference's
    shape and dtype."""
    jcfg, tcfg, *_ = ref_and_port(ARCH, "bfloat16")
    shapes = jax.eval_shape(lambda: jed.init_params(jax.random.key(0), jcfg))
    tp = TS.model_init(torch.Generator().manual_seed(0), tcfg)
    flat_j, flat_t = dict(flat(shapes)), dict(flat(tp))
    assert sorted(flat_t) == sorted(flat_j)
    for name, leaf in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
        assert str(flat_t[name].dtype) == f"torch.{leaf.dtype}", name
    assert tp["lm_head"].shape[1] == tcfg.vocab_size


def test_count_params_is_the_size_of_init_params():
    tcfg = treg.get_config(ARCH, smoke=True)
    tp = TS.model_init(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for _, t in flat(tp)) == tbase.count_params(tcfg)


def test_steps_dispatch_the_encdec_family():
    """``model_init_cache`` gives the reference's shapes (``mem_len =
    max_len``); ``model_prefill`` / ``model_decode`` are the encdec entry
    points."""
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH)
    want = dict(flat(jax.eval_shape(lambda: JS.model_init_cache(jcfg, 3,
                                                                24))))
    got = dict(flat(TS.model_init_cache(tcfg, 3, 24, device="cpu")))
    assert sorted(got) == sorted(want) == ["ck", "cv", "k", "v"]
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert str(got[name].dtype) == f"torch.{leaf.dtype}", name
    assert got["k"].data_ptr() != got["v"].data_ptr()
    fr = _frames(1)
    logits, cache = TS.model_prefill(tp, tcfg,
                                     {"frames": torch.from_numpy(fr)})
    want_l, _ = ted.encdec_prefill(tp, tcfg, {"frames": torch.from_numpy(fr)})
    torch.testing.assert_close(logits, want_l, atol=0, rtol=0)
    assert cache["k"].shape[3] == 1
    tok = logits.argmax(-1).to(torch.int32)
    full = tserve.ServeEngine(tcfg, device="cpu", max_len=T,
                              params=tp)._expand_cache(cache, 2, 1)
    step, _ = TS.model_decode(tp, tcfg, full, tok, 1)
    assert step.shape == (2, tcfg.vocab_size) and step.dtype == torch.float32


def test_generate_refuses_frame_inputs_as_the_reference():
    _, tcfg, _, _, tp = ref_and_port(ARCH)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=24, params=tp)
    with pytest.raises(NotImplementedError, match="stub-frontend"):
        eng.generate(np.zeros((2, 8), np.int32), max_new=4)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_decode_matches_the_reference(dtype):
    """One query against the fixed memory: no RoPE (the position does not
    matter) and no cache write."""
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, dtype)
    jpa = jax.tree.map(lambda a: a[0], jp["decoder"]["blocks"]["cross_attn"])
    tpa = tlm._layer(tp["decoder"]["blocks"], 0)["cross_attn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    ck = rng.standard_normal((2, 4, T, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 4, T, 16)).astype(np.float32)
    tk, tv = (torch.from_numpy(a).to(tcfg.param_dtype) for a in (ck, cv))
    before = (tk.clone(), tv.clone())
    outs = [TL.attention_decode(tpa, tcfg,
                                torch.from_numpy(x).to(tcfg.param_dtype),
                                pos, tk, tv, cross=True)[0]
            for pos in (0, 5)]
    want, _, _ = JL.attention_decode(
        jpa, jcfg, jnp.asarray(x).astype(dtype), jnp.asarray(3, jnp.int32),
        jnp.asarray(ck).astype(dtype), jnp.asarray(cv).astype(dtype),
        cross=True)
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    np.testing.assert_allclose(to_np(outs[0]), to_np(want), **_tol(dtype))
    torch.testing.assert_close(tk, before[0], atol=0, rtol=0)
    torch.testing.assert_close(tv, before[1], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(dtype):
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, dtype)
    fr = _frames(3)
    got = ted.encode(tp, tcfg, torch.from_numpy(fr))
    want = jed.encode(jp, jcfg, jnp.asarray(fr))
    assert got.dtype == tcfg.param_dtype and got.shape == fr.shape
    np.testing.assert_allclose(to_np(got), to_np(want), **_tol(dtype))


def test_the_encoder_attends_without_a_mask_through_the_kernel(monkeypatch):
    """Prefill calls the flash-attention wrapper (one kernel launch on the
    card) once per encoder layer, non-causal; the decoder's self and
    cross attention take the cache path, in prefill and decode."""
    _, tcfg, _, _, tp = ref_and_port(ARCH)
    calls = []
    real = tfa.flash_attention

    def counting(*a, **k):
        calls.append((tuple(a[0].shape), k["causal"]))
        return real(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention", counting)
    logits, cache = TS.model_prefill(
        tp, tcfg, {"frames": torch.from_numpy(_frames(4))})
    assert calls == [((2 * tcfg.num_heads, T, 16), False)] * tcfg.enc_layers
    full = tserve.ServeEngine(tcfg, device="cpu", max_len=T,
                              params=tp)._expand_cache(cache, 2, 1)
    TS.model_decode(tp, tcfg, full, logits.argmax(-1), 1)
    assert len(calls) == tcfg.enc_layers


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _prefill_decode(dtype, steps=6):
    """Prefill both packages on the same frames, lay the 1-long self cache
    into one of ``T`` positions (``_expand_cache`` in the port, the
    reference's zero padding in JAX), then ``steps`` greedy decode steps
    fed the reference's tokens."""
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, dtype)
    fr = _frames(5)
    j_prefill = jax.jit(JS.model_prefill, static_argnums=1)
    j_decode = jax.jit(JS.model_decode, static_argnums=1)
    jl, jc = j_prefill(jp, jcfg, {"frames": jnp.asarray(fr)})
    tl, tc = TS.model_prefill(tp, tcfg, {"frames": torch.from_numpy(fr)})
    rows = [("prefill logits", to_np(tl), to_np(jl))]
    rows += [(f"prefill {k}", to_np(tc[k]), to_np(jc[k]))
             for k in ("ck", "cv", "k", "v")]
    tcache = tserve.ServeEngine(tcfg, device="cpu", max_len=T,
                                params=tp)._expand_cache(tc, 2, 1)
    jcache = dict(jc)
    for k in ("k", "v"):
        jcache[k] = jnp.pad(jc[k], [(0, 0)] * 3 + [(0, T - 1), (0, 0)])
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(1, steps + 1):
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(tok),
                              jnp.asarray(i, jnp.int32))
        tl, tc2 = TS.model_decode(tp, tcfg, tcache, torch.from_numpy(tok), i)
        assert tc2 is tcache                     # updated in place
        rows.append((f"decode {i} logits", to_np(tl), to_np(jl)))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    rows += [(f"decode {k}", to_np(tcache[k]), to_np(jcache[k]))
             for k in ("ck", "cv", "k", "v")]
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_six_decode_steps(dtype):
    for what, got, want in _prefill_decode(dtype):
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, err_msg=what, **_tol(dtype))


def test_decode_matches_the_reference_teacher_forced_decoder():
    """The cache contract of ``tests/test_models.py::
    TestPrefillDecodeConsistency::test_encdec_decode_matches_teacher_forced``
    across the packages: the port's token-by-token decode against the
    reference's teacher-forced ``decode_train`` (the port's own is held to
    it in ``test_torch_encdec_train.py``), in f32 at 1e-4."""
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH)
    fr = _frames(6)
    toks = np.random.default_rng(7).integers(0, 256, (2, 8), dtype=np.int32)
    memory = jed.encode(jp, jcfg, jnp.asarray(fr))
    h = jed.decode_train(jp, jcfg, memory, jnp.asarray(toks))
    want = to_np((h[:, -1] @ jp["lm_head"]).astype(jnp.float32))

    tmem = ted.encode(tp, tcfg, torch.from_numpy(fr))
    cache = ted.init_cache(tcfg, 2, mem_len=T, max_len=8, device="cpu")
    for li in range(tcfg.dec_layers):
        ck, cv = ted._cross_kv(
            tlm._layer(tp["decoder"]["blocks"], li)["cross_attn"], tcfg, tmem)
        cache["ck"][li], cache["cv"][li] = ck, cv
    for t in range(8):
        logits, cache = ted.encdec_decode(tp, tcfg, cache,
                                          torch.from_numpy(toks[:, t]), t)
    np.testing.assert_allclose(logits.numpy(), want, **F32_TOL)
