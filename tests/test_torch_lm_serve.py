"""The LM serving path of the port (configs → layers → ``lm_prefill`` /
``lm_decode`` → ``ServeEngine.generate``) held against the reference on
the CPU, at the smoke configs of llama3.2-1b, qwen2-0.5b, yi-9b and
nemotron-4-15b (2 layers, d_model 64; qwen2 has QKV biases and tied
embeddings, nemotron the ungated squared-ReLU MLP), and qwen2-vl-72b's
M-RoPE backbone on embeddings.

Both packages get the same parameters: the reference draws them, they
cross as NumPy through ``lm_params_from_numpy``.  The reference runs
unsharded (``lm.lm_prefill`` / ``lm.lm_decode`` with no mesh: its own
``ServeEngine`` tests fail under the mesh on this jax), with
``attn_impl="pallas"`` (the Pallas kernel in interpret mode) against the
port's ``"cuda"`` (the kernel's plain version on a CPU tensor).

Tolerances: f32 atol = rtol = 1e-4 for logits and caches (sums in
another order); bf16 atol 0.08 + rtol 0.03 — a few bf16 steps at
|logit| ≤ 4, since the two frameworks round some elementwise chains at
other places (``silu`` is one op here, two in JAX)."""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import lm as jlm

import repro_torch
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

import chip_smoke
from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)

ARCHS = ["llama3.2-1b", "qwen2-0.5b", "yi-9b", "nemotron-4-15b"]
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.08, rtol=0.03)


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str = "float32"):
    """(reference cfg, port cfg, reference params, NumPy params, port
    params) of the smoke config."""
    jcfg = jreg.get_config(arch, smoke=True).with_(dtype=dtype,
                                                   attn_impl="pallas")
    tcfg = treg.get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jlm.init_params(jax.random.key(0), jcfg)
    npp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jcfg, tcfg, jp, npp, tlm.lm_params_from_numpy(npp, tcfg,
                                                         device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """The reference's prefill and decode, compiled once per config."""
    return (jax.jit(jlm.lm_prefill, static_argnums=1),
            jax.jit(jlm.lm_decode, static_argnums=1))


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jreg.all_archs())
def test_config_copies_equal_the_reference(arch, smoke):
    j = jreg.get_config(arch, smoke=smoke)
    t = treg.get_config(arch, smoke=smoke)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.pop("attn_impl") == "blockwise" and td.pop("attn_impl") == "cuda"
    assert jd == td
    assert str(t.param_dtype) == f"torch.{j.param_dtype}"
    assert t.padded_vocab == j.padded_vocab
    assert t.resolved_head_dim == j.resolved_head_dim


def test_registry_lists_the_same_archs():
    assert treg.all_archs() == jreg.all_archs()
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = TL.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    want = JL.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    assert got.dtype == tdt
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(
        atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    c1, s1 = TL.rope_cos_sin(torch.from_numpy(pos), 64, theta)
    c2, s2 = JL.rope_cos_sin(jnp.asarray(pos), 64, theta)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), atol=2e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), atol=2e-5)
    x = rng.standard_normal((2, 3, 7, 64)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        got = TL.apply_rope(torch.from_numpy(x).to(getattr(torch, dt)), c1, s1)
        want = JL.apply_rope(jnp.asarray(x, dt), c2, s2)
        tol = 1e-4 if dt == "float32" else 2e-2
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_mrope():
    """Sections (4, 2, 2) of a 16-wide head, each with its own position
    stream — and text-only streams equal plain RoPE."""
    rng = np.random.default_rng(2)
    mpos = rng.integers(0, 64, (3, 2, 5)).astype(np.int32)
    c1, s1 = TL.rope_cos_sin(torch.from_numpy(mpos[0]),
                             16, 1e6, (4, 2, 2), torch.from_numpy(mpos))
    c2, s2 = JL.rope_cos_sin(jnp.asarray(mpos[0]), 16, 1e6, (4, 2, 2),
                             jnp.asarray(mpos))
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), atol=2e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), atol=2e-5)
    same = np.broadcast_to(mpos[0], (3, 2, 5))
    c3, s3 = TL.rope_cos_sin(torch.from_numpy(mpos[0]), 16, 1e6, (4, 2, 2),
                             torch.from_numpy(np.ascontiguousarray(same)))
    c4, s4 = TL.rope_cos_sin(torch.from_numpy(mpos[0]), 16, 1e6)
    torch.testing.assert_close(c3, c4)
    torch.testing.assert_close(s3, s4)
    with pytest.raises(ValueError, match="cover"):
        TL.rope_cos_sin(torch.from_numpy(mpos[0]), 16, 1e6, (4, 2, 1),
                        torch.from_numpy(mpos))


@pytest.mark.parametrize("impl", ["cuda", "blockwise", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_layer(arch, impl):
    jcfg, tcfg, jp, npp, tp = _models(arch)
    jimpl = {"cuda": "pallas"}.get(impl, impl)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jp0, tp0 = _layer0(jp["blocks"]["b0"]), _layer0(tp["blocks"]["b0"])
    got, (tk, tv) = TL.attention_layer(
        tp0["attn"], tcfg.with_(attn_impl=impl), torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(pos)))
    want, (jk, jv) = JL.attention_layer(
        jp0["attn"], jcfg.with_(attn_impl=jimpl), jnp.asarray(x),
        jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **F32_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **F32_TOL)


def test_attention_layer_raises_on_blocks_the_reference_refuses():
    """The config's 16-row blocks clamp to Sq and must divide it: a
    24-token prompt raises in both packages with the "cuda"/"pallas"
    implementation (blockwise shrinks its blocks instead)."""
    jcfg, tcfg, jp, npp, tp = _models("llama3.2-1b")
    x = np.zeros((1, 24, 64), np.float32)
    pos = np.arange(24, dtype=np.int32)[None]
    jp0, tp0 = _layer0(jp["blocks"]["b0"]), _layer0(tp["blocks"]["b0"])
    with pytest.raises(AssertionError):
        JL.attention_layer(jp0["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos))
    with pytest.raises(ValueError):
        TL.attention_layer(tp0["attn"], tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    out, _ = TL.attention_layer(tp0["attn"], tcfg.with_(attn_impl="blockwise"),
                                torch.from_numpy(x), torch.from_numpy(pos))
    assert out.shape == (1, 24, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode(arch):
    jcfg, tcfg, jp, npp, tp = _models(arch)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    jp0, tp0 = _layer0(jp["blocks"]["b0"]), _layer0(tp["blocks"]["b0"])
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, tk2, tv2 = TL.attention_decode(tp0["attn"], tcfg,
                                        torch.from_numpy(x), 7, tk, tv)
    want, jk2, jv2 = JL.attention_decode(jp0["attn"], jcfg, jnp.asarray(x),
                                         jnp.asarray(7, jnp.int32),
                                         jnp.asarray(kc), jnp.asarray(vc))
    assert tk2 is tk and tv2 is tv            # updated in place
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(tk2), _np(jk2), **F32_TOL)
    np.testing.assert_allclose(_np(tv2), _np(jv2), **F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "squared_relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_dense_and_streamed(act, gated):
    jcfg, tcfg, jp, npp, tp = _models("llama3.2-1b")
    jcfg = jcfg.with_(act=act, gated_mlp=gated)
    tcfg = tcfg.with_(act=act, gated_mlp=gated)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jm, tm = _layer0(jp["blocks"]["b0"])["mlp"], _layer0(tp["blocks"]["b0"])["mlp"]
    dense = TL.mlp_layer(tm, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(
        _np(dense), _np(JL.mlp_layer(jm, jcfg, jnp.asarray(x))), **F32_TOL)
    streamed = TL.mlp_layer(tm, tcfg.with_(mlp_impl="streamed"),
                            torch.from_numpy(x))
    np.testing.assert_allclose(_np(streamed), _np(dense), **F32_TOL)
    tiles = TL._mlp_streamed(tm, tcfg, torch.from_numpy(x), block_f=32)
    want = JL._mlp_streamed(jm, jcfg, jnp.asarray(x), block_f=32)
    np.testing.assert_allclose(_np(tiles), _np(want), **F32_TOL)
    with pytest.raises(ValueError, match="block_f"):
        TL._mlp_streamed(tm, tcfg, torch.from_numpy(x), block_f=48)


# ---------------------------------------------------------------------------
# the model: prefill, decode, init
# ---------------------------------------------------------------------------


def _prefill_decode(arch, dtype, steps=8):
    jcfg, tcfg, jp, npp, tp = _models(arch, dtype)
    j_prefill, j_decode = _jitted(jcfg)
    toks = _tokens(6, 2, 32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    rows = [(_np(tl), _np(jl))]
    rows += [(_np(tc["b0"][kv]), _np(jc["b0"][kv])) for kv in ("k", "v")]
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, steps), (0, 0)]), jc)
    tcache = tlm.init_cache(tcfg, 2, 32 + steps, device="cpu")
    for kv in ("k", "v"):
        tcache["b0"][kv][:, :, :, :32] = tc["b0"][kv]
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(steps):
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(tok),
                              jnp.asarray(32 + i, jnp.int32))
        tl, tcache2 = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(tok),
                                    32 + i)
        assert tcache2 is tcache              # updated in place
        rows.append((_np(tl), _np(jl)))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    rows += [(_np(tcache["b0"][kv]), _np(jcache["b0"][kv]))
             for kv in ("k", "v")]
    return rows


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_eight_decode_steps_f32(arch):
    for got, want in _prefill_decode(arch, "float32"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_eight_decode_steps_bf16(arch):
    for got, want in _prefill_decode(arch, "bfloat16"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **BF16_TOL)


def test_vlm_prefill_with_mrope():
    """The M-RoPE backbone (qwen2-vl smoke: embeddings in, (3, B, S)
    position streams) through the same prefill."""
    jcfg = jreg.get_config("qwen2-vl-72b", smoke=True).with_(
        dtype="float32", attn_impl="pallas")
    tcfg = treg.get_config("qwen2-vl-72b", smoke=True).with_(dtype="float32")
    jp = jlm.init_params(jax.random.key(1), jcfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mpos = rng.integers(0, 16, (3, 2, 16)).astype(np.int32)
    jl, _ = jlm.lm_prefill(jp, jcfg, {"embeds": jnp.asarray(emb),
                                      "mrope_positions": jnp.asarray(mpos)})
    tl, _ = tlm.lm_prefill(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                      "mrope_positions": torch.from_numpy(mpos)})
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)


def test_vlm_prefill_then_four_decode_steps_on_embeddings():
    """qwen2-vl smoke with no mesh, in f32: a prefill of embeddings with
    (3, B, S) M-RoPE streams laid out as ``chip_smoke.vlm_serve`` lays
    them (text, an image's (t, h, w) grid, text), then four decode steps,
    each fed a (B, 1, D) embedding, against the reference's unsharded
    ``lm_prefill`` / ``lm_decode``: logits at every step and the caches
    after the last."""
    jcfg = jreg.get_config("qwen2-vl-72b", smoke=True).with_(
        dtype="float32", attn_impl="pallas")
    tcfg = treg.get_config("qwen2-vl-72b", smoke=True).with_(dtype="float32")
    j_prefill, j_decode = _jitted(jcfg)
    jp = jlm.init_params(jax.random.key(2), jcfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    rng = np.random.default_rng(12)
    b, s, steps = 2, 64, 4
    emb = rng.standard_normal((b, s, 64)).astype(np.float32)
    mpos = chip_smoke.mrope_streams(rng, b, s, grid=(4, 6))
    jl, jc = j_prefill(jp, jcfg, {"embeds": jnp.asarray(emb),
                                  "mrope_positions": jnp.asarray(mpos)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {
        "embeds": torch.from_numpy(emb),
        "mrope_positions": torch.from_numpy(mpos.copy())})
    rows = [(_np(tl), _np(jl))]
    rows += [(_np(tc["b0"][kv]), _np(jc["b0"][kv])) for kv in ("k", "v")]
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, steps), (0, 0)]), jc)
    tcache = tlm.init_cache(tcfg, b, s + steps, device="cpu")
    for kv in ("k", "v"):
        tcache["b0"][kv][:, :, :, :s] = tc["b0"][kv]
    for i in range(steps):
        e = rng.standard_normal((b, 1, 64)).astype(np.float32)
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(e),
                              jnp.asarray(s + i, jnp.int32))
        tl, _ = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(e), s + i)
        rows.append((_np(tl), _np(jl)))
    rows += [(_np(tcache["b0"][kv]), _np(jcache["b0"][kv]))
             for kv in ("k", "v")]
    assert rows[0][0].shape == (b, tcfg.vocab_size)
    for got, want in rows:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_mrope_streams_lay_out_text_an_image_and_text():
    """``chip_smoke.mrope_streams``: text alike on the three axes, the
    image's patches at (p, p + row, p + column), the text after it from
    p + max(grid), each row's text length drawn from the generator."""
    gh, gw = 3, 5
    got = chip_smoke.mrope_streams(np.random.default_rng(1), 4, 60,
                                   grid=(gh, gw))
    assert got.shape == (3, 4, 60) and got.dtype == np.int32
    starts = set()
    for b in range(4):
        t, h, w = got[:, b]
        # the patch after the first is the first t off the text's count
        p = int(np.argmax(t != np.arange(60))) - 1
        starts.add(p)
        np.testing.assert_array_equal(got[:, b, :p],
                                      np.broadcast_to(np.arange(p), (3, p)))
        img = slice(p, p + gh * gw)
        np.testing.assert_array_equal(t[img], p)
        np.testing.assert_array_equal(h[img], p + np.arange(gh * gw) // gw)
        np.testing.assert_array_equal(w[img], p + np.arange(gh * gw) % gw)
        rest = 60 - p - gh * gw
        np.testing.assert_array_equal(
            got[:, b, p + gh * gw:],
            np.broadcast_to(p + max(gh, gw) + np.arange(rest), (3, rest)))
    assert len(starts) > 1
    np.testing.assert_array_equal(
        got, chip_smoke.mrope_streams(np.random.default_rng(1), 4, 60,
                                      grid=(gh, gw)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_the_reference(arch):
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = treg.get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    tp = tlm.init_params(gen, tcfg)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    flat_t = dict(walk(tp))
    assert sorted(flat_t) == sorted(flat_j)
    for name, leaf in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
        assert flat_t[name].dtype == torch.bfloat16, name
    assert ("lm_head" in flat_t) == (not tcfg.tie_embeddings)


def test_prefill_launches_the_attention_kernel_once_per_layer(monkeypatch):
    """On the card each layer's attention is one kernel launch: count the
    wrapper's calls on the CPU."""
    jcfg, tcfg, jp, npp, tp = _models("qwen2-0.5b")
    calls = []
    real = tfa.flash_attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention", counting)
    tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(_tokens(8, 2, 16))})
    assert calls == [(2 * 4, 16, 16)] * tcfg.num_layers


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _reference_greedy(jcfg, jp, prompts, max_new, max_len):
    j_prefill, j_decode = _jitted(jcfg)
    logits, caches = j_prefill(jp, jcfg, {"tokens": jnp.asarray(prompts)})
    plen = prompts.shape[1]
    cache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, max_len - plen), (0, 0)]),
        caches)
    out = np.zeros((prompts.shape[0], max_new), np.int32)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out[:, 0] = np.asarray(tok)
    for i in range(1, max_new):
        logits, cache = j_decode(jp, jcfg, cache, tok,
                                 jnp.asarray(plen + i - 1, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[:, i] = np.asarray(tok)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch):
    jcfg, tcfg, jp, npp, tp = _models(arch)
    prompts = _tokens(9, 3, 16)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=32, params=tp)
    out, stats = eng.generate(prompts, max_new=8)
    assert out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(
        out, _reference_greedy(jcfg, jp, prompts, 8, 32))
    assert stats.tokens_out == 24 and stats.tokens_per_s > 0
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_sampling_is_seeded():
    _, tcfg, _, _, tp = _models("llama3.2-1b")
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=24, params=tp)
    prompts = _tokens(10, 2, 16)
    a, _ = eng.generate(prompts, max_new=8, temperature=1.0, seed=3)
    b, _ = eng.generate(prompts, max_new=8, temperature=1.0, seed=3)
    c, _ = eng.generate(prompts, max_new=8, temperature=1.0, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tcfg.vocab_size


def test_engine_draws_its_own_params_from_a_seed():
    tcfg = treg.get_config("qwen2-0.5b", smoke=True)
    e1 = tserve.ServeEngine(tcfg, device="cpu", seed=1, max_len=24)
    e2 = tserve.ServeEngine(tcfg, device="cpu", seed=1, max_len=24)
    prompts = _tokens(11, 2, 16)
    np.testing.assert_array_equal(e1.generate(prompts, max_new=4)[0],
                                  e2.generate(prompts, max_new=4)[0])
    with pytest.raises(ValueError, match="max_len"):
        e1.generate(prompts, max_new=9)


def test_what_is_not_ported_raises():
    """Int8 weights are ported (``test_torch_quant.py``): every family's
    engine takes them and holds int8 leaves, and the shardings of the
    quantized tree come with the device mesh (``test_torch_sharding.py``
    holds them against the reference's).  What still raises: frames in
    ``generate``, which refuses them as the reference's does, with int8
    weights too."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.quant import ptq

    cpu = dict(device="cpu", max_len=24)
    for arch in ("llama3.2-1b", "olmoe-1b-7b", "jamba-1.5-large-398b",
                 "seamless-m4t-medium"):
        eng = tserve.ServeEngine(treg.get_config(arch, smoke=True),
                                 int8_weights=True, **cpu)
        assert any(isinstance(x, ptq.QTensor) for _, x in
                   _flat_leaves(eng.params)), arch
    sh = NamedSharding(Mesh((2, 4), ("data", "model")), ("data", "model"))
    q, scale = ptq.quantized_param_shardings(
        {"w": sh}, {"w": torch.empty(8, 8, device="meta")})["w"]
    assert q is sh and scale.spec == (None, "model")
    # frames in: generate refuses, as the reference's does
    for int8 in (False, True):
        seamless = tserve.ServeEngine(
            treg.get_config("seamless-m4t-medium", smoke=True),
            int8_weights=int8, **cpu)
        with pytest.raises(NotImplementedError, match="stub-frontend"):
            seamless.generate(_tokens(11, 2, 8), max_new=4)


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    tcfg = treg.get_config("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.ServeEngine(tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.lm_params_from_numpy({"w": np.zeros(3, np.float32)}, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_cache(tcfg, 1, 8)


def test_serve_main_on_the_cpu(capsys):
    assert tserve.main(["--arch", "qwen2-0.5b", "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--max-new", "4",
                        "--device", "cpu"]) == 0
    first = capsys.readouterr().out.splitlines()[0]
    stats = json.loads(first)
    assert stats["tokens_out"] == 8
