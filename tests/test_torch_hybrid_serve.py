"""The hybrid serving path of the port (Jamba's superblock: 7 Mamba-2
layers and 1 attention layer, MoE on every second layer → ``lm_prefill``
/ ``lm_decode`` → ``ServeEngine.generate``) held against the reference
on the CPU, at the smoke config of jamba-1.5-large-398b (one superblock
of 8 layers, d_model 64, 4/2 heads of 16, 4 experts top-2, d_ff 128,
state 16, chunk 8, vocab 256).

Both packages get the same parameters (``_torch_port.ref_and_port``: the
reference draws them, the f32 leaves — ``a_log``, ``dt_bias``,
``skip_d``, ``router`` — are moved off the values drawn, and they cross
as NumPy).  The reference runs unsharded with ``attn_impl="pallas"``.

Tolerances: f32 atol = rtol = 1e-4 for logits and every cache leaf.  In
bf16 each layer, fed the same input in both packages, agrees within the
dense path's ``BF16_TOL``; the whole superblock does not, because this
model amplifies rounding: the reference's own bf16 logits lie ≈ 0.2 from
its f32 logits (max |logit| ≈ 3.3) and the port's as far on the other
side.  So the whole model in bf16 is held to the f32 reference: the
port's distance may be at most twice the reference's own."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import lm as jlm

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as TMOE

from _torch_port import (BF16_TOL, F32_TOL, flat, ref_and_port,
                         ref_lm_steps, to_np, tokens)

ARCH = "jamba-1.5-large-398b"
#: the superblock of the smoke config and of the published one
PATTERN = [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
           ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
           ("mamba", "mlp"), ("mamba", "moe")]


@pytest.mark.parametrize("smoke", [True, False])
def test_superblock_pattern_matches_the_reference(smoke):
    tcfg = treg.get_config(ARCH, smoke=smoke)
    got = [(s.mixer, s.ffn) for s in tlm.superblock_pattern(tcfg)]
    want = [(s.mixer, s.ffn) for s in jlm.superblock_pattern(
        jreg.get_config(ARCH, smoke=smoke))]
    assert got == want == PATTERN
    assert tlm.num_superblocks(tcfg) == tcfg.num_layers // 8


def test_init_params_layout_matches_the_reference():
    jcfg, tcfg, *_ = ref_and_port(ARCH, "bfloat16")
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_j, flat_t = dict(flat(shapes)), dict(flat(tp))
    assert sorted(flat_t) == sorted(flat_j)
    for name, leaf in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
        assert str(flat_t[name].dtype) == f"torch.{leaf.dtype}", name


def test_count_params_is_the_size_of_init_params():
    tcfg = treg.get_config(ARCH, smoke=True)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for _, t in flat(tp)) == tbase.count_params(tcfg)


# ---------------------------------------------------------------------------
# the mixed cache tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_mixes_kv_and_ssm_leaves_as_the_reference(dtype):
    """One tree: k / v for the attention position, conv (param dtype) and
    ssm (f32) for the seven Mamba positions."""
    jcfg, tcfg, *_ = ref_and_port(ARCH, dtype)
    want = dict(flat(jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, 40))))
    got = dict(flat(tlm.init_cache(tcfg, 3, 40, device="cpu")))
    assert sorted(got) == sorted(want)
    assert sorted(k for k in got if k.startswith("b4/")) == ["b4/k", "b4/v"]
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert str(got[name].dtype) == f"torch.{leaf.dtype}", name
        assert not got[name].any()


def test_expand_cache_pads_kv_and_copies_the_ssm_leaves():
    """On the mixed tree: the attention position's k / v fill the leading
    corner of the ``max_len`` cache; every conv and SSD-state leaf is
    copied whole."""
    _, tcfg, _, _, tp = ref_and_port(ARCH)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=40, params=tp)
    _, caches = eng.prefill(tokens(1, 2, 32))
    full = eng._expand_cache(caches, 2, 32)
    for name, leaf in flat(full):
        src = dict(flat(caches))[name]
        if name.startswith("b4/"):
            assert leaf.shape[3] == 40 and src.shape[3] == 32, name
            torch.testing.assert_close(leaf[:, :, :, :32], src, atol=0,
                                       rtol=0)
            assert not leaf[:, :, :, 32:].any()
        else:
            assert leaf.shape == src.shape, name
            torch.testing.assert_close(leaf, src, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _prefill_decode(dtype, steps=4):
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, dtype)
    j_prefill, j_decode = ref_lm_steps(jcfg)
    toks = tokens(2, 2, 32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    rows = [("prefill logits", to_np(tl), to_np(jl))]
    rows += [(f"prefill {n}", to_np(t), to_np(dict(flat(jc))[n]))
             for n, t in flat(tc)]
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=32 + steps,
                             params=tp)
    tcache = eng._expand_cache(tc, 2, 32)

    def pad(path, a):
        if path[-1].key in ("k", "v"):
            return jnp.pad(a, [(0, 0)] * 3 + [(0, steps), (0, 0)])
        return a

    jcache = jax.tree_util.tree_map_with_path(pad, jc)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(steps):
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(tok),
                              jnp.asarray(32 + i, jnp.int32))
        tl, tcache = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(tok),
                                   32 + i)
        rows.append((f"decode {i} logits", to_np(tl), to_np(jl)))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    rows += [(f"decode {n}", to_np(t), to_np(dict(flat(jcache))[n]))
             for n, t in flat(tcache)]
    return rows


def test_prefill_then_four_decode_steps_f32():
    for what, got, want in _prefill_decode("float32"):
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)


@pytest.mark.parametrize("pos", range(8))
def test_each_layer_in_bf16_matches_the_reference(pos):
    """Layer ``pos`` of the superblock (mixer and FFN, with the caches it
    collects) on one bf16 input in both packages."""
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, "bfloat16")
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    positions = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jspec = jlm.superblock_pattern(jcfg)[pos]
    tspec = tlm.superblock_pattern(tcfg)[pos]
    jh, jc = jlm._apply_block(
        jax.tree.map(lambda a: a[0], jp["blocks"][f"b{pos}"]), jcfg, jspec,
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(positions), None, True)
    th, tc = tlm._apply_block(
        tlm._layer(tp["blocks"], 0)[f"b{pos}"], tcfg, tspec,
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(positions.copy()), None, True)
    np.testing.assert_allclose(to_np(th), to_np(jh), **BF16_TOL)
    for name, leaf in flat(tc):
        np.testing.assert_allclose(to_np(leaf), to_np(jc[name]),
                                   err_msg=name, **BF16_TOL)


def test_the_bf16_superblock_is_as_near_the_f32_reference_as_the_reference():
    """See the module's docstring: bf16 against the f32 reference's
    logits, for the port and for the reference, on the same weights."""
    jcfg32, _, jp32, _, _ = ref_and_port(ARCH, "float32")
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH, "bfloat16")
    toks = tokens(4, 2, 32)
    batch = {"tokens": jnp.asarray(toks)}
    truth, _ = ref_lm_steps(jcfg32)[0](jp32, jcfg32, batch)
    ref_bf16, _ = ref_lm_steps(jcfg)[0](jp, jcfg, batch)
    port_bf16, _ = tlm.lm_prefill(tp, tcfg,
                                  {"tokens": torch.from_numpy(toks)})
    ref_gap = np.abs(to_np(ref_bf16) - to_np(truth)).max()
    port_gap = np.abs(to_np(port_bf16) - to_np(truth)).max()
    assert 0 < ref_gap and port_gap <= 2 * ref_gap, (port_gap, ref_gap)


def test_decode_matches_the_teacher_forced_prefill():
    """The cache contract of ``tests/test_models.py::
    TestPrefillDecodeConsistency`` for the mixed tree, drop-free
    (capacity factor 8), bf16 at that test's 3e-2."""
    import dataclasses

    tcfg = treg.get_config(ARCH, smoke=True)
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                              capacity_factor=8.0))
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=16, seed=1)
    toks = tokens(5, 2, 16, tcfg.vocab_size)
    full, _ = eng.prefill(toks)
    _, caches = eng.prefill(toks[:, :-1])
    cache = eng._expand_cache(caches, 2, 15)
    stepped, _ = eng._decode_step(eng.params, cache,
                                  torch.from_numpy(toks[:, -1]), 15)
    np.testing.assert_allclose(stepped.numpy(), full.numpy(), atol=3e-2,
                               rtol=3e-2)


def test_prefill_launches_one_attention_and_seven_scans_a_superblock(
        monkeypatch):
    """On the card each is one kernel launch: count the wrappers' calls on
    the CPU.  Decode takes neither kernel; the router runs once per MoE
    layer in prefill and in each decode step."""
    _, tcfg, _, _, tp = ref_and_port(ARCH)
    calls = {"flash": [], "ssd": [], "route": []}
    real = (tfa.flash_attention, tms.mamba2_ssd, TMOE.route)

    def counting(name, fn, arg=0):
        def wrapped(*a, **k):
            calls[name].append(tuple(a[arg].shape))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention", counting("flash", real[0]))
    monkeypatch.setattr(tms, "mamba2_ssd", counting("ssd", real[1]))
    monkeypatch.setattr(TMOE, "route", counting("route", real[2], arg=2))
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=20, params=tp)
    eng.generate(tokens(6, 2, 16), max_new=3)
    s = tcfg.ssm
    assert calls["flash"] == [(2 * tcfg.num_heads, 16, 16)]
    assert calls["ssd"] == [(2, 16, s.num_heads(64), s.head_dim)] * 7
    assert calls["route"] == [(32, 64)] * 4 + [(2, 64)] * 4 * 2


def test_greedy_generate_matches_the_reference():
    jcfg, tcfg, jp, _, tp = ref_and_port(ARCH)
    j_prefill, j_decode = ref_lm_steps(jcfg)
    prompts = tokens(7, 3, 16)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=24, params=tp)
    out, _ = eng.generate(prompts, max_new=8)
    logits, caches = j_prefill(jp, jcfg, {"tokens": jnp.asarray(prompts)})
    cache = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.pad(a, [(0, 0)] * 3 + [(0, 8), (0, 0)])
        if path[-1].key in ("k", "v") else a, caches)
    want = np.zeros((3, 8), np.int32)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want[:, 0] = np.asarray(tok)
    for i in range(1, 8):
        logits, cache = j_decode(jp, jcfg, cache, tok,
                                 jnp.asarray(16 + i - 1, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want[:, i] = np.asarray(tok)
    np.testing.assert_array_equal(out, want)
