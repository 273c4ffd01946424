"""The SSM serving path of the port (``models/mamba2.py`` → ``lm_prefill``
/ ``lm_decode`` → ``ServeEngine.generate``) held against the reference on
the CPU, at the smoke config of mamba2-1.3b (2 layers, d_model 64, 8 heads
of 16, state 16, chunk 8, vocab 256).

Both packages get the same parameters: the reference draws them, the
f32 leaves ``a_log``, ``dt_bias`` and ``skip_d`` are perturbed away from
their init values (0, 0, 1 round exactly to bf16, so init values would
hide a wrong cast), and they cross as NumPy through
``lm_params_from_numpy``.  The reference runs unsharded (``lm.lm_prefill``
/ ``lm.lm_decode`` with no mesh, as ``test_torch_lm_serve.py`` explains);
its prefill calls ``ref.ssd_chunked``, the port's the SSD kernel's plain
version through ``ops.mamba2_ssd``.

Tolerances: f32 atol = rtol = 1e-4 for logits and caches (sums in another
order); bf16 the dense path's ``BF16_TOL`` (atol 0.08 + rtol 0.03), since
the two frameworks round some elementwise chains at other places."""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import mamba2 as JM

from repro_torch.configs import registry as treg
from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as TM

from _torch_port import compiled_pair  # noqa: F401  (sets torch threads)

ARCH = "mamba2-1.3b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.08, rtol=0.03)


def _perturbed(np_tree, seed=0):
    """The reference's params as NumPy, with the f32 leaves moved off
    values bf16 represents exactly."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "a_log":
                out[k] = (v + rng.uniform(-0.5, 0.5, v.shape)).astype(
                    np.float32)
            elif k == "dt_bias":
                out[k] = rng.uniform(-1.0, 0.5, v.shape).astype(np.float32)
            elif k == "skip_d":
                out[k] = (v + rng.uniform(-0.3, 0.3, v.shape)).astype(
                    np.float32)
            else:
                out[k] = v
        return out

    return walk(np_tree)


@functools.lru_cache(maxsize=None)
def _models(dtype: str = "float32"):
    """(reference cfg, port cfg, reference params, NumPy params, port
    params) of the smoke config, f32 leaves perturbed."""
    jcfg = jreg.get_config(ARCH, smoke=True).with_(dtype=dtype)
    tcfg = treg.get_config(ARCH, smoke=True).with_(dtype=dtype)
    init = jlm.init_params(jax.random.key(0), jcfg)
    npp = _perturbed(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  init))
    jp = jax.tree.map(lambda n, a: jnp.asarray(n).astype(a.dtype), npp, init)
    return jcfg, tcfg, jp, npp, tlm.lm_params_from_numpy(npp, tcfg,
                                                         device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
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
# the Mamba block's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,target", [(32, 8), (1023, 64), (37, 64),
                                      (5, 8), (1, 64)])
def test_pick_chunk(l, target):
    assert TM.pick_chunk(l, target) == JM.pick_chunk(l, target)


def test_causal_depthwise_conv_and_its_decode_step():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    got = TM._causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w))
    want = JM._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # the line buffer of the last K-1 inputs gives the next output
    step, cache = TM._conv_decode_step(torch.from_numpy(x[:, 8]),
                                       torch.from_numpy(x[:, 5:8]),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(_np(step), _np(want)[:, 8], **F32_TOL)
    np.testing.assert_array_equal(cache.numpy(), x[:, 6:9])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layer(dtype):
    jcfg, tcfg, jp, npp, tp = _models(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    got = TM.mamba_layer(_layer0(tp["blocks"]["b0"])["mamba"], tcfg,
                         torch.from_numpy(x).to(tcfg.param_dtype))
    want = JM.mamba_layer(_layer0(jp["blocks"]["b0"])["mamba"], jcfg,
                          jnp.asarray(x).astype(dtype))
    assert got.dtype == tcfg.param_dtype and got.shape == x.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_mamba_decode():
    jcfg, tcfg, jp, npp, tp = _models()
    rng = np.random.default_rng(3)
    s = tcfg.ssm
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    conv = rng.standard_normal((2, s.conv_kernel - 1, s.conv_dim(64))).astype(
        np.float32)
    ssm = rng.standard_normal((2, s.num_heads(64), s.head_dim,
                               s.state_dim)).astype(np.float32)
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    got = TM.mamba_decode(_layer0(tp["blocks"]["b0"])["mamba"], tcfg,
                          torch.from_numpy(x), tconv, tssm)
    want = JM.mamba_decode(_layer0(jp["blocks"]["b0"])["mamba"], jcfg,
                           jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    # the caches passed in are left as they were
    np.testing.assert_array_equal(tconv.numpy(), conv)
    np.testing.assert_array_equal(tssm.numpy(), ssm)


# ---------------------------------------------------------------------------
# the model: prefill, decode, init
# ---------------------------------------------------------------------------


def _prefill_decode(dtype, steps=8):
    jcfg, tcfg, jp, npp, tp = _models(dtype)
    j_prefill, j_decode = _jitted(jcfg)
    toks = _tokens(6, 2, 32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    rows = [(_np(tl), _np(jl))]
    rows += [(_np(tc["b0"][k]), _np(jc["b0"][k])) for k in ("conv", "ssm")]
    tcache = tlm.init_cache(tcfg, 2, 32 + steps, device="cpu")
    for k in ("conv", "ssm"):
        tcache["b0"][k].copy_(tc["b0"][k])
    jcache = jc
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(steps):
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(tok),
                              jnp.asarray(32 + i, jnp.int32))
        tl, tcache2 = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(tok),
                                    32 + i)
        assert tcache2 is tcache              # updated in place
        rows.append((_np(tl), _np(jl)))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    rows += [(_np(tcache["b0"][k]), _np(jcache["b0"][k]))
             for k in ("conv", "ssm")]
    return rows


def test_prefill_then_eight_decode_steps_f32():
    for got, want in _prefill_decode("float32"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_prefill_then_eight_decode_steps_bf16():
    for got, want in _prefill_decode("bfloat16"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **BF16_TOL)


def test_prefill_with_a_ragged_chunk():
    """A 30-token prompt takes chunk 6 (the largest divisor up to 8)."""
    jcfg, tcfg, jp, npp, tp = _models()
    toks = _tokens(7, 2, 30)
    jl, jc = jlm.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    np.testing.assert_allclose(_np(tc["b0"]["ssm"]), _np(jc["b0"]["ssm"]),
                               **F32_TOL)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_init_params_layout_matches_the_reference():
    """Same leaves, shapes and dtypes: bf16, but f32 for a_log, dt_bias
    and skip_d, as the reference keeps them."""
    jcfg = jreg.get_config(ARCH, smoke=True)
    tcfg = treg.get_config(ARCH, smoke=True)
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_j = dict(_flat(shapes))
    flat_t = dict(_flat(tp))
    assert sorted(flat_t) == sorted(flat_j)
    for name, leaf in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
        assert str(flat_t[name].dtype) == f"torch.{leaf.dtype}", name
    assert flat_t["blocks/b0/mamba/a_log"].dtype == torch.float32


def test_lm_params_from_numpy_keeps_the_f32_leaves():
    """Fault repair: under a bf16 config the reference keeps a_log,
    dt_bias and skip_d in f32; casting them would compute another model.
    Every other floating leaf is bf16."""
    _, tcfg, jp, npp, tp = _models("bfloat16")
    for name, leaf in _flat(tp):
        key = name.rsplit("/", 1)[-1]
        want = torch.float32 if key in TM.F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, name
    ref_a = np.asarray(jp["blocks"]["b0"]["mamba"]["a_log"])
    assert ref_a.dtype == np.float32
    np.testing.assert_array_equal(
        tp["blocks"]["b0"]["mamba"]["a_log"].numpy(), ref_a)
    assert not np.array_equal(ref_a.astype(jnp.bfloat16).astype(np.float32),
                              ref_a)   # the values bf16 would round


def test_init_cache_matches_the_reference():
    """Fault repair: conv line buffer (param dtype) and SSD state (f32) per
    Mamba block, as the reference's ``init_cache`` lays them out."""
    for dtype in ("float32", "bfloat16"):
        jcfg = jreg.get_config(ARCH, smoke=True).with_(dtype=dtype)
        tcfg = treg.get_config(ARCH, smoke=True).with_(dtype=dtype)
        want = jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, 40))
        got = tlm.init_cache(tcfg, 3, 40, device="cpu")
        flat_j, flat_t = dict(_flat(want)), dict(_flat(got))
        assert sorted(flat_t) == ["b0/conv", "b0/ssm"] == sorted(flat_j)
        for name, leaf in flat_j.items():
            assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
            assert str(flat_t[name].dtype) == f"torch.{leaf.dtype}", name
            assert not flat_t[name].any()


def test_expand_cache_copies_the_ssm_leaves_whole():
    """Fault repair: only a leaf whose shape differs from the decode
    cache's (k / v) is padded; the conv line buffer and the SSD state are
    copied as they are."""
    _, tcfg, _, _, tp = _models()
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=40, params=tp)
    _, caches = eng.prefill(_tokens(8, 2, 32))
    full = eng._expand_cache(caches, 2, 32)
    for k in ("conv", "ssm"):
        assert full["b0"][k].shape == caches["b0"][k].shape
        torch.testing.assert_close(full["b0"][k], caches["b0"][k],
                                   atol=0, rtol=0)
    dense = treg.get_config("llama3.2-1b", smoke=True).with_(dtype="float32")
    deng = tserve.ServeEngine(dense, device="cpu", max_len=40)
    _, kv = deng.prefill(_tokens(8, 2, 32))
    kfull = deng._expand_cache(kv, 2, 32)["b0"]["k"]
    assert kfull.shape[3] == 40
    torch.testing.assert_close(kfull[:, :, :, :32], kv["b0"]["k"], atol=0,
                               rtol=0)
    assert not kfull[:, :, :, 32:].any()


def test_prefill_launches_the_ssd_kernel_once_per_layer(monkeypatch):
    """On the card each layer's scan is one kernel launch: count the
    wrapper's calls on the CPU; decode takes the recurrent step, not the
    kernel."""
    _, tcfg, _, _, tp = _models()
    calls = []
    real = tms.mamba2_ssd

    def counting(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(tms, "mamba2_ssd", counting)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=24, params=tp)
    eng.generate(_tokens(9, 2, 16), max_new=4)
    assert calls == [(2, 16, 8, 16)] * tcfg.num_layers


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _reference_greedy(jcfg, jp, prompts, max_new):
    """The reference's unsharded loop; SSM caches keep their shapes, so
    prefill hands them straight to decode."""
    j_prefill, j_decode = _jitted(jcfg)
    logits, cache = j_prefill(jp, jcfg, {"tokens": jnp.asarray(prompts)})
    plen = prompts.shape[1]
    out = np.zeros((prompts.shape[0], max_new), np.int32)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out[:, 0] = np.asarray(tok)
    for i in range(1, max_new):
        logits, cache = j_decode(jp, jcfg, cache, tok,
                                 jnp.asarray(plen + i - 1, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[:, i] = np.asarray(tok)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_the_reference(dtype):
    jcfg, tcfg, jp, npp, tp = _models(dtype)
    prompts = _tokens(10, 3, 16)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=32, params=tp)
    out, stats = eng.generate(prompts, max_new=8)
    assert out.shape == (3, 8) and out.dtype == np.int32
    want = _reference_greedy(jcfg, jp, prompts, 8)
    if dtype == "float32":
        np.testing.assert_array_equal(out, want)
    else:   # bf16 may break a near-tie the other way; most tokens agree
        assert (out == want).mean() >= 0.75
    assert stats.tokens_out == 24 and stats.prefill_s > 0


def test_serve_main_on_the_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--max-new", "4",
                        "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.splitlines()[0])
    assert stats["tokens_out"] == 8


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_moe_and_hybrid_still_raise(arch):
    """The MoE and hybrid families are ported (``test_torch_moe_serve.py``,
    ``test_torch_hybrid_serve.py``), and since int8 weights are ported too
    (``test_torch_quant.py``) they no longer refuse them: the int8 engine
    generates the tokens of a bf16 engine on its dequantized weights (the
    router, dequantized to bf16, promoted to f32 as the reference's ``@``
    does)."""
    from repro_torch.quant import dequantize_params

    cfg = treg.get_config(arch, smoke=True)
    q8 = tserve.ServeEngine(cfg, device="cpu", max_len=24, int8_weights=True)
    deq = tserve.ServeEngine(cfg, device="cpu", max_len=24,
                             params=dequantize_params(q8.params,
                                                      cfg.param_dtype))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8),
                                                dtype=np.int32)
    out, _ = q8.generate(prompts, max_new=4)
    np.testing.assert_array_equal(out, deq.generate(prompts, max_new=4)[0])
    assert tserve.ServeEngine(cfg, device="cpu", max_len=24).params
