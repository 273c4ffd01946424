"""The MoE serving path of the port (``models/moe.py`` → ``lm_prefill`` /
``lm_decode`` → ``ServeEngine.generate``) held against the reference on
the CPU, at the smoke configs of olmoe-1b-7b and granite-moe-1b-a400m (2
layers, d_model 64, 8 experts top-2, d_ff 32, vocab 256).

Both packages get the same parameters: the reference draws them (with
``attn_impl="pallas"``, its kernel in interpret mode), the f32 leaves —
here ``router`` — are jittered off the values drawn, and they cross as
NumPy through ``lm_params_from_numpy``.  The reference runs unsharded
(``lm.lm_prefill`` / ``lm.lm_decode`` with no mesh, as
``test_torch_lm_serve.py`` explains).

The routing (expert indices, capacity positions, keep mask) must be
equal bit for bit: the reference's ``moe_layer`` does not return it, so
``_ref_routing`` below runs its lines (``src/repro/models/moe.py:63-79``)
on the same input.  Tolerances: f32 atol = rtol = 1e-4 for outputs,
logits and caches (sums in another order); bf16 the dense path's
``BF16_TOL`` (atol 0.08 + rtol 0.03)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import moe as JMOE

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as TMOE

from _torch_port import (BF16_TOL, F32_TOL, flat, ref_and_port,
                         ref_lm_steps, to_np, tokens)

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
D = 64          # the smoke configs' d_model


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _moe_params(arch, dtype, **cfg_kw):
    """(reference cfg, port cfg, reference MoE params of layer 0, the
    port's)."""
    jcfg, tcfg, jp, _, tp = ref_and_port(arch, dtype, **cfg_kw)
    return (jcfg, tcfg, _layer0(jp["blocks"]["b0"]["moe"]),
            tlm._layer(tp["blocks"], 0)["b0"]["moe"])


def _ref_routing(p, cfg, xf):
    """The reference's routing of ``xf`` (N, D): its own lines, which
    ``moe_layer`` computes and does not return."""
    m = cfg.moe
    n, k = xf.shape[0], m.top_k
    cap = JMOE.expert_capacity(n, cfg)
    logits = xf.astype(jnp.float32) @ p["router"]
    gate_w, gate_i = lax.top_k(logits, k)
    gate_w = jax.nn.softmax(gate_w, axis=-1)
    flat_i = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_i, m.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    flat_pos = jnp.take_along_axis(pos, flat_i[:, None], axis=1)[:, 0]
    keep = flat_pos < cap
    return gate_w, gate_i, flat_pos.reshape(n, k), keep.reshape(n, k)


def _both(jcfg, tcfg, jpm, tpm, x):
    """(port routing, reference routing, port output, reference output)
    of one (B, S, D) f32 NumPy input."""
    dt = tcfg.dtype
    xt = torch.from_numpy(x).to(tcfg.param_dtype)
    xj = jnp.asarray(x).astype(dt)
    t_route = TMOE.route(tpm, tcfg, xt.reshape(-1, D))
    j_route = _ref_routing(jpm, jcfg, xj.reshape(-1, D))
    return (t_route, j_route, TMOE.moe_layer(tpm, tcfg, xt),
            JMOE.moe_layer(jpm, jcfg, xj))


def _assert_same_routing(t_route, j_route):
    tw, ti, tpos, tkeep = t_route
    jw, ji, jpos, jkeep = j_route
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32_TOL)


def _with_router(tpm, jpm, router):
    return (dict(tpm, router=torch.from_numpy(router)),
            dict(jpm, router=jnp.asarray(router)))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [(1, 8), (4, 8), (32, 16), (4096, 1280),
                                    (4093, 1280), (100, 32)])
def test_expert_capacity(n, want):
    arch = "granite-moe-1b-a400m"                      # 32 experts, top 8
    assert TMOE.expert_capacity(n, treg.get_config(arch)) == \
        JMOE.expert_capacity(n, jreg.get_config(arch)) == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_the_reference(arch, dtype):
    jcfg, tcfg, jpm, tpm = _moe_params(arch, dtype)
    x = np.random.default_rng(1).standard_normal((2, 16, D)).astype(
        np.float32)
    t_route, j_route, got, want = _both(jcfg, tcfg, jpm, tpm, x)
    _assert_same_routing(t_route, j_route)
    assert got.dtype == tcfg.param_dtype and got.shape == x.shape
    np.testing.assert_allclose(to_np(got), to_np(want),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def _integer_inputs(seed, n_tokens=32, lo=-2, hi=3):
    """Small integers: every logit is an exact integer whatever the
    summation order, so ties are exact in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, (2, n_tokens // 2, D)).astype(np.float32)
    router = rng.integers(lo, hi, (D, 8)).astype(np.float32)
    return x, router


@pytest.mark.parametrize("tied", [(2, 5), (1, 4, 6)])
def test_tied_router_logits_pick_the_lower_index(tied):
    """Identical router columns, made dominant by a constant feature:
    every token's logits tie on them.  The lower indices win, in rising
    order, as ``lax.top_k`` orders them; positions follow."""
    jcfg, tcfg, jpm, tpm = _moe_params(
        ARCHS[0], "float32",
        moe=tbase.MoeConfig(8, 2, capacity_factor=8.0))
    x, router = _integer_inputs(2)
    x[..., 0] = 3.0
    for c in tied:
        router[:, c] = router[:, tied[0]]
        router[0, c] = 50.0
    tpm, jpm = _with_router(tpm, jpm, router)
    t_route, j_route, got, want = _both(jcfg, tcfg, jpm, tpm, x)
    _assert_same_routing(t_route, j_route)
    assert (t_route[1] == torch.tensor(tied[:2])).all()
    assert bool(t_route[3].all())                 # nothing dropped
    np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_routing_with_many_exact_ties(seed):
    """Integer logits in a narrow range tie often, at every rank."""
    jcfg, tcfg, jpm, tpm = _moe_params(ARCHS[1], "float32")
    x, router = _integer_inputs(seed, n_tokens=64, lo=-1, hi=2)
    tpm, jpm = _with_router(tpm, jpm, router)
    logits = x.reshape(-1, D) @ router
    srt = np.sort(logits, axis=-1)
    assert (srt[:, 1:] == srt[:, :-1]).any(axis=-1).mean() > 0.5
    t_route, j_route, got, want = _both(jcfg, tcfg, jpm, tpm, x)
    _assert_same_routing(t_route, j_route)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_overflowing_capacity_drops_the_same_choices(dtype):
    """One expert every token prefers: 32 tokens, capacity 16, so the
    choices of the last 16 tokens for it are dropped — the same ones in
    both packages, with the same output."""
    jcfg, tcfg, jpm, tpm = _moe_params(ARCHS[0], dtype)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    x[..., 0] = 3.0
    router = np.asarray(jpm["router"]).copy()
    router[0, 3] = 40.0
    tpm, jpm = _with_router(tpm, jpm, router)
    t_route, j_route, got, want = _both(jcfg, tcfg, jpm, tpm, x)
    _assert_same_routing(t_route, j_route)
    assert TMOE.expert_capacity(32, tcfg) == 16
    gate_i, keep = t_route[1].numpy(), t_route[3].numpy()
    assert (gate_i[:, 0] == 3).all()
    np.testing.assert_array_equal(keep[:, 0], np.arange(32) < 16)
    np.testing.assert_allclose(to_np(got), to_np(want),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def test_decode_capacity_is_that_of_the_batch():
    """A decode step routes B tokens: capacity max(8, …) of N = B."""
    _, tcfg, _, tpm = _moe_params(ARCHS[0], "float32")
    x = torch.randn(3, 1, D, generator=torch.Generator().manual_seed(0))
    _, _, pos, keep = TMOE.route(tpm, tcfg, x.reshape(-1, D))
    assert bool(keep.all()) and int(pos.max()) < TMOE.expert_capacity(3, tcfg)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_lm_params_from_numpy_keeps_the_router_in_f32():
    """Fault repair: the reference stores ``router`` in f32 whatever
    ``param_dtype`` says (``src/repro/models/moe.py:31``); rounding it to
    bf16 would route, and drop, other choices.  Every other floating leaf
    of a bf16 MoE model is bf16."""
    _, tcfg, jp, npp, tp = ref_and_port(ARCHS[0], "bfloat16")
    router = tp["blocks"]["b0"]["moe"]["router"]
    assert router.dtype == torch.float32
    ref_router = np.asarray(jp["blocks"]["b0"]["moe"]["router"])
    assert ref_router.dtype == np.float32
    np.testing.assert_array_equal(router.numpy(), ref_router)
    assert not np.array_equal(
        ref_router.astype(jnp.bfloat16).astype(np.float32), ref_router)
    for name, leaf in flat(tp):
        key = name.rsplit("/", 1)[-1]
        want = torch.float32 if key in tlm.F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_the_reference(arch):
    """Same leaves, shapes and dtypes: bf16, the router f32."""
    jcfg, tcfg, *_ = ref_and_port(arch, "bfloat16")
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_j, flat_t = dict(flat(shapes)), dict(flat(tp))
    assert sorted(flat_t) == sorted(flat_j)
    for name, leaf in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(leaf.shape), name
        assert str(flat_t[name].dtype) == f"torch.{leaf.dtype}", name
    assert flat_t["blocks/b0/moe/router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_is_the_size_of_init_params(arch):
    tcfg = treg.get_config(arch, smoke=True)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for _, t in flat(tp)) == tbase.count_params(tcfg)


# ---------------------------------------------------------------------------
# the model: prefill, decode
# ---------------------------------------------------------------------------


def _prefill_decode(arch, dtype, steps=4):
    jcfg, tcfg, jp, _, tp = ref_and_port(arch, dtype)
    j_prefill, j_decode = ref_lm_steps(jcfg)
    toks = tokens(7, 2, 32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    rows = [("prefill logits", to_np(tl), to_np(jl))]
    rows += [(f"prefill {k}", to_np(tc["b0"][k]), to_np(jc["b0"][k]))
             for k in ("k", "v")]
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=32 + steps,
                             params=tp)
    tcache = eng._expand_cache(tc, 2, 32)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, steps), (0, 0)]), jc)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(steps):
        jl, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(tok),
                              jnp.asarray(32 + i, jnp.int32))
        tl, tcache = tlm.lm_decode(tp, tcfg, tcache, torch.from_numpy(tok),
                                   32 + i)
        rows.append((f"decode {i} logits", to_np(tl), to_np(jl)))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    rows += [(f"decode {k}", to_np(tcache["b0"][k]), to_np(jcache["b0"][k]))
             for k in ("k", "v")]
    return rows


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_four_decode_steps(arch, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for what, got, want in _prefill_decode(arch, dtype):
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_teacher_forced_prefill(arch):
    """The cache contract (``tests/test_models.py::
    TestPrefillDecodeConsistency``), on the port: decoding the last token
    after a prefill of the rest gives the full prefill's logits.  Drop-free
    (capacity factor 8, capacity ≫ tokens), since a 15- and a 16-token
    forward may legitimately drop other choices; bf16, the reference
    test's 3e-2."""
    tcfg = treg.get_config(arch, smoke=True)
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                              capacity_factor=8.0))
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=16, seed=1)
    toks = tokens(8, 2, 16, tcfg.vocab_size)
    full, _ = eng.prefill(toks)
    _, caches = eng.prefill(toks[:, :-1])
    cache = eng._expand_cache(caches, 2, 15)
    stepped, _ = eng._decode_step(eng.params, cache,
                                  torch.from_numpy(toks[:, -1]), 15)
    np.testing.assert_allclose(stepped.numpy(), full.numpy(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_routes_once_and_attends_through_the_kernel(
        arch, monkeypatch):
    """A prefill calls the flash-attention wrapper (one kernel launch on
    the card) and the router once per layer; a decode step routes once
    per layer and attends against the cache, not through the kernel."""
    _, tcfg, _, _, tp = ref_and_port(arch)
    routed, attended = [], []
    real_route, real_fa = TMOE.route, tfa.flash_attention

    def count_route(p, cfg, xf):
        routed.append(xf.shape[0])
        return real_route(p, cfg, xf)

    def count_fa(*a, **k):
        attended.append(tuple(a[0].shape))
        return real_fa(*a, **k)

    monkeypatch.setattr(TMOE, "route", count_route)
    monkeypatch.setattr(tfa, "flash_attention", count_fa)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=20, params=tp)
    eng.generate(tokens(9, 2, 16), max_new=3)
    n = tcfg.num_layers
    assert attended == [(2 * tcfg.num_heads, 16, 16)] * n
    assert routed == [32] * n + [2] * (2 * n)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _reference_greedy(jcfg, jp, prompts, max_new, max_len):
    """The reference's unsharded loop: prefill, pad the KV caches to
    ``max_len``, decode greedily."""
    j_prefill, j_decode = ref_lm_steps(jcfg)
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
    jcfg, tcfg, jp, _, tp = ref_and_port(arch)
    prompts = tokens(10, 3, 16)
    eng = tserve.ServeEngine(tcfg, device="cpu", max_len=24, params=tp)
    out, stats = eng.generate(prompts, max_new=8)
    assert out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(
        out, _reference_greedy(jcfg, jp, prompts, 8, 24))
    assert stats.tokens_out == 24 and stats.prefill_s > 0


def test_serve_main_on_the_cpu(capsys):
    assert tserve.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                        "--batch", "2", "--prompt-len", "16", "--max-new",
                        "4", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.splitlines()[0])
    assert stats["tokens_out"] == 8
