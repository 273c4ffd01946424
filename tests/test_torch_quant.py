"""Weight-only int8 PTQ of the port (``repro_torch.quant.ptq``) and the
int8 server (``ServeEngine(int8_weights=True)``) held against the
reference's ``repro.quant.ptq`` on the CPU, at smoke configs.

``quantize_params`` / ``dequantize_params`` / ``quantization_error`` are
held bit for bit against the reference's functions on the same
parameters (the reference draws them; they cross as NumPy through
``lm_params_from_numpy``), for the dense (llama3.2-1b, qwen2-0.5b,
nemotron-4-15b's ungated MLP), MoE
(granite-moe) and SSM (mamba2) families, in f32 and bf16.  The int8
forward is the reference's ``test_quant.py::test_quantized_forward_close``
recipe, ``lm_prefill(dequantize_params(quantize_params(p)))``, held
against the reference's unsharded ``lm.lm_prefill`` at the tolerances of
``test_torch_lm_serve.py``.  The reference's own int8 engine tests
(``test_quant.py::TestInt8Model::test_engine_int8_*``) fail under the
mesh on this jax (ROADMAP §C); the port's engine is held instead to a
bf16 engine given the dequantized parameters, bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.quant import ptq as JQ

from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.quant import ptq as TQ

import chip_smoke
from _torch_port import (BF16_TOL, F32_TOL, flat, ref_and_port, ref_lm_steps,
                         to_np, tokens)

ARCHS = ["llama3.2-1b", "qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b",
         "nemotron-4-15b"]
DTYPES = ["float32", "bfloat16"]


def _pairs(jtree, ttree, path=""):
    """(path, reference leaf, port leaf) over both quantized trees, a
    ``QTensor`` a leaf."""
    assert isinstance(ttree, dict) == isinstance(jtree, dict), path
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, jtree, ttree


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as NumPy (bf16 as its uint16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same_bits(a, b, what):
    np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=what)


# ---------------------------------------------------------------------------
# quantize / dequantize / quantization_error against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_and_dequantize_match_the_reference_bit_for_bit(arch, dtype):
    jcfg, tcfg, jp, _, tp = ref_and_port(arch, dtype)
    jq, tq = JQ.quantize_params(jp), TQ.quantize_params(tp)
    n = 0
    for path, j, t in _pairs(jq, tq):
        assert isinstance(t, TQ.QTensor) == isinstance(j, JQ.QTensor), path
        if isinstance(t, TQ.QTensor):
            assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
            assert t.shape == t.q.shape and t.dtype == torch.int8
            _same_bits(t.q, j.q, f"{path} q")
            _same_bits(t.scale, j.scale, f"{path} scale")
            n += 1
        else:
            _same_bits(t, j, path)
    assert n > 0
    jd = JQ.dequantize_params(jq, jcfg.param_dtype)
    td = TQ.dequantize_params(tq, tcfg.param_dtype)
    for path, j, t in _pairs(jd, td):
        assert str(t.dtype) == f"torch.{j.dtype}", path
        _same_bits(t, j, f"{path} dequantized")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantization_error_has_the_reference_keys_and_values(arch):
    _, _, jp, _, tp = ref_and_port(arch, "float32")
    want = JQ.quantization_error(jp, JQ.quantize_params(jp))
    got = TQ.quantization_error(tp, TQ.quantize_params(tp))
    assert list(got) == list(want)
    assert "['blocks']['b0']['ln1']" in got
    assert got == want
    assert max(got.values()) < 0.01


def test_weight_bytes_halve():
    """The reference's ``test_halves_weight_bytes``: int8 + f32 scales
    against bf16, under 0.65 of the bytes."""
    _, tcfg, _, _, tp = ref_and_port("llama3.2-1b", "bfloat16")
    q = TQ.quantize_params(tp)

    def nbytes(tree):
        return sum(x.numel() * x.element_size()
                   for _, leaf in flat(tree)
                   for x in (leaf if isinstance(leaf, TQ.QTensor)
                             else (leaf,)))

    assert nbytes(q) < nbytes(tp) * 0.65


# ---------------------------------------------------------------------------
# the reference's TestQTensor, on the port
# ---------------------------------------------------------------------------


def test_matrices_quantized_vectors_kept():
    params = {"w": torch.ones(8, 16) * 0.5, "ln": torch.ones(16),
              "step": torch.zeros((), dtype=torch.int32),
              "ids": torch.ones(4, 4, dtype=torch.int32)}
    q = TQ.quantize_params(params)
    assert isinstance(q["w"], TQ.QTensor) and q["w"].q.dtype == torch.int8
    assert q["ln"] is params["ln"] and q["step"] is params["step"]
    assert q["ids"] is params["ids"]            # integers stay as they are


def test_roundtrip_error_bounded():
    w = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 128)).astype(
            np.float32) * 0.1)
    d = TQ.dequantize_params(TQ.quantize_params({"w": w}), torch.float32)["w"]
    # absmax per channel → error ≤ scale/2 = amax/254 per channel
    amax = w.abs().amax(dim=0, keepdim=True)
    assert bool(((d - w).abs() <= amax / 254 + 1e-7).all())


def test_per_channel_scales():
    # one huge column must not destroy the precision of others
    w = torch.ones(16, 4) * 0.01
    w[:, 0] = 100.0
    d = TQ.dequantize_params(TQ.quantize_params({"w": w}), torch.float32)["w"]
    np.testing.assert_allclose(d[:, 1:].numpy(), 0.01, rtol=0.01)


def test_rounds_half_to_even_as_the_reference():
    """Values at exactly k + ½ steps of the scale: ``torch.round`` and
    ``jnp.round`` both go to the even neighbour."""
    col = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    w = np.stack([col, col * 2], axis=1)            # scale 1 and 2
    got = TQ.quantize_params({"w": torch.from_numpy(w)})["w"].q.numpy()
    want = np.asarray(JQ.quantize_params({"w": jnp.asarray(w)})["w"].q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [127, 0, 2, 2, 0, -2, 126])


def test_dequantize_is_the_f32_product_rounded_once():
    """``q · scale`` in f32 and one cast: the bits of the reference's
    ``(q.astype(f32) * scale).astype(dtype)``."""
    rng = np.random.default_rng(3)
    qt = TQ.QTensor(torch.from_numpy(rng.integers(-127, 128, (5, 7)).astype(
        np.int8)), torch.from_numpy(rng.random((1, 7)).astype(np.float32)))
    for dt in (torch.float32, torch.bfloat16):
        got = TQ.dequantize_params({"w": qt}, dt)["w"]
        assert got.dtype == dt
        assert torch.equal(got, (qt.q.to(torch.float32) * qt.scale).to(dt))


def test_quantized_param_shardings_waits_for_the_mesh():
    """The shardings of the quantized tree, ported with the device mesh:
    at a ≥2-D float leaf ``q`` keeps the weight's sharding and ``scale``
    replicates the contraction axis; a vector or an integer leaf keeps
    its own (``test_torch_sharding.py`` holds every leaf of the ten
    configs against the reference's)."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((2, 4), ("data", "model"))
    w, v = NamedSharding(mesh, (None, "data", "model")), \
        NamedSharding(mesh, ("model",))
    meta = dict(device="meta")
    got = TQ.quantized_param_shardings(
        {"w": w, "v": v, "i": v},
        {"w": torch.empty(3, 8, 8, **meta), "v": torch.empty(8, **meta),
         "i": torch.empty(8, 8, dtype=torch.int32, **meta)})
    assert got["w"].q is w
    assert got["w"].scale.spec == (None, None, "model")
    assert got["v"] is v and got["i"] is v


# ---------------------------------------------------------------------------
# the reference's quirks, kept bit for bit
# ---------------------------------------------------------------------------


def test_stacked_norms_and_biases_take_one_scale_per_column_across_layers():
    """A tree stacks its layers, so the per-layer norms and QKV biases
    (layers, D) are 2-D and quantized over the layer axis — in both
    packages (qwen2-0.5b's smoke config: 2 layers, QKV biases)."""
    jcfg, tcfg, jp, _, tp = ref_and_port("qwen2-0.5b", "bfloat16")
    tq, jq = TQ.quantize_params(tp), JQ.quantize_params(jp)
    blk, jblk = tq["blocks"]["b0"], jq["blocks"]["b0"]
    n = tcfg.num_layers
    for name, t, j in (("ln1", blk["ln1"], jblk["ln1"]),
                       ("ln2", blk["ln2"], jblk["ln2"]),
                       ("bq", blk["attn"]["bq"], jblk["attn"]["bq"]),
                       ("bk", blk["attn"]["bk"], jblk["attn"]["bk"]),
                       ("bv", blk["attn"]["bv"], jblk["attn"]["bv"])):
        assert isinstance(t, TQ.QTensor) and isinstance(j, JQ.QTensor), name
        assert t.q.shape[0] == n and t.scale.shape == (1, t.q.shape[1]), name
        want = tp["blocks"]["b0"][name] if name.startswith("ln") else \
            tp["blocks"]["b0"]["attn"][name]
        amax = want.float().abs().amax(dim=0, keepdim=True)
        assert torch.equal(t.scale, torch.clamp(amax, min=1e-12) / 127.0)
    # a unit norm comes back as 1 in every layer: 127 · (1 / 127)
    ln = TQ.dequantize_params(tq, tcfg.param_dtype)["blocks"]["b0"]["ln1"]
    assert torch.equal(ln, tp["blocks"]["b0"]["ln1"])


def test_embedding_takes_one_scale_per_model_dimension():
    """The embedding (V, D) is quantized over its vocabulary axis: one
    scale per model dimension, as in the reference."""
    _, tcfg, jp, _, tp = ref_and_port("qwen2-0.5b", "float32")
    e = TQ.quantize_params(tp)["embed"]
    assert e.q.shape == (tcfg.padded_vocab, tcfg.d_model)
    assert e.scale.shape == (1, tcfg.d_model)
    _same_bits(e.scale, JQ.quantize_params(jp)["embed"].scale, "embed scale")


@pytest.mark.parametrize("arch,names", [
    ("mamba2-1.3b", ("a_log", "dt_bias", "skip_d")),
    ("granite-moe-1b-a400m", ("router",)),
])
def test_f32_leaves_come_back_in_the_param_dtype(arch, names):
    """The leaves the model keeps in f32 are stacked (≥ 2-D), so they are
    quantized, and ``dequantize_params(qp, cfg.param_dtype)`` returns them
    in bf16 — in both packages.  The models take them in either dtype."""
    jcfg, tcfg, jp, _, tp = ref_and_port(arch, "bfloat16")
    td = dict(flat(TQ.dequantize_params(TQ.quantize_params(tp),
                                        tcfg.param_dtype)))
    jd = dict(flat(JQ.dequantize_params(JQ.quantize_params(jp),
                                        jcfg.param_dtype)))
    seen = 0
    for path, t in flat(tp):
        if path.rsplit("/", 1)[-1] in names:
            assert t.dtype == torch.float32 and t.ndim >= 2, path
            assert td[path].dtype == torch.bfloat16, path
            assert jd[path].dtype == jnp.bfloat16, path
            seen += 1
    assert seen == len(names)


# ---------------------------------------------------------------------------
# the int8 forward and engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b"])
def test_quantized_forward_matches_the_reference(arch, dtype):
    """``test_quant.py::test_quantized_forward_close``'s recipe in both
    packages: the prefill of the dequantized int8 weights, logits and
    caches at ``test_torch_lm_serve.py``'s tolerances."""
    jcfg, tcfg, jp, _, tp = ref_and_port(arch, dtype)
    jprefill, _ = ref_lm_steps(jcfg)
    toks = tokens(1, 2, 16)
    jl, jc = jprefill(JQ.dequantize_params(JQ.quantize_params(jp),
                                           jcfg.param_dtype), jcfg,
                      {"tokens": jnp.asarray(toks)})
    tl, tc = tlm.lm_prefill(TQ.dequantize_params(TQ.quantize_params(tp),
                                                 tcfg.param_dtype),
                            tcfg, {"tokens": torch.from_numpy(toks)})
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(tl), to_np(jl), **tol)
    for (path, c), (_, w) in zip(sorted(flat(tc)), sorted(flat(jc))):
        np.testing.assert_allclose(to_np(c), to_np(w), err_msg=path, **tol)
    # the reference test's own bound against the unquantized forward
    fl, _ = tlm.lm_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float((fl - tl).abs().mean()) < 0.15


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-1b",
                                  "granite-moe-1b-a400m", "mamba2-1.3b",
                                  "nemotron-4-15b"])
def test_int8_engine_equals_a_bf16_engine_on_the_dequantized_weights(arch):
    """The int8 engine holds int8 weights, generates deterministically,
    and gives the prefill logits and greedy tokens of a bf16 engine handed
    ``dequantize_params(qp)``, bit for bit."""
    cfg = treg.get_config(arch, smoke=True)
    eng = tserve.ServeEngine(cfg, device="cpu", max_len=64, seed=0,
                             int8_weights=True)
    leaves = [leaf for _, leaf in flat(eng.params)]
    assert any(isinstance(x, TQ.QTensor) for x in leaves)
    assert all(x.q.dtype == torch.int8 for x in leaves
               if isinstance(x, TQ.QTensor))
    prompts = _prompts(cfg)
    out, stats = eng.generate(prompts, max_new=6)
    assert out.shape == (2, 6) and out.min() >= 0 and \
        out.max() < cfg.vocab_size
    out2, _ = eng.generate(prompts, max_new=6)
    np.testing.assert_array_equal(out, out2)
    deq = tserve.ServeEngine(
        cfg, device="cpu", max_len=64,
        params=TQ.dequantize_params(eng.params, cfg.param_dtype))
    np.testing.assert_array_equal(deq.generate(prompts, max_new=6)[0], out)
    assert torch.equal(eng.prefill(prompts)[0], deq.prefill(prompts)[0])


def test_int8_engine_quantizes_once_and_dequantizes_each_call(monkeypatch):
    cfg = treg.get_config("qwen2-0.5b", smoke=True)
    calls = {"q": 0, "dq": 0}
    real_q, real_dq = tserve.quantize_params, tserve.dequantize_params

    def q(p):
        calls["q"] += 1
        return real_q(p)

    def dq(p, dtype):
        calls["dq"] += 1
        assert dtype == cfg.param_dtype
        return real_dq(p, dtype)

    monkeypatch.setattr(tserve, "quantize_params", q)
    monkeypatch.setattr(tserve, "dequantize_params", dq)
    eng = tserve.ServeEngine(cfg, device="cpu", max_len=64,
                             int8_weights=True)
    assert calls == {"q": 1, "dq": 0}
    eng.generate(_prompts(cfg), max_new=5)
    assert calls == {"q": 1, "dq": 5}      # one prefill, four decode steps


def test_int8_engine_stays_close_to_the_bf16_engine():
    """``test_quant.py::test_engine_int8_close_to_fp``'s bound, on the
    port: same-seed engines, greedy tokens mostly agree."""
    cfg = treg.get_config("llama3.2-1b", smoke=True).with_(remat=False)
    fp = tserve.ServeEngine(cfg, device="cpu", max_len=48, seed=0)
    q8 = tserve.ServeEngine(cfg, device="cpu", max_len=48, seed=0,
                            int8_weights=True)
    prompts = _prompts(cfg, seed=1)
    o_fp, _ = fp.generate(prompts, max_new=4)
    o_q8, _ = q8.generate(prompts, max_new=4)
    assert (o_fp == o_q8).mean() >= 0.5


def test_int8_engine_on_the_default_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.ServeEngine(treg.get_config("qwen2-0.5b", smoke=True),
                           int8_weights=True)


@pytest.mark.parametrize("shape", [(3, 8, 5), (2, 3, 8, 5)])
def test_stacked_leaves_quantize_layer_by_layer_as_the_whole(shape):
    """A stacked leaf is quantized one layer at a time: the bits of the
    whole leaf's arithmetic (the scale is taken over axis −2 alone), in
    f32 and bf16."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                         .astype(np.float32) * 3)
    for dt in (torch.float32, torch.bfloat16):
        got = TQ.quantize_params({"w": x.to(dt)})["w"]
        q, scale = TQ._quantize_matrix(x.to(dt))
        assert got.scale.shape == (*shape[:-2], 1, shape[-1])
        assert torch.equal(got.q, q) and torch.equal(got.scale, scale)


def test_quantized_mismatches_quantizes_leaf_by_leaf():
    """``chip_smoke.quantized_mismatches(q, p)`` names what
    ``qtensor_mismatches(q, quantize_params(p))`` names."""
    _, _, _, _, tp = ref_and_port("nemotron-4-15b", "bfloat16")
    q = TQ.quantize_params(tp)
    assert chip_smoke.quantized_mismatches(q, tp) == []
    q["lm_head"].q[1, 2] += 1
    q["final_norm"] = q["final_norm"] + 1
    want = chip_smoke.qtensor_mismatches(q, TQ.quantize_params(tp))
    assert want == ["['final_norm']", "['lm_head'].q"]
    assert chip_smoke.quantized_mismatches(q, tp) == want
    del q["lm_head"]
    assert chip_smoke.quantized_mismatches(q, tp) == [" structure"]


def test_card_check_helpers():
    """``chip_smoke.int8_serve``'s helpers: ``qtensor_mismatches`` names
    every leaf whose q, scale or unquantized value differs in one bit, and
    ``_tree_nbytes`` counts a ``QTensor``'s q and scale."""
    _, tcfg, _, _, tp = ref_and_port("qwen2-0.5b", "bfloat16")
    sample = {"blocks": tp["blocks"], "embed": tp["embed"]}
    a = TQ.quantize_params(sample)
    assert chip_smoke.qtensor_mismatches(a, TQ.quantize_params(sample)) == []
    b = TQ.quantize_params(sample)
    b["embed"].q[3, 5] += 1
    b["blocks"]["b0"]["attn"]["wq"].scale.view(torch.int32)[..., 0] ^= 1
    assert chip_smoke.qtensor_mismatches(a, b) == [
        "['blocks']['b0']['attn']['wq'].scale", "['embed'].q"]
    assert chip_smoke.qtensor_mismatches(a, {"embed": b["embed"]}) == [
        "structure"]
    assert chip_smoke._tree_nbytes(a) == sum(
        t.numel() * t.element_size() for _, leaf in flat(a)
        for t in (leaf if isinstance(leaf, TQ.QTensor) else (leaf,)))
