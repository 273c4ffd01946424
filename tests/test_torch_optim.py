"""The optimizer and gradient compression of the port (``repro_torch.
optim``) held against the reference's on the same NumPy inputs.

AdamW: ``lr_schedule`` over steps and ``apply`` over several steps, with
and without int8 second moments — f32 params and moments to 1e-6
(both compute in f32 in the same order; ``cos``, ``sqrt`` and ``pow``
may round differently by an ulp), bf16 params bit-equal or one bf16 step
apart (an f32 update that lands within an ulp of a rounding boundary).
Compression: bit-exact (``torch.round`` and ``jnp.round`` both round half
to even)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as JA
from repro.optim import compress as JC

from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

from _torch_port import flat, to_np  # noqa: F401  (sets torch threads)

SHAPES = {"w": (5, 7), "blocks": {"b0": {"ln": (7,), "wq": (3, 7, 4)}},
          "embed": (11, 7)}


def _tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return walk(SHAPES)


def _both(np_tree, dtype: str):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), np_tree)
    t = TA.tree_map(lambda a: torch.from_numpy(a.copy()).to(tdt), np_tree)
    return j, t


def _ulps_bf16(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in bf16 steps between two bf16-valued f32
    arrays of one sign pattern."""
    ia = a.astype(np.float32).view(np.int32) >> 16
    ib = b.astype(np.float32).view(np.int32) >> 16
    return int(np.abs(ia.astype(np.int64) - ib).max())


@pytest.mark.parametrize("warmup,total", [(0, 10), (5, 50), (100, 1000)])
def test_lr_schedule_matches_the_reference(warmup, total):
    cfg_j = JA.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    cfg_t = TA.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, warmup // 2, warmup, warmup + 1, total // 2,
                 total - 1, total, total + 7):
        want = float(JA.lr_schedule(cfg_j, jnp.asarray(step, jnp.int32)))
        got = float(TA.lr_schedule(cfg_t, torch.tensor(step,
                                                       dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_over_steps_matches_the_reference(dtype, quantize):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=5.0,
              quantize_moments=quantize)
    cfg_j, cfg_t = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    pj, pt = _both(_tree(0), dtype)
    sj, st = JA.init(pj, cfg_j), TA.init(pt, cfg_t)
    for step in range(4):
        gj, gt = _both(_tree(10 + step, scale=0.3 + step), dtype)
        pj, sj, mj = JA.apply(pj, gj, sj, cfg_j)
        pt, st, mt = TA.apply(pt, gt, st, cfg_t)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        assert int(st.step) == int(sj.step) == step + 1
        fj = dict(flat(jax.tree.map(np.asarray, pj)))
        for path, got in flat(pt):
            assert got.dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[dtype], path
            want = to_np(fj[path])
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6, err_msg=path)
            else:
                assert _ulps_bf16(got.float().numpy(), want) <= 1, path
        for name, tj, tt in (("mu", sj.mu, st.mu),
                             ("nu_scale", sj.nu_scale, st.nu_scale)):
            if tj is None:
                assert tt is None
                continue
            fj = dict(flat(jax.tree.map(np.asarray, tj)))
            for path, got in flat(tt):
                assert got.dtype == torch.float32, path
                np.testing.assert_allclose(got.numpy(), fj[path], rtol=1e-5,
                                           atol=1e-7, err_msg=f"{name} {path}")
        fj = dict(flat(jax.tree.map(np.asarray, sj.nu)))
        for path, got in flat(st.nu):
            want = fj[path]
            if quantize:
                assert got.dtype == torch.int8, path
                assert np.abs(got.numpy().astype(np.int32)
                              - want.astype(np.int32)).max() <= 1, path
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-9, err_msg=path)


def test_apply_leaves_its_arguments_unchanged():
    cfg = TA.AdamWConfig(lr=0.1, warmup_steps=0)
    _, p = _both(_tree(1), "float32")
    _, g = _both(_tree(2), "float32")
    s = TA.init(p, cfg)
    before = [t.clone() for _, t in flat(p)]
    p2, s2, _ = TA.apply(p, g, s, cfg)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, flat(p)))
    assert int(s.step) == 0 and int(s2.step) == 1
    assert not torch.equal(p2["w"], p["w"])


def test_global_norm_sums_the_leaves_in_the_reference_order():
    nj, nt = _both(_tree(3), "float32")
    np.testing.assert_allclose(float(TA.global_norm(nt)),
                               float(JA.global_norm(nj)), rtol=1e-7)
    assert [tuple(x.shape) for x in TA.tree_leaves(nt)] == \
        [tuple(x.shape) for x in jax.tree.leaves(nj)]


def test_converges_on_a_quadratic():
    """The reference's own convergence check, on the port."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                         total_steps=300, grad_clip=100.0)
    state = TA.init(params, cfg)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = TA.apply(params, g, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_is_bit_exact(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10 ** seed).astype(np.float32)
    x[:3] = [0.5, -0.5, 2.5]           # ties of the rounding, once scaled
    qj, sj = JC.quantize_int8(jnp.asarray(x))
    qt, s_t = TC.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(s_t) == float(sj)
    np.testing.assert_array_equal(TC.dequantize_int8(qt, s_t).numpy(),
                                  np.asarray(JC.dequantize_int8(qj, sj)))


def test_rounding_is_half_to_even_like_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5], np.float32)
    qj, _ = JC.quantize_int8(jnp.asarray(x))
    qt, _ = TC.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy()[1:6], [0, 2, 2, 0, -2])


def test_zero_input_quantizes_to_zero():
    qt, s_t = TC.quantize_int8(torch.zeros(8))
    qj, sj = JC.quantize_int8(jnp.zeros(8))
    assert not qt.any() and float(s_t) == float(sj)


def test_compress_with_feedback_is_bit_exact_over_steps():
    rng = np.random.default_rng(4)
    gj, gt = _both(_tree(5), "float32")
    ej, et = JC.init_error_feedback(gj), TC.init_error_feedback(gt)
    for _, e in flat(et.err):
        assert e.dtype == torch.float32 and not e.any()
    errs_j, errs_t = ej.err, et.err
    for step in range(3):
        g = (rng.standard_normal((5, 7)) * (step + 1)).astype(np.float32)
        qj, sj, errs_j["w"] = JC.compress_with_feedback(jnp.asarray(g),
                                                        errs_j["w"])
        qt, s_t, errs_t["w"] = TC.compress_with_feedback(
            torch.from_numpy(g), errs_t["w"])
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(s_t) == float(sj)
        np.testing.assert_array_equal(errs_t["w"].numpy(),
                                      np.asarray(errs_j["w"]))


def test_compressed_psum_pod_names_the_roadmap_item():
    """The cross-pod sum runs on a mesh with a ``pod`` axis
    (``test_torch_compress_pod.py`` holds it against the reference's);
    a mesh without one raises, as the reference asserts."""
    from repro_torch.launch.mesh import Mesh

    _, g = _both(_tree(6), "float32")
    with pytest.raises(ValueError, match="pod axis"):
        TC.compressed_psum_pod(g, TC.init_error_feedback(g),
                               Mesh((2, 2), ("data", "model")))
