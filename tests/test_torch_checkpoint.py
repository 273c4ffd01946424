"""Checkpoints of the port (``repro_torch.checkpoint.manager``) held
against the reference's ``repro.checkpoint.manager.CheckpointManager`` on
the CPU.

The reference's ``tests/test_checkpoint.py`` cases run on the port
(round trip, latest step, structure mismatch, ``.tmp`` invisibility,
manifest, gc, async); its elastic re-mesh case needs a device mesh and
waits for distributed training (ROADMAP.md §A item 6).  Then the two
packages against each other: a ``{"params", "opt"}`` train state written
by either restores in the other bit for bit — bf16 parameters, an
``AdamWState`` with f32 moments or ``quantize_moments=True`` (int8 ``nu``
and ``nu_scale``), a 0-d int32 ``step`` — and both write byte-identical
``manifest.json`` and ``.npy`` files."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim import adamw as JA
from repro.quant import ptq as JQ

from repro_torch.checkpoint import manager as TM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim import adamw as TA
from repro_torch.quant import ptq as TQ
from repro_torch.tree import tree_flatten_with_path

from _torch_port import ref_and_port


def _tree(x=0.0):
    return {
        "params": {"w": torch.full((4, 4), 1.0 + x), "b": torch.zeros(4)},
        "opt": {"mu": torch.full((4, 4), 2.0 + x)},
    }


def _leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _restore(mgr, step, template):
    return mgr.restore(step, template, device="cpu")


# ---------------------------------------------------------------------------
# the reference's test_checkpoint.py, on the port
# ---------------------------------------------------------------------------


class TestRoundtrip:
    def test_save_restore_bitexact(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree(0.5)
        mgr.save(7, tree, extra={"note": "x"})
        restored, extra = _restore(mgr, 7, tree)
        assert extra == {"note": "x"}
        for a, b in zip(_leaves(tree), _leaves(restored)):
            assert torch.equal(a, b)
        assert list(restored["params"]) == ["w", "b"]   # the template's order

    def test_latest_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.latest_step() is None
        mgr.save(1, _tree())
        mgr.save(5, _tree())
        assert mgr.latest_step() == 5

    def test_structure_mismatch_caught(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        with pytest.raises(ValueError, match="structure changed"):
            _restore(mgr, 1, {"params": {"w": torch.zeros(4, 4)}})

    def test_shape_mismatch_caught(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        tmpl = _tree()
        tmpl["params"]["w"] = torch.zeros(4, 5)
        with pytest.raises(ValueError, match=r"\['params'\]\['w'\]"):
            _restore(mgr, 1, tmpl)

    def test_meta_template_casts_and_places(self, tmp_path):
        """A template of ``meta`` tensors (or of arrays) gives the shapes
        and dtypes: each leaf is cast to its template's dtype (f32 → bf16
        rounds to nearest even, as numpy's ``astype`` does) and lands on
        the device asked for."""
        mgr = CheckpointManager(str(tmp_path))
        w = torch.tensor([[1.0 + 2 ** -8, 3.0], [1.0 + 3 * 2 ** -9, -0.1]])
        mgr.save(2, {"w": w, "n": torch.arange(3, dtype=torch.int32)})
        meta = {"w": torch.empty(2, 2, dtype=torch.bfloat16, device="meta"),
                "n": np.zeros(3, np.int32)}
        got, _ = _restore(mgr, 2, meta)
        assert got["w"].device.type == "cpu"
        assert torch.equal(got["w"], w.to(torch.bfloat16))
        assert got["n"].dtype == torch.int32
        assert torch.equal(got["n"], torch.arange(3, dtype=torch.int32))

    def test_default_device_needs_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        with pytest.raises(RuntimeError, match="cuda"):
            mgr.restore(1, _tree())


class TestAtomicity:
    def test_tmp_dirs_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, _tree())
        # simulate a crash mid-write: stray .tmp with garbage
        os.makedirs(tmp_path / "step_000000009.tmp")
        assert mgr.latest_step() == 3

    def test_manifest_required(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        os.makedirs(tmp_path / "step_000000004")  # no manifest → not committed
        assert mgr.latest_step() is None

    def test_gc_keeps_newest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree())
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(tmp_path)
            if d.startswith("step_")
        )
        assert steps == [3, 4]

    def test_a_save_over_a_stale_tmp_dir_commits(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        os.makedirs(tmp_path / "step_000000006.tmp")
        (tmp_path / "step_000000006.tmp" / "arr_00000.npy").write_bytes(b"x")
        mgr.save(6, _tree(1.0))
        assert mgr.latest_step() == 6
        assert not os.path.exists(tmp_path / "step_000000006.tmp")
        got, _ = _restore(mgr, 6, _tree())
        assert float(got["opt"]["mu"][0, 0]) == 3.0


class TestAsync:
    def test_async_write_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_async(11, _tree(1.0))
        mgr.wait()
        restored, _ = _restore(mgr, 11, _tree())
        assert float(_leaves(restored)[0][0, 0]) == pytest.approx(3.0)

    def test_async_snapshot_semantics(self, tmp_path):
        """Mutating the live tree after save_async must not corrupt the
        checkpoint (the snapshot is taken synchronously): a NumPy array as
        in the reference's test, and a host tensor, which is cloned."""
        mgr = CheckpointManager(str(tmp_path))
        live = {"w": np.ones(4), "t": torch.ones(4, dtype=torch.bfloat16)}
        mgr.save_async(1, live)
        live["w"][:] = 99.0
        live["t"][:] = 99.0
        mgr.wait()
        tmpl = {"w": torch.zeros(4, dtype=torch.float64),
                "t": torch.zeros(4, dtype=torch.bfloat16)}
        restored, _ = _restore(mgr, 1, tmpl)
        assert torch.equal(restored["w"], torch.ones(4, dtype=torch.float64))
        assert torch.equal(restored["t"], torch.ones(4, dtype=torch.bfloat16))

    def test_a_failed_write_raises_from_wait(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path))

        def broken(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(TM.np, "save", broken)
        mgr.save_async(2, _tree())
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        mgr.wait()                      # reported once
        assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# the two packages, both ways
# ---------------------------------------------------------------------------


def _states(quantize_moments: bool):
    """The same ``{"params", "opt"}`` train state in both packages: qwen2's
    bf16 smoke parameters, AdamW moments filled with seeded values (int8
    ``nu`` and f32 ``nu_scale`` when quantized) and step 5."""
    _, _, jp, npp, tp = ref_and_port("qwen2-0.5b", "bfloat16")
    jcfg = JA.AdamWConfig(quantize_moments=quantize_moments)
    tcfg = TA.AdamWConfig(quantize_moments=quantize_moments)
    js, ts = JA.init(jp, jcfg), TA.init(tp, tcfg)
    rng = np.random.default_rng(5)

    def fill(jtree, ttree):
        vals = {}
        for (kp, j), (_, t) in zip(jax.tree_util.tree_flatten_with_path(
                jtree)[0], tree_flatten_with_path(ttree)):
            v = (rng.integers(-127, 128, j.shape).astype(np.int8)
                 if j.dtype == jnp.int8 else
                 rng.standard_normal(j.shape).astype(np.float32))
            vals[jax.tree_util.keystr(kp)] = v
            t.copy_(torch.from_numpy(np.asarray(v)))
        return jax.tree_util.tree_map_with_path(
            lambda kp, j: jnp.asarray(vals[jax.tree_util.keystr(kp)]), jtree)

    js = js._replace(step=jnp.asarray(5, jnp.int32), mu=fill(js.mu, ts.mu),
                     nu=fill(js.nu, ts.nu),
                     nu_scale=(fill(js.nu_scale, ts.nu_scale)
                               if quantize_moments else None))
    ts = ts._replace(step=torch.tensor(5, dtype=torch.int32))
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _assert_same_state(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree_flatten_with_path(ttree)
    assert [jax.tree_util.keystr(kp) for kp, _ in jl] == [p for p, _ in tl]
    for (kp, j), (path, t) in zip(jl, tl):
        j = np.asarray(j)
        assert str(t.dtype) == f"torch.{j.dtype}", path
        assert tuple(t.shape) == j.shape, path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                j.view(np.uint16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


@pytest.mark.parametrize("quantize_moments", [False, True])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path,
                                                     quantize_moments):
    jstate, tstate = _states(quantize_moments)
    JManager(str(tmp_path)).save(5, jstate, extra={"step": 5})
    tmpl = TA.tree_map(lambda t: torch.empty_like(t, device="meta"),
                       tstate["params"])
    tmpl = {"params": tmpl,
            "opt": TA.init(tmpl, TA.AdamWConfig(
                quantize_moments=quantize_moments))}
    got, extra = CheckpointManager(str(tmp_path)).restore(5, tmpl,
                                                          device="cpu")
    assert extra == {"step": 5}
    assert got["opt"].step.ndim == 0 and got["opt"].step.dtype == torch.int32
    assert (got["opt"].nu_scale is None) != quantize_moments
    _assert_same_state(jstate, got)


@pytest.mark.parametrize("quantize_moments", [False, True])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path,
                                                     quantize_moments):
    jstate, tstate = _states(quantize_moments)
    CheckpointManager(str(tmp_path)).save(5, tstate, extra={"step": 5})
    tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        jstate)
    got, extra = JManager(str(tmp_path)).restore(5, tmpl)
    assert extra == {"step": 5}
    _assert_same_state(got, tstate)


@pytest.mark.parametrize("quantize_moments", [False, True])
def test_both_packages_write_the_same_bytes(tmp_path, quantize_moments):
    jstate, tstate = _states(quantize_moments)
    a = JManager(str(tmp_path / "ref")).save(5, jstate, extra={"step": 5})
    b = CheckpointManager(str(tmp_path / "port")).save(5, tstate,
                                                       extra={"step": 5})
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and "manifest.json" in files
    differ = [f for f in files if not filecmp.cmp(
        os.path.join(a, f), os.path.join(b, f), shallow=False)]
    assert differ == []
    with open(os.path.join(b, "manifest.json")) as f:
        paths = json.load(f)["leaf_paths"]
    assert paths[:2] == ["['opt'].step",
                         "['opt'].mu['blocks']['b0']['attn']['bk']"]
    assert paths[-1].startswith("['params']")


def test_float8_lists_and_none_cross_byte_for_byte(tmp_path):
    """float8 leaves, stored as uint8 views, in a list beside a ``None``
    (no leaf): the same files from both packages, and each restores the
    other's."""
    f8 = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jtree = {"f8": [jnp.asarray(f8).astype(jnp.float8_e4m3fn), None,
                    (jnp.asarray(f8).astype(jnp.float8_e5m2),)],
             "w": jnp.asarray(f8)}
    ttree = {"f8": [torch.from_numpy(f8).to(torch.float8_e4m3fn), None,
                    (torch.from_numpy(f8).to(torch.float8_e5m2),)],
             "w": torch.from_numpy(f8)}
    a = JManager(str(tmp_path / "ref")).save(1, jtree)
    b = CheckpointManager(str(tmp_path / "port")).save(1, ttree)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) == 4
    assert [f for f in files if not filecmp.cmp(
        os.path.join(a, f), os.path.join(b, f), shallow=False)] == []
    with open(os.path.join(b, "manifest.json")) as f:
        assert json.load(f)["leaf_paths"] == ["['f8'][0]", "['f8'][2][0]",
                                              "['w']"]
    got, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        1, ttree, device="cpu")
    assert got["f8"][1] is None and isinstance(got["f8"][2], tuple)
    for x, y in zip(_leaves(got), _leaves(ttree)):
        assert x.dtype == y.dtype
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    back, _ = JManager(str(tmp_path / "port")).restore(1, jtree)
    assert np.asarray(back["f8"][2][0]).dtype == ml_dtypes.float8_e5m2
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8),
                                      np.asarray(y).view(np.uint8))


def test_int8_weights_cross_both_ways(tmp_path):
    """A quantized weight tree (``QTensor`` leaves, q and scale in order)
    written by either package restores in the other bit for bit."""
    _, _, jp, _, tp = ref_and_port("llama3.2-1b", "float32")
    jq, tq = JQ.quantize_params(jp), TQ.quantize_params(tp)
    JManager(str(tmp_path / "ref")).save(1, jq)
    CheckpointManager(str(tmp_path / "port")).save(1, tq)
    got, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        1, tq, device="cpu")
    assert isinstance(got["embed"], TQ.QTensor)
    for x, y in zip(_leaves(got), _leaves(tq)):
        assert torch.equal(x, y)
    back, _ = JManager(str(tmp_path / "port")).restore(1, jq)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
