"""The port's four examples (``examples/*_torch.py``) run on the CPU
(``--device cpu``) and held against the reference package.

* ``quickstart_torch``: the report (its measured telemetry lines aside)
  and every emitted HLS file are the reference's, byte for byte; the run
  is bit-exact with the port's interpreter and with the reference's on
  the same NumPy env; the saved artifact reloads.
* ``serve_batched_torch``: every burst answer equals the single-request
  answer and the reference engine's for its input, bit for bit; the
  trace validates and names the reference example's serve series.
* ``train_lm_torch``: the example's own run at a narrowed config (the
  full 46.1M-param f32 run takes ~10 s a step here): it ends, survives
  its crash (the replayed steps give the same bits), keeps the loss-fall
  check, and its first steps' losses are the reference's unsharded
  jitted train step's from the same starting params, in f32 at the f32
  train rule of ``test_torch_mesh_train.py`` (loss rtol 1e-5; the bf16
  rule of ``test_torch_train_launch.py`` is 3e-2).
* ``elastic_resilience_torch``: four gloo ranks crash-restart on a
  (2, 2) mesh, re-mesh to (4, 1), then one device; every rank logs the
  same losses and only rank 0 prints.

Every example also refuses to run without a card when no device is
named."""
import ast
import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax

from repro_torch.configs import registry as treg
from repro_torch.launch import train as TT
from repro_torch.passes import interp as tinterp
from repro_torch.serve import ServeEngine as TEngine

import chip_smoke
from _torch_port import REPO, strip_telemetry

EXAMPLES_DIR = os.path.join(REPO, "examples")
EXAMPLES = ("quickstart_torch", "serve_batched_torch", "train_lm_torch",
            "elastic_resilience_torch")


def example(name: str):
    """The example module ``examples/<name>.py`` (the directory on the
    path, so that the spawned ranks can import it too)."""
    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    return importlib.import_module(name)


@pytest.mark.parametrize("name", EXAMPLES)
def test_an_example_needs_a_card_unless_told_otherwise(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        example(name).main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _reference_quickstart_net():
    import repro

    return repro.Sequential(
        [repro.Conv2D(16), repro.ReLU(),
         repro.Residual([repro.Conv2D(16), repro.ReLU(), repro.Conv2D(16)]),
         repro.ReLU(), repro.AvgPool(2)],
        input_shape=(1, 32, 32, 16), name="quickstart_net")


def test_quickstart_equals_the_reference(tmp_path, capsys):
    import repro
    from repro.passes import interp as jinterp

    qs = example("quickstart_torch")
    out = {}
    assert qs.main(["--device", "cpu", "--outdir", str(tmp_path / "port")],
                   out=out) == 0
    printed = capsys.readouterr().out
    assert "bit-exact with the DFG interpreter" in printed
    assert "identical report" in printed.splitlines()[-1]

    jart = repro.compile_graph(_reference_quickstart_net(),
                               repro.CompileOptions(**qs.OPTIONS))
    art = out["art"]
    assert strip_telemetry(art.report()) == strip_telemetry(jart.report())
    ref_paths = jart.emit_hls(str(tmp_path / "ref"))
    assert sorted(map(os.path.basename, out["paths"])) == sorted(
        map(os.path.basename, ref_paths))
    for ref in ref_paths:
        with open(ref, "rb") as a, open(os.path.join(
                tmp_path, "port", os.path.basename(ref)), "rb") as b:
            assert a.read() == b.read(), ref

    # the run: the port's interpreter and the reference's, one NumPy env
    env = {k: v.numpy() for k, v in out["env"].items()}
    got = out["got"]
    assert got.dtype == np.int32 and got.shape == (1, 16, 16, 16)
    np.testing.assert_array_equal(got, out["want"])
    (want,) = tinterp.graph_outputs(art.design.original, env,
                                    device="cpu").values()
    np.testing.assert_array_equal(got, want.numpy())
    (jwant,) = jinterp.graph_outputs(jart.design.original, env).values()
    np.testing.assert_array_equal(got, np.asarray(jwant))

    again = type(art).load(out["saved"])
    assert strip_telemetry(again.report()) == strip_telemetry(art.report())
    np.testing.assert_array_equal(
        again.run({"x": env["x"]}, params=env, device="cpu"), got)
    # what chip_smoke.py's examples phase reads of this run
    assert chip_smoke.example_numbers("quickstart_torch", out) == {
        "bit_exact": True, "output_shape": [1, 16, 16, 16]}


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

def _reference_serve_series(capsys) -> list:
    """The serve series the reference example's trace names, from its
    last printed line."""
    capsys.readouterr()
    example("serve_batched").main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("chrome trace OK")
    return ast.literal_eval(last.split("serve series ", 1)[1])


def test_serve_batched_equals_the_reference(capsys):
    from repro.serve import ArtifactCache as JCache
    from repro.serve import ServeEngine as JEngine
    from repro.core.compile_driver import CompileOptions as JOptions
    from repro.frontends import zoo as jzoo

    sb = example("serve_batched_torch")
    out = {}
    assert sb.main(["--device", "cpu"], out=out) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("artifact cache: "
                        "{'hits': 1, 'misses': 1, 'evictions': 0}")
    assert lines[-1].startswith("chrome trace OK")
    assert out["stats"]["requests"] == 1 + sb.BURST
    rep = out["load"]
    assert rep.requests + rep.rejected == sb.LOAD["requests"]
    assert rep.p50_ms <= rep.p99_ms

    art, xs, outs = out["art"], out["xs"], out["outs"]
    assert len(outs) == sb.BURST
    # the engine's weights: the seeded fill of every constant
    consts = {n: v.numpy() for n, v in tinterp.random_env(
        art.source, seed=0, device="cpu").items()
        if art.source.values[n].is_constant}
    with TEngine(art, device="cpu") as one:
        single = [one(x) for x in [out["x"]] + xs]
    np.testing.assert_array_equal(single[0], out["y"])
    jart = JCache().get_or_compile(sb.MODEL, jzoo.ZOO[sb.MODEL],
                                   JOptions(target="kv260"))
    with JEngine(jart, sb.CONFIG, params=consts) as ref:
        futs = [ref.submit(x) for x in xs]
        want = [np.asarray(f.result(timeout=120)) for f in futs]
    for got, alone, jw in zip(outs, single[1:], want):
        assert got.dtype == alone.dtype == jw.dtype
        np.testing.assert_array_equal(got, alone)
        np.testing.assert_array_equal(got, jw)

    assert out["trace"]["traceEvents"]
    assert out["serve_events"] == _reference_serve_series(capsys)
    nums = chip_smoke.example_numbers("serve_batched_torch", out)
    assert nums["offered_qps"] == 200 and nums["achieved_qps"] > 0
    assert nums["burst_max_batch"] <= sb.CONFIG.max_batch


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

#: the CPU's cut of the example's config (the example's own function is
#: narrowed, its training run and arguments kept): 2 layers, d_model 64, heads
#: 8 / 4 as published, vocabulary 4096
NARROW = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
              d_ff=192, vocab_size=4096, attn_block_q=16, attn_block_k=16,
              loss_chunk=16)
#: enough steps for a checkpoint (every 50) before the crash (steps // 2)
LM_ARGS = dict(steps=120, batch=2, seq=64)
#: the first steps held to the reference
LM_REF_STEPS = 5


def _reference_losses(tcfg, steps: int) -> list:
    """The reference's unsharded jitted train step, from the params the
    port's ``train`` started from, over the reference's batches."""
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.configs.base import ShapeConfig as JShape
    from repro.data import pipeline as JP
    from repro.launch import steps as JS
    from repro.optim import adamw as JA

    jcfg = jreg.get_config("llama3.2-1b").with_(dtype="float32", **NARROW)
    for f in dataclasses.fields(jcfg):
        if f.name != "attn_impl" and hasattr(tcfg, f.name):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    run = TT.build_run(cfg=tcfg, ckpt_dir=None, lr=6e-4, device="cpu",
                       **LM_ARGS)
    _, (params, _) = run.fresh_state()
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    opt = JA.AdamWConfig(lr=6e-4, warmup_steps=max(LM_ARGS["steps"] // 20, 5),
                         total_steps=LM_ARGS["steps"])
    js = JA.init(jp, opt)
    step_fn = jax.jit(JS.make_train_step(jcfg, opt))
    shape = JShape("train_cli", LM_ARGS["seq"], LM_ARGS["batch"], "train")
    data = JP.DataConfig(seed=0, vocab_size=jcfg.vocab_size,
                         seq_len=LM_ARGS["seq"],
                         global_batch=LM_ARGS["batch"])
    losses = []
    for s in range(steps):
        jp, js, m = step_fn(jp, js, JP.batch_for_model(jcfg, shape, data, s))
        losses.append(float(m["loss"]))
    return losses


def test_train_lm_trains_through_its_crash_as_the_reference(monkeypatch,
                                                            capsys):
    tl = example("train_lm_torch")
    full = tl.example_config()
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.d_ff, full.vocab_size, full.dtype) == (
        4, 512, 8, 4, 1536, 32768, "float32")
    monkeypatch.setattr(tl, "example_config",
                        lambda: full.with_(**NARROW))
    out = {}
    argv = ["--device", "cpu"] + [a for k, v in LM_ARGS.items()
                                  for a in (f"--{k}", str(v))]
    assert tl.main(argv, out=out) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "OK — loss decreased")
    # the registry is as it was
    assert tl.ARCH not in treg.ARCHS
    assert treg.get_config("llama3.2-1b").num_layers == 16

    steps, fail_at = LM_ARGS["steps"], out["fail_at"]
    restored_from = fail_at // tl.CKPT_EVERY * tl.CKPT_EVERY
    losses = out["losses"]
    assert out["final_step"] == steps and fail_at == steps // 2
    assert restored_from > 0
    clean = losses[:fail_at] + losses[fail_at + fail_at - restored_from:]
    assert chip_smoke.restart_replays(clean, losses, fail_at=fail_at,
                                      restored_from=restored_from)
    assert all(np.isfinite(losses))
    assert out["last"] < out["first"] - 0.3

    nums = chip_smoke.example_numbers("train_lm_torch", out)
    assert nums["steps_run"] == len(losses) and nums["final_step"] == steps
    assert nums["tokens_per_s"] == pytest.approx(
        LM_ARGS["batch"] * LM_ARGS["seq"] / out["median_step_s"])

    ref = _reference_losses(out["cfg"], LM_REF_STEPS)
    np.testing.assert_allclose(losses[:LM_REF_STEPS], ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# elastic_resilience
# ---------------------------------------------------------------------------

def test_elastic_resilience_remeshes_a_crashed_run(capsys):
    el = example("elastic_resilience_torch")
    out = {}
    assert el.main(["--device", "cpu"], out=out) == 0
    printed = capsys.readouterr().out
    assert printed.strip().splitlines()[-1].startswith("OK — crash-restart")
    # rank 0 alone prints: each logged step once
    assert printed.count("[train] step    10 ") == 2   # the replay logs it
    assert printed.count("[train] step    30 ") == 1

    ranks = out["ranks"]
    assert len(ranks) == el.WORLD
    for got in ranks:
        p1, p2 = got["phase1"], got["phase2"]
        assert p1["final_step"] == 30 and p2["final_step"] == 45
        # crashed at 15, restored from 10: steps 10-14 again, same bits
        lk = p1["losses"]
        clean = lk[:15] + lk[20:]
        assert chip_smoke.restart_replays(clean, lk, fail_at=15,
                                          restored_from=10)
        assert len(p2["losses"]) == 15
        assert all(np.isfinite(lk + p2["losses"]))
        assert all(s > 0 for s in got["seconds"])
    for phase in ("phase1", "phase2"):
        assert all(r[phase]["losses"] == ranks[0][phase]["losses"]
                   for r in ranks[1:])
    p3 = out["phase3"]
    assert p3["final_step"] == 50 and len(p3["losses"]) == 5
    assert all(np.isfinite(p3["losses"]))
    assert [s for s, _ in out["watchdog"].flagged] == [12]
    assert not torch.distributed.is_initialized()
    nums = chip_smoke.example_numbers("elastic_resilience_torch", out)
    assert nums["final_steps"] == [30, 45, 50]
    assert nums["gloo_ranks_s"] > nums["phase1_s"] + nums["phase2_s"] > 0


@pytest.mark.parametrize("fault", ["failed", "hung"])
def test_elastic_a_failed_or_hung_rank_fails_the_run(monkeypatch, fault):
    """Three ranks cannot form the (2, 2) mesh: each fails, and the run
    raises with their tracebacks; ranks past the wall-time limit are
    killed and the run raises."""
    el = example("elastic_resilience_torch")
    if fault == "failed":
        monkeypatch.setattr(el, "WORLD", 3)
        with pytest.raises(RuntimeError, match="a \\(2, 2\\) mesh has 4"):
            el.main(["--device", "cpu"])
    else:
        monkeypatch.setattr(el, "RANKS_TIMEOUT_S", 1)
        with pytest.raises(TimeoutError, match="outlasted 1 s"):
            el.main(["--device", "cpu"])
