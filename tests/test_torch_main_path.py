"""The slice as a whole, on the CPU: build → compile → run → serve in the
port (``device="cpu"``: the kernels' plain versions) against the
reference package (its Pallas kernel in interpret mode) on the same
NumPy env.  The data is int32, so every comparison is bit-exact; the one
float test states its tolerance."""
import queue

import numpy as np
import pytest
import torch

import repro.api as japi

import repro_torch
import repro_torch.api as tapi
from repro_torch.kernels import ops as tops
from repro_torch.passes import interp as tinterp
from repro_torch.serve import (ArtifactCache, ServeConfig, ServeEngine,
                               run_load)

from _torch_port import TARGETS, compiled_pair, int_env

ZOO = ["lenet5", "tiny_vgg_32", "edge_residual_32", "resnet_mini_16"]
OTHERS = ["fat_conv_16", "fat_cascade_16", "conv_pool_32", "conv_avgpool_32",
          "residual_block_32", "feed_forward"]


def _batched(inputs, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(-4, 5, size=(n,) + v.shape).astype(v.dtype)
            for k, v in inputs.items()}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", ZOO + OTHERS)
def test_run_equals_reference(name, target):
    ja, ta = compiled_pair(name, target)
    inputs, params = int_env(ja.source, seed=20)
    want = np.asarray(ja.run(inputs, params))
    got = ta.run(inputs, params, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # ... and the compiled schedule equals the port's own interpreter
    ref = tinterp.graph_outputs(ta.source, {**inputs, **params}, device="cpu")
    np.testing.assert_array_equal(got, ref[ta.source.graph_outputs[0]].numpy())


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", ZOO + ["fat_cascade_16"])
def test_batched_equals_loop_equals_reference(name, target):
    ja, ta = compiled_pair(name, target)
    inputs, params = int_env(ja.source, seed=21)
    xb = _batched(inputs, 5, seed=22)          # ragged: pads to bucket 8
    vm = ta.run(xb, params, device="cpu", batch_mode="vmap")
    assert ta.last_run_stats["batch_mode"] == "vmap"
    assert ta.last_run_stats["batch_buckets"] == [8]
    lp = ta.run(xb, params, device="cpu", batch_mode="loop")
    assert ta.last_run_stats["batch_mode"] == "loop"
    np.testing.assert_array_equal(vm, lp)
    np.testing.assert_array_equal(vm, np.asarray(ja.run(xb, params)))


def test_batch_over_the_top_bucket_chunks():
    ja, ta = compiled_pair("lenet5", "kv260")
    inputs, params = int_env(ja.source, seed=23)
    n = tops.BATCH_BUCKETS[-1] + 3
    xb = _batched(inputs, n, seed=24)
    vm = ta.run(xb, params, device="cpu")
    assert vm.shape[0] == n
    assert ta.last_run_stats["batch_buckets"] == [64, 4]
    assert ta.last_run_stats["samples"] == n
    np.testing.assert_array_equal(vm, np.asarray(ja.run(xb, params)))
    # prefix consistency: a sample's answer does not depend on its batch
    np.testing.assert_array_equal(
        vm[:3], ta.run({k: v[:3] for k, v in xb.items()}, params,
                       device="cpu"))


def test_int8_model_accumulates_in_int32_batched_and_looped():
    ja, ta = compiled_pair("conv_relu_32", "kv260")
    inputs, params = int_env(ja.source, seed=25, dtype=np.int8)
    xb = _batched(inputs, 5, seed=26)
    want = np.asarray(ja.run(xb, params, batch_mode="loop"))
    got = ta.run(xb, params, device="cpu", batch_mode="vmap")
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ta.run(xb, params, device="cpu", batch_mode="loop"))


def test_float_model_close_to_reference():
    """f32: atol 1e-4, rtol 1e-2 (summation order differs)."""
    ja, ta = compiled_pair("tiny_vgg_32", "kv260")
    rng = np.random.default_rng(27)
    src = ja.source
    inputs = {k: rng.standard_normal(src.values[k].shape).astype(np.float32)
              for k in src.graph_inputs}
    params = {n: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for n, v in src.values.items() if v.is_constant}
    got = ta.run(inputs, params, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ja.run(inputs, params)),
                               atol=1e-4, rtol=1e-2)


def test_weight_tiled_equals_untiled():
    """fat_conv streams its weights in 6 Cout tiles on KV260 and keeps
    them resident on ZU3EG: the same numbers either way."""
    _, kv = compiled_pair("fat_conv_16", "kv260")
    _, zu = compiled_pair("fat_conv_16", "zu3eg")
    assert any(t > 1 for g in kv.design.groups
               for t in g.dse.weight_tiles.values())
    assert all(t == 1 for g in zu.design.groups
               for t in g.dse.weight_tiles.values())
    inputs, params = int_env(kv.source, seed=28)
    np.testing.assert_array_equal(kv.run(inputs, params, device="cpu"),
                                  zu.run(inputs, params, device="cpu"))


def test_partitioned_design_chains_groups():
    tb = tapi
    net = tb.suite()["deep_cascade_32"]()
    whole = tb.compile_graph(net, target="kv260")
    # a tight custom budget forces a multi-group schedule with spills
    from repro_torch.core.compile_driver import Target

    cut = tb.compile_graph(
        tb.suite()["deep_cascade_32"](),
        tb.CompileOptions(target=Target("tight", b_total=40, d_total=1248)))
    assert len(cut.design.groups) > 1 and cut.design.spills()
    inputs, params = int_env(whole.source, seed=29)
    np.testing.assert_array_equal(whole.run(inputs, params, device="cpu"),
                                  cut.run(inputs, params, device="cpu"))
    xb = _batched(inputs, 3, seed=30)
    np.testing.assert_array_equal(
        cut.run(xb, params, device="cpu", batch_mode="vmap"),
        cut.run(xb, params, device="cpu", batch_mode="loop"))


class TestArtifactSurface:
    def test_top_level_reexports(self):
        assert repro_torch.compile_graph is tapi.compile_graph
        assert "params_from_numpy" in tapi.__all__
        assert set(repro_torch.suite()) == set(japi.suite())

    def test_params_from_numpy_keeps_dtypes(self):
        env = {"a": np.zeros((2, 3), np.int8), "b": np.ones(4, np.int32),
               "c": np.ones(4, np.float32), "d": np.arange(3),
               "e": np.ones(2, np.float64), "f": np.zeros(2, np.uint8),
               "g": np.zeros(2, np.int16)}
        out = tapi.params_from_numpy(env, device="cpu")
        assert [out[k].dtype for k in "abcdefg"] == [
            torch.int8, torch.int32, torch.float32, torch.int32,
            torch.float32, torch.uint8, torch.int16]
        assert all(v.device.type == "cpu" for v in out.values())

    def test_tensor_params_and_run_tensors(self):
        ja, ta = compiled_pair("conv_pool_32", "kv260")
        inputs, params = int_env(ja.source, seed=31)
        tparams = tapi.params_from_numpy(params, device="cpu")
        out = ta.run_tensors(inputs, tparams, device="cpu")
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(ja.run(inputs, params)))

    def test_random_smoke_run_and_stats(self):
        _, ta = compiled_pair("lenet5", "kv260")
        a = ta.run(device="cpu", seed=5)
        b = ta.run(device="cpu", seed=5)
        np.testing.assert_array_equal(a, b)
        st = ta.last_run_stats
        assert st["samples"] == 1 and len(st["groups"]) == 1
        assert st["groups"][0]["jit_cache"] in ("hit", "miss")
        assert set(st["exec_cache_total"]) == {"hits", "misses", "evictions"}
        assert "last run" in str(ta.report())

    def test_input_validation(self):
        _, ta = compiled_pair("lenet5", "kv260")
        with pytest.raises(ValueError, match="batch_mode"):
            ta.run(device="cpu", batch_mode="scan")
        with pytest.raises(KeyError):
            ta.run({"nope": np.zeros((1, 32, 32, 1), np.int32)}, device="cpu")
        with pytest.raises(ValueError, match="shape"):
            ta.run(np.zeros((32, 32), np.int32), device="cpu")
        with pytest.raises(KeyError, match="not a constant"):
            ta.run(params={"ghost": np.zeros(1, np.int32)}, device="cpu")

    def test_save_load_round_trip(self, tmp_path):
        _, ta = compiled_pair("tiny_vgg_32", "zu3eg")
        path = ta.save(str(tmp_path / "a.pkl"))
        back = tapi.CompiledArtifact.load(path)
        assert back.report() == ta.report()
        inputs, params = int_env(ta.source, seed=32)
        np.testing.assert_array_equal(back.run(inputs, params, device="cpu"),
                                      ta.run(inputs, params, device="cpu"))

    def test_emit_hls_writes_the_reference_files(self, tmp_path):
        ja, ta = compiled_pair("lenet5", "kv260")
        jp = ja.emit_hls(str(tmp_path / "j"))
        tp = ta.emit_hls(str(tmp_path / "t"))
        assert [p.split("/")[-1] for p in jp] == [p.split("/")[-1] for p in tp]
        for a, b in zip(jp, tp):
            assert open(a).read() == open(b).read()

    def test_traced_run_emits_runtime_series(self):
        art = tapi.compile_graph(tapi.suite()["conv_relu_32"](),
                                 tapi.CompileOptions(trace=True))
        art.run(device="cpu")
        names = {e["name"] for e in art.tracer.events}
        assert "jit_cache" in names and any(n.startswith("run:") for n in names)
        tapi.validate_chrome_trace({"traceEvents": art.tracer.events})


    def test_ambient_registry_gets_the_run_series(self):
        import repro_torch.instrument as tinstr

        _, ta = compiled_pair("conv_pool_32", "kv260")
        inputs, params = int_env(ta.source, seed=37)
        plain = ta.run(inputs, params, device="cpu")
        reg = tinstr.MetricsRegistry()
        with tinstr.use_metrics(reg):
            metered = ta.run(inputs, params, device="cpu")
            ta.run(_batched(inputs, 3, seed=38), params, device="cpu")
        np.testing.assert_array_equal(plain, metered)   # metrics change nothing
        snap = reg.snapshot()
        tinstr.validate_metrics_snapshot(snap)
        walls = snap["histograms"]["run_group_wall_ms"]["values"]
        assert sum(r["count"] for r in walls) == 2 * len(ta.design.groups)


class TestExecCache:
    def test_one_build_per_group_and_bucket(self, monkeypatch):
        ta = tapi.compile_graph(tapi.suite()["cascade_conv_32"](),
                                target="zu3eg")
        inputs, params = int_env(ta.source, seed=33)
        calls = []
        real = tops._build_group_fn

        def probe(group, batch=None):
            calls.append((group.name, batch))
            return real(group, batch=batch)

        with tops._EXEC_CACHE_LOCK:
            tops._EXEC_CACHE.clear()
        monkeypatch.setattr(tops, "_build_group_fn", probe)
        for n in (3, 4, 3, 7, 8):
            ta.run(_batched(inputs, n, seed=n), params, device="cpu")
        assert sorted(calls) == [(g.name, b) for b in (4, 8)
                                 for g in ta.design.groups]
        ta.run(inputs, params, device="cpu")
        ta.run(inputs, params, device="cpu")
        assert calls.count((ta.design.groups[0].name, None)) == 1

    def test_lru_evicts_beyond_the_cap(self, monkeypatch):
        ta = tapi.compile_graph(tapi.suite()["conv_relu_32"](), target="kv260")
        g = ta.design.groups[0]
        with tops._EXEC_CACHE_LOCK:
            tops._EXEC_CACHE.clear()
        monkeypatch.setattr(tops, "_EXEC_CACHE_CAP", 2)
        before = dict(tops.exec_cache_stats)
        tops.lower_group(g, batch=1)
        tops.lower_group(g, batch=2)
        tops.lower_group(g, batch=1)          # refresh
        tops.lower_group(g, batch=4)          # evicts batch=2
        tops.lower_group(g, batch=1)
        tops.lower_group(g, batch=2)          # rebuilt
        d = {k: tops.exec_cache_stats[k] - before[k] for k in before}
        assert d == {"hits": 2, "misses": 4, "evictions": 2}
        assert len(tops._EXEC_CACHE) == 2

    def test_batch_bucket_rules(self):
        assert [tops.batch_bucket(n) for n in (1, 2, 3, 5, 33, 64)] == \
            [1, 2, 4, 8, 64, 64]
        with pytest.raises(ValueError):
            tops.batch_bucket(0)
        with pytest.raises(ValueError):
            tops.batch_bucket(65)
        assert list(tops._batch_chunks(130)) == [(0, 64, 64), (64, 64, 64),
                                                 (128, 2, 2)]


class TestServeEngine:
    @pytest.mark.parametrize("name", ["lenet5", "resnet_mini_16"])
    def test_answers_equal_direct_runs(self, name):
        _, ta = compiled_pair(name, "kv260")
        inputs, params = int_env(ta.source, seed=34)
        rng = np.random.default_rng(35)
        key = ta.source.graph_inputs[0]
        xs = [rng.integers(-4, 5, size=inputs[key].shape).astype(np.int32)
              for _ in range(40)]
        cfg = ServeConfig(max_batch=8, latency_budget_ms=20.0)
        with ServeEngine(ta, cfg, params=params, device="cpu") as eng:
            futs = [eng.submit(x) for x in xs]
            outs = [f.result(timeout=120) for f in futs]
            # constants were moved to the device once, at start()
            assert all(isinstance(v, torch.Tensor)
                       for v in eng._params_resolved.values())
        for x, y in zip(xs, outs):
            np.testing.assert_array_equal(y, ta.run(x, params, device="cpu"))
        st = eng.stats
        assert st["requests"] == 40 and st["rejected"] == 0
        assert 1 < st["max_batch_seen"] <= 8
        stages = {r["labels"]["stage"]: r["count"] for r in
                  eng.metrics()["histograms"]["serve_stage_ms"]["values"]}
        assert set(stages) == {"queue_wait", "batch_form", "execute", "respond"}
        assert stages["queue_wait"] == 40
        rec = eng.flight_records()
        assert rec and all(r["outcome"] == "ok" for r in rec)

    def test_engine_equals_reference_package(self):
        ja, ta = compiled_pair("tiny_vgg_32", "kv260")
        inputs, params = int_env(ja.source, seed=36)
        with ServeEngine(ta, params=params, device="cpu") as eng:
            got = eng(inputs[ta.source.graph_inputs[0]])
        np.testing.assert_array_equal(got, np.asarray(ja.run(inputs, params)))

    def test_stop_drains_the_queue(self):
        _, ta = compiled_pair("lenet5", "kv260")
        eng = ServeEngine(ta, ServeConfig(max_batch=2, latency_budget_ms=0.0),
                          device="cpu").start()
        x = np.zeros(ta.source.values[ta.source.graph_inputs[0]].shape, np.int32)
        futs = [eng.submit(x) for _ in range(30)]
        eng.stop()
        done = sum(1 for f in futs if f.exception() is None)
        failed = [f for f in futs if f.exception() is not None]
        assert done + len(failed) == 30      # nobody is left hanging
        assert all(isinstance(f.exception(), RuntimeError) for f in failed)
        with pytest.raises(RuntimeError, match="not started"):
            eng.submit(x)

    def test_a_dead_worker_fails_its_callers_instead_of_hanging(self):
        import threading

        _, ta = compiled_pair("lenet5", "kv260")
        eng = ServeEngine(ta, device="cpu")
        go = threading.Event()

        def die():
            go.wait(30)
            raise MemoryError("boom")

        eng._serve_batches = die
        eng.start()
        fut = eng.submit(np.zeros((1, 32, 32, 1), np.int32))
        go.set()
        with pytest.raises(RuntimeError, match="serve worker died"):
            fut.result(timeout=60)
        eng.stop()

    def test_admission_rejects_a_bad_shape(self):
        _, ta = compiled_pair("lenet5", "kv260")
        with ServeEngine(ta, device="cpu") as eng:
            with pytest.raises(ValueError, match="per-sample shape"):
                eng.submit(np.zeros((2, 32, 32, 1), np.int32))
            with pytest.raises(ValueError, match="graph"):
                eng.submit({"bogus": np.zeros((1, 32, 32, 1), np.int32)})
            good = eng(np.ones((1, 32, 32, 1), np.int32))
            assert good.shape == (1, 10)
            snap = eng.metrics()
        rej = {r["labels"]["cause"]: r["value"] for r in
               snap["counters"]["serve_rejected_total"]["values"]}
        assert rej.get("invalid") == 2

    def test_queue_full_rejects(self):
        _, ta = compiled_pair("lenet5", "kv260")
        cfg = ServeConfig(max_batch=1, latency_budget_ms=0.0, queue_depth=1)
        x = np.zeros((1, 32, 32, 1), np.int32)
        with ServeEngine(ta, cfg, device="cpu") as eng:
            saw_full = False
            futs = []
            for _ in range(200):
                try:
                    futs.append(eng.submit(x))
                except queue.Full:
                    saw_full = True
                    break
            for f in futs:
                f.result(timeout=120)
        assert saw_full

    def test_run_load_report(self):
        _, ta = compiled_pair("resnet_mini_16", "zu3eg")
        with ServeEngine(ta, ServeConfig(max_batch=16, latency_budget_ms=2.0),
                         device="cpu") as eng:
            rep = run_load(eng, offered_qps=400, requests=48, seed=1)
        assert rep.requests == 48 and rep.rejected == 0
        assert rep.p99_ms >= rep.p50_ms > 0 and rep.batches >= 3
        assert set(rep.row()) >= {"achieved_qps", "p50_ms", "p99_ms",
                                  "mean_batch"}

    def test_artifact_cache_lru(self):
        cache = ArtifactCache(capacity=2)
        opts = tapi.CompileOptions(target="kv260")
        make = tapi.suite()["conv_relu_32"]
        a = cache.get_or_compile("conv_relu_32", make, opts)
        b = cache.get_or_compile("conv_relu_32", make, opts)
        assert a is b and cache.stats["hits"] == 1
        for other in ("conv_pool_32", "conv_avgpool_32"):
            cache.get_or_compile(other, tapi.suite()[other], opts)
        assert len(cache) == 2 and cache.stats["evictions"] == 1
        np.testing.assert_array_equal(a.run(device="cpu"), b.run(device="cpu"))
