"""``python -m repro_torch`` against ``python -m repro`` on the CPU: the
same stdout (``repro`` read as ``repro_torch``, the pass timings left
out), the same documents and the same exit codes; ``--run`` and
``profile`` run on the host only when asked with ``--device cpu`` and
otherwise exit 1 naming the missing card."""
import json
import os
import re

import pytest
import torch

from repro.__main__ import main as jmain
from repro.frontends import zoo as jzoo

from repro_torch.__main__ import main as tmain
from repro_torch.instrument import profiler as tprofiler

from _torch_port import REPO, TARGETS

ZOO = sorted(jzoo.ZOO)
LENET_CARD = os.path.join(REPO, "examples", "lenet5.json")
LENET_ONNX = os.path.join(REPO, "tests", "golden", "lenet5.onnx")
RESNET_ONNX = os.path.join(REPO, "tests", "golden", "resnet_tiny.onnx")


@pytest.fixture(autouse=True)
def _fresh_exec_caches():
    """A compile report prints its package's process-wide jit-cache
    counts: both packages start each test from an empty cache, so that
    what other test files ran in this worker process does not enter the
    comparison."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    for ops in (jops, tops):
        with ops._EXEC_CACHE_LOCK:
            ops._EXEC_CACHE.clear()
            ops.exec_cache_stats.update(hits=0, misses=0, evictions=0)


def _call(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _as_port(text: str) -> str:
    """The reference's output as the port prints it: its name in the
    commands and modules it names, no pass timings (the one line that
    holds them)."""
    text = re.sub(r"(?<![\w/-])repro(?=[. ])", "repro_torch", text)
    return "\n".join(line for line in text.split("\n")
                     if not re.match(r"\s+passes: .* ms total", line))


def test_list_prints_the_same(capsys):
    want = _call(jmain, ["list"], capsys)
    got = _call(tmain, ["list"], capsys)
    assert got == (want[0], _as_port(want[1]), want[2]) and got[0] == 0


def test_zoo_prints_and_exports_the_same(tmp_path, capsys):
    jrc, jout, _ = _call(jmain, ["zoo", "--export", str(tmp_path / "j")],
                         capsys)
    trc, tout, _ = _call(tmain, ["zoo", "--export", str(tmp_path / "t")],
                         capsys)
    assert trc == jrc == 0
    assert tout.replace(str(tmp_path / "t"), "D") == _as_port(
        jout.replace(str(tmp_path / "j"), "D"))
    assert sorted(os.listdir(tmp_path / "t")) == [f"{m}.json" for m in ZOO]
    for name in ZOO:
        assert (tmp_path / "t" / f"{name}.json").read_text() == (
            tmp_path / "j" / f"{name}.json").read_text()


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", ZOO)
def test_compile_report_prints_the_same(name, target, capsys):
    argv = ["compile", name, "--target", target]
    want = _call(jmain, argv, capsys)
    got = _call(tmain, argv, capsys)
    assert got[0] == want[0] == 0
    assert _as_port(got[1]) == _as_port(want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("model", [LENET_ONNX, RESNET_ONNX, LENET_CARD],
                         ids=os.path.basename)
def test_compile_run_of_a_model_file_prints_the_same(model, capsys):
    """An imported model (ONNX golden, model card) compiled and run: the
    reference in interpret mode, the port on the host when asked."""
    want = _call(jmain, ["compile", model, "--run"], capsys)
    got = _call(tmain, ["compile", model, "--run", "--device", "cpu"],
                capsys)
    assert got[0] == want[0] == 0
    assert _as_port(got[1]) == _as_port(want[1])
    assert "ran OK: output shape (1, 10) dtype int32" in got[1]


def test_compile_emit_writes_the_same_files(tmp_path, capsys):
    argv = ["compile", "deep_cascade_224", "--quiet", "--emit"]
    assert _call(jmain, argv + [str(tmp_path / "j")], capsys)[0] == 0
    rc, out, _ = _call(tmain, argv + [str(tmp_path / "t"), "--trace",
                                      str(tmp_path / "t.json")], capsys)
    assert rc == 0 and f"trace written {tmp_path / 't.json'}" in out
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files and len(files) > 2
    for f in files:
        assert (tmp_path / "t" / f).read_text() == (
            tmp_path / "j" / f).read_text(), f
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["traceEvents"]


def test_lint_all_writes_the_same_document(tmp_path, capsys):
    argv = ["lint", "--all", "--target", "kv260", "--target", "zu3eg",
            "--quiet", "--json"]
    jrc = _call(jmain, argv + [str(tmp_path / "j.json")], capsys)[0]
    trc = _call(tmain, argv + [str(tmp_path / "t.json")], capsys)[0]
    assert trc == jrc == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    want.pop("provenance", None)
    got.pop("provenance", None)
    assert got == want and got["diagnostics"]


#: every exit-code case of the reference's CLI tests (``{tmp}``: the
#: test's directory, which holds a ``model.txt`` and a ``model.json/``)
EXIT_CASES = {
    "list": ["list"],
    "compile_and_emit": ["compile", "conv_relu_32", "--target", "zu3eg",
                         "--emit", "{tmp}/hls"],
    "unknown_graph": ["compile", "resnet152"],
    "card_file_run": ["compile", LENET_CARD, "--run", "--quiet"],
    "onnx_file_run": ["compile", LENET_ONNX, "--run", "--quiet"],
    "zoo_export": ["zoo", "--export", "{tmp}/cards"],
    "unknown_extension": ["compile", "{tmp}/model.txt"],
    "directory_path": ["compile", "{tmp}/model.json"],
    "unknown_target": ["compile", "conv_relu_32", "--target", "vu9p"],
    "infeasible": ["compile", "fat_conv_16", "--weight-streaming", "off",
                   "--quiet"],
    "missing_card_file": ["compile", "examples/lent5.json"],
    "lint_nothing": ["lint"],
    "lint_fails_on_info": ["lint", "conv_relu_32", "--fail-on", "info",
                           "--quiet"],
}


@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_exit_code_is_the_same(case, tmp_path, monkeypatch, capsys):
    """The same code and stderr (the port adds ``--device cpu`` to
    ``--run``)."""
    monkeypatch.chdir(REPO)
    (tmp_path / "model.txt").write_text("nope")
    (tmp_path / "model.json").mkdir()
    argv = [a.replace("{tmp}", str(tmp_path)) for a in EXIT_CASES[case]]
    jrc, _, jerr = _call(jmain, argv, capsys)
    targv = argv + (["--device", "cpu"] if "--run" in argv else [])
    trc, _, terr = _call(tmain, targv, capsys)
    assert trc == jrc, (terr, jerr)
    assert terr == _as_port(jerr)


def test_suite_name_wins_over_cwd_entry(tmp_path, monkeypatch, capsys):
    (tmp_path / "conv_relu_32").mkdir()
    monkeypatch.chdir(tmp_path)
    assert _call(tmain, ["compile", "conv_relu_32", "--quiet"], capsys)[0] == 0


def test_bad_device_is_a_bad_argument(capsys):
    with pytest.raises(SystemExit) as e:
        tmain(["compile", "lenet5", "--run", "--device", "tpu0"])
    assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["compile", "lenet5", "--run"],
                                  ["profile", "lenet5"],
                                  ["profile", LENET_ONNX, "--target", "zu3eg"]],
                         ids=["compile_run", "profile", "profile_onnx"])
def test_without_a_card_run_and_profile_exit_1(argv, monkeypatch, capsys):
    """No card and no ``--device cpu``: exit 1, the missing device named,
    nothing run (the conv wrapper's counters stay put)."""
    from repro_torch.kernels import conv2d_stream as cs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (cs.launches, cs.plain_cuda_calls)
    rc, out, err = _call(tmain, argv, capsys)
    assert rc == 1
    assert "CUDA device" in err and "--device cpu" in err
    assert "ran OK" not in out and "profile:" not in out
    assert (cs.launches, cs.plain_cuda_calls) == before


#: the columns of a profile's rows that come from the model, not a clock
MODELED_GROUP = ("group", "nodes", "modeled_cycles", "modeled_ms",
                 "dma_write_bytes", "dma_read_bytes", "macs", "dsp", "bram",
                 "roofline_util")
MODELED_LAYER = ("name", "group", "modeled_cycles", "share", "macs", "dsp",
                 "bram", "fill")


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", ZOO)
def test_profile_document_matches_the_reference(name, target, tmp_path,
                                                capsys):
    argv = ["profile", name, "--target", target, "--reps", "1",
            "--warmup", "0", "--json"]
    jrc, jout, _ = _call(jmain, argv + [str(tmp_path / "j.json")], capsys)
    trc, tout, _ = _call(tmain, argv + [str(tmp_path / "t.json"),
                                        "--device", "cpu"], capsys)
    assert trc == jrc == 0
    assert f"profile: {name} @ {target}  (clock 300 MHz, 1 reps, cpu)" in tout
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert sorted(got) == sorted(want) == [
        "graph", "profiles", "provenance", "version"]
    assert (got["version"], got["graph"]) == (want["version"], want["graph"])
    assert "device" not in got["provenance"]          # none on the host
    (jp,), (tp,) = want["profiles"], got["profiles"]
    assert jp.pop("interpret") is True and tp.pop("device") == "cpu"
    assert sorted(tp) == sorted(jp)
    for key in ("version", "model", "target", "clock_mhz", "threshold",
                "reps", "total_modeled_cycles"):
        assert tp[key] == jp[key], key
    assert [sorted(r) for r in tp["groups"]] == [
        sorted(r) for r in jp["groups"]]
    for tr, jr in zip(tp["groups"], jp["groups"]):
        assert jr["roofline_util"] is not None
        assert {k: tr[k] for k in MODELED_GROUP} == {
            k: jr[k] for k in MODELED_GROUP}
        assert tr["measured_ms"] > 0 and tr["implied_clock_mhz"] > 0
    assert [{k: r[k] for k in MODELED_LAYER} for r in tp["layers"]] == [
        {k: r[k] for k in MODELED_LAYER} for r in jp["layers"]]
    for g in tp["groups"]:
        attributed = sum(n["attributed_ms"] for n in tp["layers"]
                         if n["group"] == g["group"])
        assert attributed == pytest.approx(g["measured_ms"], abs=0.05)


def test_edge_roofline_helper_equals_the_reference():
    from benchmarks.roofline import edge_ideal_cycles

    for macs, dma, d_total, bits in ((249600, 0, 1248, 8),
                                     (0, 1600, 1248, 8),
                                     (249600, 160000, 1248, 8),
                                     (123457, 999, 360, 16),
                                     (10 ** 9, 3, 360, 32), (0, 0, 360, 8)):
        assert tprofiler.edge_ideal_cycles(
            macs, dma, d_total=d_total, elem_bits=bits) == edge_ideal_cycles(
            macs, dma, d_total=d_total, elem_bits=bits)
    with pytest.raises(ValueError, match="d_total"):
        tprofiler.edge_ideal_cycles(1, 1, d_total=0)
    assert tprofiler._roofline_util(0, 0, 100, 360) == 0.0
    assert tprofiler._roofline_util(10 ** 9, 0, 100, 360) == 1.0


def test_profile_argument_validation():
    from repro_torch.api import compile_graph, suite
    from repro_torch.instrument import profile_artifact

    art = compile_graph(suite()["lenet5"]())
    with pytest.raises(ValueError, match="reps"):
        profile_artifact(art, reps=0, device="cpu")
    with pytest.raises(ValueError, match="threshold"):
        profile_artifact(art, threshold=1.0, device="cpu")
    with pytest.raises(ValueError, match="clock"):
        profile_artifact(art, clock_mhz=0, device="cpu")
    rep = profile_artifact(art, reps=1, warmup=0, threshold=1000.0,
                           device="cpu")
    assert rep.device == "cpu" and rep.flagged == []
    assert "modeled_cyc" in rep.format_table()


@pytest.mark.parametrize("batched", [False, True], ids=["run", "batched"])
def test_timed_run_synchronizes_after_each_group(batched, monkeypatch):
    """The profiler reads each group's wall from ``stats_out``: the device
    is synchronized after each group, as the reference blocks on each
    group's outputs, and nowhere else; an untimed run never waits."""
    import numpy as np

    from repro_torch.api import compile_graph, suite
    from repro_torch.kernels import ops

    art = compile_graph(suite()["deep_cascade_224"](), target="kv260")
    design = art.design
    events = []
    lower = ops.lower_group

    def traced_lower(g, **kw):
        fn = lower(g, **kw)
        return lambda env: (events.append(g.name), fn(env))[1]

    monkeypatch.setattr(ops, "synchronize", lambda dev: events.append("sync"))
    monkeypatch.setattr(ops, "lower_group", traced_lower)
    src = design.source
    # the smallest env the schedule's shapes allow: it never runs a conv
    monkeypatch.setattr(ops, "_lower_node",
                        lambda op, dfg, env, weight_tiles=1: torch.zeros(
                            (next(iter(env.values())).shape[0],)
                            + tuple(dfg.values[op.output].shape)))
    env = {k: np.zeros(src.values[k].shape, np.int32)
           for k in src.graph_inputs}
    run = ((lambda **kw: ops.run_compiled_batched(
        design, {k: v[None] for k, v in env.items()}, 1, device="cpu", **kw))
        if batched else
        (lambda **kw: ops.run_compiled(design, env, device="cpu", **kw)))
    run()
    assert "sync" not in events
    events.clear()
    run(stats_out={})
    names = [g.name for g in design.groups]
    assert events == [e for n in names for e in (n, "sync")]
