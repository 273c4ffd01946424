"""The port's front end against the reference's, on the CPU: the ONNX
reader (its vendored wire decoder, the import, the named errors), the
model-card format and the zoo's cards.  Both packages get the same bytes
and the same NumPy inputs; the port runs with ``device="cpu"`` (the
kernels' plain versions), the reference in interpret mode.  The data is
integer, so every comparison of outputs is bit-exact."""
import json
import os

import numpy as np
import pytest

import _onnx_fixture as fx
import test_onnx_reader as ref_onnx_tests
import repro.api as japi
import repro.frontends as jfe
from repro.frontends import onnx_reader as jonnx
from repro.frontends import zoo as jzoo

import repro_torch.api as tapi
import repro_torch.frontends as tfe
from repro_torch.core.analysis import reorder_spec
from repro_torch.frontends import onnx_reader as tonnx
from repro_torch.frontends import zoo as tzoo

from _torch_port import REPO, TARGETS

GOLDEN = os.path.join(REPO, "tests", "golden")
#: (file, NumPy oracle, its weights, input shape, input seed)
GOLDENS = {
    "lenet5": ("lenet5.onnx", fx.lenet5_numpy, fx.lenet5_weights,
               (1, 1, 32, 32), 7),
    "resnet_tiny": ("resnet_tiny.onnx", fx.resnet_tiny_numpy,
                    fx.resnet_tiny_weights, (1, 3, 16, 16), 17),
}


def _golden_path(name):
    return os.path.join(GOLDEN, GOLDENS[name][0])


def _golden_bytes(name):
    with open(_golden_path(name), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the wire decoder and the import
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_wire_decoder_gives_the_same_graph(name):
    data = _golden_bytes(name)
    j, t = jonnx.decode_wire(data), tonnx.decode_wire(data)
    assert type(t).__name__ == "OnnxGraph"
    assert (t.name, t.inputs, t.outputs) == (j.name, j.inputs, j.outputs)
    assert len(t.nodes) == len(j.nodes)
    for tn, jn in zip(t.nodes, j.nodes):
        assert (tn.op_type, tn.name, tn.inputs, tn.outputs, tn.attrs) == (
            jn.op_type, jn.name, jn.inputs, jn.outputs, jn.attrs)
    assert list(t.initializers) == list(j.initializers)
    for k, v in j.initializers.items():
        assert t.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(t.initializers[k], v)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_import_gives_the_same_graph_and_weights(name):
    j = jfe.import_model(_golden_path(name))
    t = tfe.import_model(_golden_path(name))
    assert (t.name, t.source, t.missing_params()) == (j.name, j.source, [])
    assert tfe.export_card(t.dfg) == jfe.export_card(j.dfg)
    assert sorted(t.params) == sorted(j.params)
    for k, v in j.params.items():
        assert t.params[k].dtype == v.dtype
        np.testing.assert_array_equal(t.params[k], v)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_runs_bit_exact_with_reference_and_oracle(name, target):
    _, oracle, weights, shape, seed = GOLDENS[name]
    j = jfe.import_model(_golden_path(name))
    t = tfe.import_model(_golden_path(name))
    ja = japi.compile_graph(j.dfg, japi.CompileOptions(target=target))
    ta = tapi.compile_graph(t.dfg, tapi.CompileOptions(target=target))
    assert ta.feasible and ja.feasible
    assert [g.name for g in ta.design.groups] == [
        g.name for g in ja.design.groups]
    x = np.random.default_rng(seed).integers(-4, 5, shape).astype(np.int32)
    xin = {t.dfg.graph_inputs[0]: x}
    got = ta.run(xin, params=t.params, device="cpu")
    want = np.asarray(ja.run(xin, params=j.params, interpret=True))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  oracle(x.astype(np.int64), weights(0)))


def test_golden_batch_runs_bit_exact_with_oracle():
    """A batch of three through the imported classifier, batched
    (``vmap``) and per-sample, each sample against the oracle."""
    t = tfe.import_model(_golden_path("lenet5"))
    ta = tapi.compile_graph(t.dfg)
    xs = np.random.default_rng(11).integers(
        -4, 5, (3, 1, 1, 32, 32)).astype(np.int32)
    xin = {t.dfg.graph_inputs[0]: xs}
    vm = ta.run(xin, params=t.params, device="cpu")
    lp = ta.run(xin, params=t.params, device="cpu", batch_mode="loop")
    np.testing.assert_array_equal(vm, lp)
    for i in range(3):
        np.testing.assert_array_equal(
            vm[i].astype(np.int64),
            fx.lenet5_numpy(xs[i].astype(np.int64), fx.lenet5_weights(0)))


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_layout_pass_leaves_single_boundary_transpose(name):
    t = tfe.import_model(_golden_path(name))
    art = tapi.compile_graph(t.dfg)
    specs = [reorder_spec(n) for n in art.design.source.nodes]
    assert [s[0] for s in specs if s] == ["transpose", "flatten"]
    ja = japi.compile_graph(jfe.import_model(_golden_path(name)).dfg)
    from repro.core.analysis import reorder_spec as jreorder

    assert specs == [jreorder(n) for n in ja.design.source.nodes]


def test_emitted_hls_of_an_import_equals_the_reference(tmp_path):
    t = tfe.import_model(_golden_path("resnet_tiny"))
    j = jfe.import_model(_golden_path("resnet_tiny"))
    tpaths = tapi.compile_graph(t.dfg).emit_hls(str(tmp_path / "t"))
    jpaths = japi.compile_graph(j.dfg).emit_hls(str(tmp_path / "j"))
    assert [os.path.basename(p) for p in tpaths] == [
        os.path.basename(p) for p in jpaths]
    for tp, jp in zip(tpaths, jpaths):
        with open(tp) as a, open(jp) as b:
            assert a.read() == b.read(), os.path.basename(tp)


# ---------------------------------------------------------------------------
# every fixture of the reference's ONNX tests: the same error, or the
# same bits
# ---------------------------------------------------------------------------

_UNSUP = ref_onnx_tests.TestUnsupportedFeatures()
_PAD = ref_onnx_tests.TestConvPaddingMatrix()
_GEMM = ref_onnx_tests.TestGemmAttributeMatrix()
_BN = ref_onnx_tests.TestBatchNormFold()


def _w(seed, shape):
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(np.int8)


def _one_node(op, attrs=(), x=(1, 8), y=(1, 8)):
    """A model of one weightless ``op`` from ``x`` to ``y``."""
    return fx.model(fx.graph(
        "g", [fx.node(op, ["x"], ["y"], op.lower(), tuple(attrs))], [],
        [fx.value_info("x", x)], [fx.value_info("y", y)]))


def _bn_graph(name, nodes, inits, extra_out=()):
    return fx.model(fx.graph(
        name, nodes, inits, [fx.value_info("x", (1, 2, 4, 4))],
        [fx.value_info(n, (1, 2, 4, 4)) for n in extra_out]
        + [fx.value_info("y", (1, 2, 4, 4))]))


def _bn_conv(var):
    return _bn_graph(
        "bn_frac" if var != 1.0 else "bn_shared",
        [fx.node("Conv", ["x", "w"], ["h"], "conv",
                 (fx.attr_string("auto_pad", "SAME_UPPER"),)),
         fx.node("BatchNormalization", ["h", "s", "B", "m", "v"], ["y"],
                 "bn", (fx.attr_float("epsilon", 0.0),))],
        [fx.tensor("w", np.ones((2, 2, 3, 3), np.int8))]
        + _BN._bn_stats(2, var=var),
        extra_out=("h",) if var == 1.0 else ())


def _gemm_c_wrong_arity():
    w = np.ascontiguousarray(_GEMM.W.T)
    return fx.model(fx.graph(
        "gm", [fx.node("Gemm", ["x", "w", "c"], ["y"], "gemm", ())],
        [fx.tensor("w", w), fx.tensor("c", np.arange(4, dtype=np.int32))],
        [fx.value_info("x", (1, 4))], [fx.value_info("y", (1, 6))]))


def _non_initializer_weight():
    return fx.model(fx.graph(
        "dyn_w",
        [fx.node("Conv", ["x", "wdyn"], ["y"], "conv",
                 (fx.attr_ints("pads", [1, 1, 1, 1]),))],
        [fx.tensor("unused", np.zeros((4, 2, 3, 3), np.int8))],
        [fx.value_info("x", (1, 2, 8, 8)),
         fx.value_info("wdyn", (4, 2, 3, 3))],
        [fx.value_info("y", (1, 4, 8, 8))]))


#: the error fixtures of TestUnsupportedFeatures, TestConvPaddingMatrix,
#: TestGemmAttributeMatrix, TestBatchNormFold and TestWireDecoder
REJECTED = {
    "softmax": lambda: _one_node("Softmax"),
    "grouped_conv": lambda: _UNSUP._conv_model(
        group=fx.attr_int("group", 2)),
    "dilated_conv": lambda: _UNSUP._conv_model(
        dilations=fx.attr_ints("dilations", [2, 2])),
    "pool_missing_kernel_shape": lambda: fx.model(fx.graph(
        "nop", [fx.node("MaxPool", ["x"], ["y"], "pool_k")], [],
        [fx.value_info("x", (1, 2, 4, 4))],
        [fx.value_info("y", (1, 2, 2, 2))])),
    "flatten_axis_2": lambda: _one_node(
        "Flatten", (fx.attr_int("axis", 2),), x=(1, 2, 4, 4), y=(2, 16)),
    "non_initializer_weight": _non_initializer_weight,
    "even_kernel_same_lower": lambda: _PAD._model(
        np.zeros((4, 2, 4, 4), np.int8), 8,
        [fx.attr_string("auto_pad", "SAME_LOWER")]),
    "arbitrary_pads": lambda: _PAD._model(
        np.zeros((4, 2, 4, 4), np.int8), 8,
        [fx.attr_ints("pads", [1, 1, 1, 1])]),
    "auto_pad_with_pads": lambda: _PAD._model(
        np.zeros((4, 2, 3, 3), np.int8), 8,
        [fx.attr_string("auto_pad", "SAME_UPPER"),
         fx.attr_ints("pads", [1, 1, 1, 1])]),
    "gemm_beta_with_c": lambda: _GEMM._model(
        (fx.attr_int("transB", 1), fx.attr_float("beta", 0.5))),
    "gemm_alpha": lambda: _GEMM._model(
        (fx.attr_int("transB", 1), fx.attr_float("alpha", 2.0))),
    "gemm_trans_a": lambda: _GEMM._model(
        (fx.attr_int("transB", 1), fx.attr_int("transA", 1))),
    "gemm_c_wrong_arity": _gemm_c_wrong_arity,
    "bn_not_after_conv": lambda: _bn_graph(
        "bn_solo",
        [fx.node("Relu", ["x"], ["h"], "r"),
         fx.node("BatchNormalization", ["h", "s", "B", "m", "v"], ["y"],
                 "bn", (fx.attr_float("epsilon", 0.0),))],
        _BN._bn_stats(2)),
    "bn_on_shared_conv_output": lambda: _bn_conv(1.0),
    "bn_fractional_fold": lambda: _bn_conv(16.0),
    "symbolic_input_dims": lambda: fx.model(fx.graph(
        "sym", [fx.node("Relu", ["x"], ["y"], "r")], [],
        [fx.value_info("x", (), symbolic="batch")],
        [fx.value_info("y", (1,))])),
    "garbage_bytes": lambda: b"\xff\xff\xff\xff not a protobuf",
    "truncated_golden": lambda: _golden_bytes("lenet5")[:1000],
}


def _error(load, data):
    try:
        load(data)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_import_raises_the_same_error(case):
    data = REJECTED[case]()
    want = _error(jfe.load_onnx, data)
    assert want is not None and want[0] == "OnnxImportError", want
    assert _error(tfe.load_onnx, data) == want


#: the accepted cells of the same matrices: (bytes, input)
ACCEPTED = {
    "strided_explicit_pads": lambda: (_PAD._model(
        _w(0, (4, 2, 3, 3)), 8, [fx.attr_ints("kernel_shape", [3, 3]),
                                 fx.attr_ints("strides", [2, 2]),
                                 fx.attr_ints("pads", [0, 0, 1, 1])]),
        (1, 2, 8, 8)),
    "valid": lambda: (_PAD._model(
        _w(1, (4, 2, 3, 3)), 8, [fx.attr_ints("pads", [0, 0, 0, 0])]),
        (1, 2, 8, 8)),
    "even_kernel_same_upper": lambda: (_PAD._model(
        _w(2, (4, 2, 4, 4)), 8, [fx.attr_string("auto_pad", "SAME_UPPER")]),
        (1, 2, 8, 8)),
    "odd_kernel_same_lower": lambda: (_PAD._model(
        _w(4, (4, 2, 3, 3)), 8, [fx.attr_string("auto_pad", "SAME_LOWER")]),
        (1, 2, 8, 8)),
    "strided_valid_even_kernel": lambda: (_PAD._model(
        _w(5, (4, 2, 2, 2)), 8, [fx.attr_string("auto_pad", "VALID"),
                                 fx.attr_ints("strides", [2, 2])]),
        (1, 2, 8, 8)),
    "gemm_transb_bias": lambda: (
        _GEMM._model((fx.attr_int("transB", 1),)), (1, 4)),
    "gemm_transb_0": lambda: (_GEMM._model(
        (), with_c=False, w=np.ascontiguousarray(_GEMM.W.T)), (1, 4)),
    "gemm_beta_0": lambda: (_GEMM._model(
        (fx.attr_int("transB", 1), fx.attr_float("beta", 0.0))), (1, 4)),
    "gemm_beta_without_c": lambda: (_GEMM._model(
        (fx.attr_int("transB", 1), fx.attr_float("beta", 2.0)),
        with_c=False), (1, 4)),
    "global_average_pool": lambda: (_one_node(
        "GlobalAveragePool", x=(1, 2, 4, 4), y=(1, 2, 1, 1)), (1, 2, 4, 4)),
    "average_pool": lambda: (_one_node(
        "AveragePool", (fx.attr_ints("kernel_shape", [2, 2]),
                        fx.attr_ints("strides", [2, 2])),
        x=(1, 2, 4, 4), y=(1, 2, 2, 2)), (1, 2, 4, 4)),
    "symbolic_output_dims": lambda: (fx.model(fx.graph(
        "symout", [fx.node("Relu", ["x"], ["y"], "r")], [],
        [fx.value_info("x", (1, 8))],
        [fx.value_info("y", (), symbolic="N")])), (1, 8)),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_accepted_import_runs_bit_exact_with_reference(case):
    data, shape = ACCEPTED[case]()
    j, t = jfe.load_onnx(data), tfe.load_onnx(data)
    assert tfe.export_card(t.dfg) == jfe.export_card(j.dfg)
    x = (np.random.default_rng(3).integers(-9, 10, shape) - 2).astype(
        np.int32)
    want = np.asarray(japi.compile_graph(j.dfg).run(
        x, params=j.params, interpret=True))
    got = tapi.compile_graph(t.dfg).run(x, params=t.params, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_import_model_dispatch_and_unknown_extension():
    assert tfe.import_model(_golden_path("lenet5")).source == "onnx"
    with pytest.raises(ValueError, match="unknown model extension") as t:
        tfe.import_model("model.yaml")
    with pytest.raises(ValueError) as j:
        jfe.import_model("model.yaml")
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------------
# model cards and the zoo
# ---------------------------------------------------------------------------

SUITE = sorted(tapi.suite())


@pytest.mark.parametrize("name", SUITE)
def test_card_equals_reference_and_round_trips(name):
    tdfg = tapi.suite()[name]()
    card = tfe.export_card(tdfg)
    assert card == jfe.export_card(japi.suite()[name]())
    back = tfe.import_card(json.loads(json.dumps(card)))
    assert back.dfg == tdfg
    assert back.missing_params() == sorted(
        n for n, v in tdfg.values.items() if v.is_constant)


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_card_json_equals_reference(name):
    assert tzoo.card_json(name) == jzoo.card_json(name)
    assert tfe.import_card(tzoo.card_json(name)).dfg == tzoo.ZOO[name]()


def test_lenet5_card_is_the_example_file():
    with open(os.path.join(REPO, "examples", "lenet5.json")) as f:
        assert tzoo.card_json("lenet5") == f.read()
    m = tfe.import_model(os.path.join(REPO, "examples", "lenet5.json"))
    assert m.dfg == tzoo.lenet5()


def test_card_with_weights_runs_bit_exact_with_reference():
    """Weights embedded in a card reach the run in both packages."""
    jdfg, tdfg = jzoo.lenet5(), tzoo.lenet5()
    rng = np.random.default_rng(0)
    params = {n: rng.integers(-4, 5, v.shape).astype(np.int8)
              for n, v in tdfg.values.items() if v.is_constant}
    card = tfe.export_card(tdfg, params=params)
    assert card == jfe.export_card(jdfg, params=params)
    t, j = tfe.import_card(card), jfe.import_card(card)
    assert t.missing_params() == []
    x = rng.integers(-4, 5, (1, 32, 32, 1)).astype(np.int32)
    got = tapi.compile_graph(t.dfg).run(x, params=t.params, device="cpu")
    want = np.asarray(japi.compile_graph(j.dfg).run(
        x, params=j.params, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_zoo_card_of_an_unknown_model_raises_the_same():
    with pytest.raises(KeyError) as t:
        tzoo.card("lenet6")
    with pytest.raises(KeyError) as j:
        jzoo.card("lenet6")
    assert str(t.value) == str(j.value)


def _conv_card():
    from repro.core import cnn_graphs

    return jfe.export_card(cnn_graphs.conv_relu(8, c_out=4))


def _drop(key):
    card = _conv_card()
    del card[key]
    return card


def _dangling():
    card = json.loads(json.dumps(_conv_card()))
    card["layers"][0]["input"] = "ghost"
    return card


#: the malformed cards of tests/test_modelcard.py::TestValidation
BAD_CARDS = {
    "format": lambda: dict(_conv_card(), format="something-else"),
    "version": lambda: dict(_conv_card(), version=99),
    "unknown_op": lambda: dict(_conv_card(), layers=_conv_card()["layers"]
                               + [{"op": "softmax"}]),
    "dangling_reference": _dangling,
    "no_inputs": lambda: _drop("inputs"),
    "no_layers": lambda: _drop("layers"),
    "no_outputs": lambda: _drop("outputs"),
    "no_name": lambda: _drop("name"),
    "invalid_json_text": lambda: "{not json",
    "missing_file": lambda: "examples/lent5.json",
    "not_a_mapping": lambda: json.dumps([1, 2]),
}


@pytest.mark.parametrize("case", sorted(BAD_CARDS))
def test_malformed_card_raises_the_same_error(case, monkeypatch):
    monkeypatch.chdir(REPO)
    card = BAD_CARDS[case]()
    want = _error(jfe.import_card, card)
    assert want is not None, case
    assert _error(tfe.import_card, card) == want


#: the weights each refused export of TestWeights offers
BAD_PARAMS = {"shape": {"w0": np.zeros((2, 2), np.int8)},
              "unknown_name": {"nope": np.zeros((1,), np.int8)}}


@pytest.mark.parametrize("case", ["fused"] + sorted(BAD_PARAMS))
def test_refused_export_raises_the_same_error(case):
    from repro import passes as jpasses
    from repro.core import cnn_graphs as jgraphs
    from repro_torch import passes as tpasses
    from repro_torch.core import cnn_graphs as tgraphs

    def attempt(fe, graphs, passes):
        dfg = graphs.conv_relu(8, c_out=4)
        if case == "fused":
            return _error(fe.export_card,
                          passes.run_default_pipeline(dfg).dfg)
        return _error(lambda d: fe.export_card(d, params=BAD_PARAMS[case]),
                      dfg)

    want = attempt(jfe, jgraphs, jpasses)
    assert want is not None and want[0] == "ModelCardError", want
    assert attempt(tfe, tgraphs, tpasses) == want


#: a conv whose NCHW output (N²×64 8-bit elements) outgrows the KV260's
#: 288 RAM18K blocks, and the pooling head that brings it back in
WIDE_N, WIDE_POOL = 128, 8


def _wide_conv(pool):
    """One Conv 3×3 2→64 at ``WIDE_N``² with an NCHW output, with or
    without a MaxPool ``pool``×``pool`` head."""
    w = _w(9, (64, 2, 3, 3))
    nodes = [fx.node("Conv", ["x", "w"], ["c"], "conv",
                     (fx.attr_ints("pads", [1, 1, 1, 1]),))]
    out, n = "c", WIDE_N
    if pool:
        nodes.append(fx.node("MaxPool", ["c"], ["p"], "pool", (
            fx.attr_ints("kernel_shape", [pool, pool]),
            fx.attr_ints("strides", [pool, pool]))))
        out, n = "p", WIDE_N // pool
    return w, fx.model(fx.graph(
        "wide_out", nodes, [fx.tensor("w", w)],
        [fx.value_info("x", (1, 2, WIDE_N, WIDE_N))],
        [fx.value_info(out, (1, 64, n, n), fx.INT32)]))


def test_a_large_nchw_output_is_infeasible_in_both_packages():
    """An imported model's rank-4 NCHW output keeps the NHWC→NCHW bridge,
    and that transpose holds the whole tensor: at 128²×64 it alone
    exceeds the KV260's BRAM in both packages (``chip_smoke.py``'s
    full-width ONNX model ends in a pool for this reason).  A pooling
    head brings the output within the budget."""
    from repro.passes import PartitionError as JPartitionError
    from repro_torch.passes import PartitionError as TPartitionError

    _, data = _wide_conv(0)
    with pytest.raises(JPartitionError) as j:
        japi.compile_graph(jfe.load_onnx(data).dfg)
    with pytest.raises(TPartitionError) as t:
        tapi.compile_graph(tfe.load_onnx(data).dfg)
    assert str(t.value) == str(j.value) and "transpose" in str(t.value)
    w, data = _wide_conv(WIDE_POOL)
    m = tfe.load_onnx(data)
    art = tapi.compile_graph(m.dfg)
    assert art.feasible
    x = np.random.default_rng(1).integers(
        -4, 5, (1, 2, WIDE_N, WIDE_N)).astype(np.int32)
    got = art.run(x, params=m.params, device="cpu")
    n, k = WIDE_N // WIDE_POOL, WIDE_POOL
    want = ref_onnx_tests._conv_nchw(x, w, pads=((1, 1), (1, 1))).reshape(
        1, 64, n, k, n, k).max(axis=(3, 5))
    np.testing.assert_array_equal(got.astype(np.int64), want)
