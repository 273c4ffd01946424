"""The port's device meshes and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.distributed.sharding``, ``quant.ptq.quantized_param_shardings``)
held against the reference's.

The rules need only the mesh's axis sizes.  So each comparison runs in
this process, without ranks: the reference's rules on a
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees, the port's on
a :class:`Mesh` of the same shape over ``meta`` tensors
(``launch.specs``), for all ten configs at full width.  Every leaf's spec
must equal the reference's ``PartitionSpec`` as a tuple.  The reference's
own rule tests (``tests/test_sharding.py``) run here as cases on the
port.  One test starts four gloo ranks to take a spec through DTensor
placements and back."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.optim import adamw as JA
from repro.quant import ptq as jptq

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.optim import adamw as TA
from repro_torch.quant import ptq as tptq
from repro_torch.tree import tree_flatten_with_path

from _torch_ranks import load_rank, run_ranks

ARCHS = jreg.all_archs()

#: (name, shape, axes) of every mesh the rules are held on; the last two
#: are the production meshes with the per-arch ``tp`` reshape
MESHES = (
    ("1x1", (1, 1), ("data", "model")),
    ("2x4", (2, 4), ("data", "model")),
    ("2x2x2", (2, 2, 2), ("pod", "data", "model")),
    ("16x16", (16, 16), ("data", "model")),
    ("2x16x16", (2, 16, 16), ("pod", "data", "model")),
    ("prod.tp2", (128, 2), ("data", "model")),
    ("prod.multi.tp4", (2, 64, 4), ("pod", "data", "model")),
)


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), tmesh.Mesh(shape, axes)


def _ref_specs(tree) -> dict:
    """{path: spec}; the reference registers ``QTensor`` without keys, so
    its two leaves are named as the port's tree names them."""
    def name(k):
        return jax.tree_util.keystr(k).replace(
            "[<flat index 0>]", ".q").replace("[<flat index 1>]", ".scale")

    return {name(k): tuple(v.spec)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree) -> dict:
    return {path: sh.spec for path, sh in tree_flatten_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """(reference, port) abstract trees of one config at full width:
    params, AdamW state (plain and with int8 moments), train batch,
    batch of one, decode cache."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jp = jspecs.params_specs(jcfg)
    tp = tspecs.params_specs(tcfg)
    out = {"params": (jp, tp)}
    for q in (False, True):
        jo = jax.eval_shape(
            lambda p: JA.init(p, JA.AdamWConfig(quantize_moments=q)), jp)
        out[f"opt.q{int(q)}"] = (jo, TA.init(tp, TA.AdamWConfig(
            quantize_moments=q)))
    for name in ("train_4k", "long_500k"):
        js, ts = JSHAPES[name], TSHAPES[name]
        out[f"batch.{name}"] = (jspecs.train_input_specs(jcfg, js),
                                tspecs.train_input_specs(tcfg, ts))
    out["cache"] = (jspecs.decode_input_specs(jcfg, JSHAPES["decode_32k"])
                    ["cache"],
                    tspecs.decode_input_specs(tcfg, TSHAPES["decode_32k"])
                    ["cache"])
    return jcfg, tcfg, out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_are_the_references_shapes_and_dtypes(arch):
    """``launch.specs`` gives meta tensors of the reference's
    ``ShapeDtypeStruct`` shapes and dtypes, leaf for leaf."""
    _, _, trees = _trees(arch)
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    trees = dict(trees, prefill=(
        jspecs.prefill_input_specs(jcfg, JSHAPES["prefill_32k"]),
        tspecs.prefill_input_specs(tcfg, TSHAPES["prefill_32k"])))
    for kind, (jt, tt) in trees.items():
        ref = {jax.tree_util.keystr(k): (tuple(v.shape), np.dtype(v.dtype).name)
               for k, v in jax.tree_util.tree_flatten_with_path(jt)[0]}
        got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in tree_flatten_with_path(tt)}
        assert got == ref, kind
        assert all(t.device.type == "meta"
                   for _, t in tree_flatten_with_path(tt)), kind


@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_takes_the_references_spec(arch, mesh):
    """Params (head-aware, divisibility fallbacks), both AdamW states,
    the train batch and a batch of one, the decode cache and the int8
    tree: every leaf's spec equals the reference's."""
    _, shape, axes = mesh
    jm, tm = _meshes(shape, axes)
    jcfg, tcfg, trees = _trees(arch)
    jp, tp = trees["params"]
    j_ps = jshd.make_param_shardings(jm, jp, jcfg)
    t_ps = tshd.make_param_shardings(tm, tp, tcfg)
    checked = {"params": (j_ps, t_ps)}
    for q in (0, 1):
        jo, to = trees[f"opt.q{q}"]
        checked[f"opt.q{q}"] = (jshd.make_opt_shardings(jm, jo, j_ps),
                                tshd.make_opt_shardings(tm, to, t_ps))
    for name in ("train_4k", "long_500k"):
        jb, tb = trees[f"batch.{name}"]
        checked[name] = (jshd.make_batch_shardings(jm, jb),
                         tshd.make_batch_shardings(tm, tb))
    jc, tc = trees["cache"]
    checked["cache"] = (jshd.make_cache_shardings(jm, jc),
                        tshd.make_cache_shardings(tm, tc))
    checked["int8"] = (jptq.quantized_param_shardings(j_ps, jp),
                       tptq.quantized_param_shardings(t_ps, tp))
    for kind, (jt, tt) in checked.items():
        ref, got = _ref_specs(jt), _port_specs(tt)
        assert ref, kind
        assert got == ref, (kind, {k: (got.get(k), v) for k, v in ref.items()
                                   if got.get(k) != v})
    # every placement is well-formed on a mesh of this shape
    for _, sh in tree_flatten_with_path(t_ps):
        assert len(sh.placements()) == len(axes)


# ---------------------------------------------------------------------------
# the reference's own rule cases (tests/test_sharding.py), on the port
# ---------------------------------------------------------------------------


def test_llama_specs():
    """Stacked block leaves never shard the layer axis and take TP;
    the embedding is vocab-parallel."""
    tm = tmesh.Mesh((1, 1), ("data", "model"))
    cfg = treg.get_config("llama3.2-1b", smoke=True)
    flat = _port_specs(tshd.make_param_shardings(
        tm, tspecs.params_specs(cfg)))
    wq = [v for k, v in flat.items() if "wq" in k][0]
    assert wq[0] is None and "model" in wq
    embed = [v for k, v in flat.items() if "embed" in k][0]
    assert "model" in embed


def test_divisibility_fallback():
    """A vocabulary that does not divide model = 16 replicates that
    dimension: seamless-m4t's 256206 (mamba2's 50280, the reference's
    case, is padded to 50432 by the vocab-padding rule, which divides)."""
    cfg = treg.get_config("seamless-m4t-medium")
    assert cfg.padded_vocab % 16 != 0
    assert treg.get_config("mamba2-1.3b").vocab_size % 16 != 0
    jm, tm = _meshes((16, 16), ("data", "model"))
    got = _port_specs(tshd.make_param_shardings(
        tm, tspecs.params_specs(cfg), cfg))
    assert got["['embed']"] == (None, "data")
    assert got["['lm_head']"] == ("data", None)
    jcfg = jreg.get_config("seamless-m4t-medium")
    assert got == _ref_specs(jshd.make_param_shardings(
        jm, jspecs.params_specs(jcfg), jcfg))


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (2, 2, 2)])
def test_batch_of_one_replicates(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    jm, tm = _meshes(shape, axes)
    b = {"tokens": torch.empty((1, 64), dtype=torch.int32, device="meta")}
    jb = {"tokens": jax.ShapeDtypeStruct((1, 64), jnp.int32)}
    got = tshd.make_batch_shardings(tm, b)["tokens"].spec
    assert got == (None, None) or got == ("data", None)
    assert got == tuple(jshd.make_batch_shardings(jm, jb)["tokens"].spec)


@pytest.mark.parametrize("hkv, want", [
    (2, (None, "data", None, "model", None)),
    (8, (None, "data", "model", None, None))])
def test_cache_sharding_adapts(hkv, want):
    """Hkv 2 cannot shard over model 4, so the sequence takes it; Hkv 8
    can."""
    jm, tm = _meshes((2, 4), ("data", "model"))
    shape = (2, 4, hkv, 64, 16)
    tc = {"b0": {"k": torch.empty(shape, dtype=torch.bfloat16,
                                  device="meta")}}
    jc = {"b0": {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)}}
    got = tshd.make_cache_shardings(tm, tc)["b0"]["k"].spec
    assert got == want
    assert got == tuple(jshd.make_cache_shardings(jm, jc)["b0"]["k"].spec)


def test_indivisible_heads_replicate_their_axis():
    """qwen2-0.5b's 14 query and 2 KV heads on model 4: the head-aware
    rule keeps each head whole (its head axis replicates); without the
    config the heads are sliced, as in the reference."""
    jm, tm = _meshes((2, 4), ("data", "model"))
    tcfg, jcfg = treg.get_config("qwen2-0.5b"), jreg.get_config("qwen2-0.5b")
    tp, jp = tspecs.params_specs(tcfg), jspecs.params_specs(jcfg)
    aware = _port_specs(tshd.make_param_shardings(tm, tp, tcfg))
    blind = _port_specs(tshd.make_param_shardings(tm, tp))
    wq = "['blocks']['b0']['attn']['wq']"
    wo = "['blocks']['b0']['attn']['wo']"
    assert aware[wq] == (None, "data", None)
    assert aware[wo] == (None, None, "data")
    assert blind[wq] == (None, "data", "model")
    assert aware == _ref_specs(jshd.make_param_shardings(jm, jp, jcfg))
    assert blind == _ref_specs(jshd.make_param_shardings(jm, jp))


@pytest.mark.parametrize("multi, tp, env, want", [
    (False, 0, None, (16, 16)),
    (True, 0, None, (2, 16, 16)),
    (False, 2, None, (128, 2)),
    (True, 4, None, (2, 64, 4)),
    (False, 0, "2,4", (2, 4)),
    (True, 2, "2,2,2", (2, 2, 2)),
    (False, 8, "2,4", (1, 8))])
def test_production_mesh_shapes_keep_the_device_count(monkeypatch, multi, tp,
                                                      env, want):
    """The reference's shapes, its ``tp`` reshape (the same device
    count) and its environment overrides — its own function run with
    ``jax.make_mesh`` caught, since this host has one device; with no
    process group the port's mesh is its shape alone."""
    var = "REPRO_MESH_SHAPE_MULTI" if multi else "REPRO_MESH_SHAPE"
    for v in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI"):
        monkeypatch.delenv(v, raising=False)
    if env:
        monkeypatch.setenv(var, env)
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (shape, axes))
    ref_shape, ref_axes = jmesh.make_production_mesh(multi_pod=multi, tp=tp)
    m = tmesh.make_production_mesh(multi_pod=multi, tp=tp)
    assert tuple(m.shape.values()) == tuple(ref_shape) == want
    assert m.axis_names == tuple(ref_axes)
    assert m.device_mesh is None
    chips = np.prod([int(x) for x in env.split(",")]) if env else \
        (512 if multi else 256)
    assert np.prod(list(m.shape.values())) == chips


def test_tp_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_production_mesh(tp=3)


def test_single_device_mesh_needs_the_card():
    """``device=None`` is the card: without one it raises before any
    process group starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.single_device_mesh()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec, want", [
    ((), "RRR"),
    ((None, "model"), "RR1"),
    (("model", ("pod", "data")), "110"),
    ((("pod", "data"), None), "00R"),
    ((None, None, "data"), "R2R")])
def test_spec_becomes_one_placement_per_mesh_axis(spec, want):
    """``Shard(d)`` where the spec names the mesh axis (``pod`` and
    ``data`` together: both, pod the outer), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.Mesh((2, 2, 2), ("pod", "data", "model"))
    got = tshd.placements(tm, spec)
    assert got == [Replicate() if c == "R" else Shard(int(c)) for c in want]


@pytest.mark.parametrize("spec", [(("data", "pod"),), ("data", "data")])
def test_a_spec_out_of_mesh_order_or_repeating_an_axis_raises(spec):
    tm = tmesh.Mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        tshd.placements(tm, spec)


def test_specs_round_trip_through_dtensor_on_a_gloo_mesh(tmp_path):
    """On a 2 × 2 gloo mesh of four ranks, llama3.2-1b's smoke params
    placed by their rules hold the shard each spec names, and
    ``full_tensor()`` gives every value back bit for bit; a mesh whose
    size is not the world's raises."""
    run_ranks("""
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import tree_flatten_with_path

mesh = make_host_mesh((2, 2), ("data", "model"))
cfg = get_config("llama3.2-1b", smoke=True)
params = ST.model_init(torch.Generator().manual_seed(0), cfg)
p_shard = shd.make_param_shardings(mesh, params, cfg)
placed = shd.distribute_tree(params, p_shard)
coord = mesh.coordinate()
out = {"coord": coord, "leaves": {}}
for (path, full), (_, d), (_, sh) in zip(
        tree_flatten_with_path(params), tree_flatten_with_path(placed),
        tree_flatten_with_path(p_shard)):
    out["leaves"][path] = (sh.spec, d.to_local().clone(),
                           torch.equal(d.full_tensor(), full))
try:
    make_host_mesh((2, 4), ("data", "model"))
    out["mismatch"] = None
except ValueError as e:
    out["mismatch"] = str(e)
torch.save(out, f"{OUT}/rank{RANK}.pt")
""", 4, tmp_path)
    cfg = treg.get_config("llama3.2-1b", smoke=True)
    from repro_torch.launch import steps as TS

    params = dict(tree_flatten_with_path(
        TS.model_init(torch.Generator().manual_seed(0), cfg)))
    sharded = 0
    for r in range(4):
        got = load_rank(tmp_path, r)
        assert "(2, 4) mesh has 8 devices" in got["mismatch"]
        coord = got["coord"]
        for path, (spec, local, whole) in got["leaves"].items():
            assert whole, path
            want = params[path]
            for dim, axes in enumerate(spec):
                if axes is None:
                    continue
                n = {"data": 2, "model": 2}[axes]
                step = want.shape[dim] // n
                want = want.narrow(dim, coord[axes] * step, step)
                sharded += 1
            assert torch.equal(local, want), (r, path, spec)
    assert sharded > 0


def test_the_activation_hook_holds_the_ranks_rows():
    """The sharded step's hook (``activation_hook``) passes ``hidden`` and
    ``logits`` activations of this rank's microbatch rows through as
    they are and raises on any other row count — through the model's own
    ``shard_activation`` sites too; other kinds pass unchecked."""
    from repro_torch.distributed import ctx
    from repro_torch.launch import steps as TS
    from repro_torch.models import lm as tlm

    hook = tshd.activation_hook(tmesh.Mesh((2, 1), ("data", "model")))
    x = torch.zeros(3, 4, 5)
    with ctx.data_rows(ctx.RowSplit(None, 1, 2, 3)):
        assert hook(x, "hidden") is x and hook(x, "logits") is x
        assert hook(torch.zeros(2, 4, 5), "kv_cache").shape[0] == 2
        with pytest.raises(ValueError, match="2 rows"):
            hook(torch.zeros(2, 4, 5), "hidden")
    cfg = treg.get_config("qwen2-0.5b", smoke=True)
    params = TS.model_init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    with ctx.activation_sharding(hook):
        with ctx.data_rows(ctx.RowSplit(None, 0, 1, 2)):
            loss = tlm.lm_loss(params, cfg, batch)
        with ctx.data_rows(ctx.RowSplit(None, 0, 2, 1)), \
                pytest.raises(ValueError, match="this rank"):
            tlm.lm_loss(params, cfg, batch)
    assert torch.equal(loss, tlm.lm_loss(params, cfg, batch))
