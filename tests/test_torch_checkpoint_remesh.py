"""The elastic re-mesh of a checkpoint (``CheckpointManager.restore(...,
shardings=...)``): the reference's
``test_checkpoint.py::TestElasticRemesh`` on the port, with gloo ranks
(``_torch_ranks.run_ranks``) in place of forced host devices.

A checkpoint holds full logical arrays, so where it was written does not
matter: saved from DTensors on a (4, 2) mesh of eight ranks (gathered on
every rank, written by rank 0), it restores bit for bit onto a (2, 2, 2)
``pod`` × ``data`` × ``model`` mesh of the same ranks and onto one
device; a checkpoint the reference wrote restores onto a port mesh, and
one written on a port mesh restores in the reference, bit for bit."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.launch import steps as JS

from repro_torch.tree import tree_flatten_with_path

from _torch_port import ref_and_port
from _torch_ranks import load_rank, run_ranks

#: the reference's case, a bf16 leaf and llama3.2-1b's smoke params placed
#: by the rules, saved on (4, 2); restored onto (2, 2, 2) by the rules
#: there and onto one device
REMESH_RANK = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import tree_flatten_with_path

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = get_config("llama3.2-1b", smoke=True)
mgr = CheckpointManager(os.path.join(OUT, "ckpt"))
mesh1 = make_host_mesh((4, 2), ("data", "model"))
w_sh = shd.NamedSharding(mesh1, ("data", "model"))
tree = {"w": shd.distribute(inp["w"], w_sh),
        "h": shd.distribute(inp["h"], w_sh),
        "params": shd.distribute_tree(
            inp["params"],
            shd.make_param_shardings(mesh1, inp["params"], cfg))}
mgr.save(1, tree, extra={"mesh": "4x2"})
snapshot = [(p, type(a).__name__) for p, a, _ in mgr._snapshot(tree)]

mesh2 = make_host_mesh((2, 2, 2), ("pod", "data", "model"))
tmpl = {"w": inp["w"], "h": inp["h"], "params": specs.params_specs(cfg)}
tgt = shd.NamedSharding(mesh2, (("pod", "data"), "model"))
shardings = {"w": tgt, "h": tgt, "params": shd.make_param_shardings(
    mesh2, tmpl["params"], cfg)}
restored, extra = mgr.restore(1, tmpl, device="cpu", shardings=shardings)
single, _ = mgr.restore(1, tmpl, device="cpu")
out = {"extra": extra, "coord": mesh2.coordinate(), "snapshot": snapshot,
       "w_local": restored["w"].to_local().clone(),
       "w_placements": [str(p) for p in restored["w"].placements],
       "mesh_axes": restored["w"].device_mesh.mesh_dim_names,
       "remeshed": {p: t.full_tensor()
                    for p, t in tree_flatten_with_path(restored)},
       "single": {p: (type(t).__name__, t)
                  for p, t in tree_flatten_with_path(single)}}
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def remesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("remesh")
    _, tcfg, _, _, tp = ref_and_port("llama3.2-1b", "bfloat16")
    w = torch.arange(64.0).reshape(8, 8)
    h = torch.randn(8, 8, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    torch.save({"w": w, "h": h, "params": tp}, os.path.join(tmp, "inputs.pt"))
    run_ranks(REMESH_RANK, 8, tmp)
    want = dict(tree_flatten_with_path({"w": w, "h": h, "params": tp}))
    return tmp, [load_rank(tmp, r) for r in range(8)], want


def test_saved_on_4x2_restores_onto_2x2x2_bit_for_bit(remesh):
    """Every leaf comes back whole on every rank of the (2, 2, 2) mesh,
    each rank holding the (pod · data, model) block its coordinates
    name."""
    _, ranks, want = remesh
    for got in ranks:
        assert got["extra"] == {"mesh": "4x2"}
        assert set(got["remeshed"]) == set(want)
        for path, t in got["remeshed"].items():
            assert t.dtype == want[path].dtype, path
            assert torch.equal(t, want[path]), path
        assert got["mesh_axes"] == ("pod", "data", "model")
        assert got["w_placements"] == ["S(0)", "S(0)", "S(1)"]
        c = got["coord"]
        row = c["pod"] * 2 + c["data"]
        assert torch.equal(got["w_local"],
                           want["['w']"][2 * row:2 * row + 2,
                                         4 * c["model"]:4 * c["model"] + 4])


def test_saved_on_4x2_restores_onto_one_device_bit_for_bit(remesh):
    _, ranks, want = remesh
    for got in ranks:
        for path, (kind, t) in got["single"].items():
            assert kind == "Tensor"
            assert torch.equal(t, want[path]), path


def test_only_rank_0_wrote_one_committed_directory(remesh):
    tmp, _, _ = remesh
    assert sorted(os.listdir(tmp / "ckpt")) == ["step_000000001"]


def test_only_the_writing_rank_copies_the_snapshot_to_host(remesh):
    """Every rank takes part in the gathers of a save, but only rank 0,
    the writer, copies the leaves to host memory: the snapshots of ranks
    1-7 hold no array."""
    _, ranks, want = remesh
    assert ranks[0]["snapshot"] == [(p, "ndarray") for p in want]
    for got in ranks[1:]:
        assert got["snapshot"] == []


def test_a_mesh_checkpoint_restores_in_the_reference(remesh):
    """The port's (4, 2) checkpoint read by the reference's manager:
    the same values, bf16 included."""
    tmp, _, want = remesh
    tmpl = {"w": jax.ShapeDtypeStruct((8, 8), jnp.float32),
            "h": jax.ShapeDtypeStruct((8, 8), jnp.bfloat16),
            "params": jax.tree.map(
                lambda t: jax.ShapeDtypeStruct(
                    tuple(t.shape),
                    jnp.bfloat16 if t.dtype == torch.bfloat16
                    else jnp.float32), _nested(want, "['params']"))}
    tree, extra = JManager(str(tmp / "ckpt")).restore(1, tmpl)
    assert extra == {"mesh": "4x2"}
    got = {jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(got) == set(want)
    for path, t in want.items():
        np.testing.assert_array_equal(got[path], t.float().numpy(),
                                      err_msg=path)


def _nested(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of ``{keystr path: leaf}``."""
    out: dict = {}
    for path, leaf in flat.items():
        if not path.startswith(prefix):
            continue
        keys = path[len(prefix) + 2:-2].split("']['")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


REF_ONTO_MESH_RANK = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import build_run
from repro_torch.tree import tree_flatten_with_path

mesh = make_host_mesh((2, 2), ("data", "model"))
run = build_run(cfg=get_config("qwen2-0.5b", smoke=True), steps=10, batch=2,
                seq=32, ckpt_dir=None, device="cpu", mesh=mesh)
tree, extra = CheckpointManager(os.path.join(OUT, "ref")).restore(
    0, run.state_template(), device="cpu",
    shardings={"params": run.p_shard, "opt": run.o_shard})
torch.save({"extra": extra,
            "kinds": sorted({type(t).__name__
                             for _, t in tree_flatten_with_path(tree)}),
            "full": {p: t.full_tensor()
                     for p, t in tree_flatten_with_path(tree)}},
           f"{OUT}/rank{RANK}.pt")
"""


def test_a_reference_checkpoint_restores_onto_a_port_mesh(tmp_path):
    """qwen2-0.5b's smoke state as the reference draws it (bf16 params,
    f32 moments, a 0-d int32 step), written by the reference's manager,
    restored by the port's ``TrainRun`` shardings onto a 2 × 2 gloo
    mesh: every leaf a DTensor whose full value is the reference's."""
    from repro.configs import registry as jreg
    from repro.optim import adamw as JA

    jcfg = jreg.get_config("qwen2-0.5b", smoke=True)
    jp = JS.model_init(jax.random.key(4), jcfg)
    state = {"params": jp, "opt": JA.init(jp, JA.AdamWConfig())}
    JManager(str(tmp_path / "ref")).save(0, state, extra={"step": 0})
    run_ranks(REF_ONTO_MESH_RANK, 4, tmp_path)
    want = {jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}
    for r in range(4):
        got = load_rank(tmp_path, r)
        assert got["extra"] == {"step": 0}
        assert got["kinds"] == ["DTensor"]
        assert set(got["full"]) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got["full"][path].float().numpy(),
                                          w, err_msg=path)
