"""Training on a device mesh (``launch.steps.make_sharded_train_step``,
``launch.train.train(mesh=...)``, the MoE layer's global routing) on
CPU gloo meshes of spawned ranks (``_torch_ranks.run_ranks``).

The reference's own mesh train step fails on this jax
(``test_sharding.py::TestMultiDeviceParity``, ROADMAP §C), so the port's
sharded step is held against the reference's **unsharded** jitted
``make_train_step`` on the same parameters and the same global batch, in
f32, at the tolerances of the reference's parity test: loss rtol 1e-5,
every leaf of the parameters and moments atol 3e-4, rtol 1e-3 (gradients
are all-reduced in another order).  ``grad_accum`` 2 against 1 on a mesh
takes the reference's grad-accum tolerances (loss rtol 1e-5, parameters
atol = rtol = 2e-5).  On a 1 × 1 mesh every collective is the identity:
it must give ``mesh=None``'s bits."""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.models import moe as JMOE
from repro.optim import adamw as JA

from repro_torch.launch import steps as TS
from repro_torch.tree import tree_flatten_with_path

import chip_smoke
from _torch_port import REPO, ref_and_port, to_np
from _torch_ranks import load_rank, run_ranks

#: (mesh name, shape) of the dense step's meshes: rows and the model
#: split (heads, ``d_ff``, vocabulary), rows split only, the model split
#: only
MESHES = {"2x2": (2, 2), "2x1": (2, 1), "1x2": (1, 2)}
ROWS, SEQ = 4, 32
PARAM_TOL = dict(atol=3e-4, rtol=1e-3)
ACCUM_TOL = dict(atol=2e-5, rtol=2e-5)

#: one sharded step on a rank: the inputs from ``inputs.pt``, the params
#: and AdamW state placed by the rules, the rank's rows of the global
#: batch; saved: loss, grad norm, and the full and local values of every
#: leaf after the step
STEP_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = get_config(inp["arch"], smoke=True).with_(dtype="float32")
mesh = make_host_mesh(inp["shape"], ("data", "model"))
opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
p_shard = shd.make_param_shardings(mesh, inp["params"], cfg)
opt = adamw.init(inp["params"], opt_cfg)
params = shd.distribute_tree(inp["params"], p_shard)
opt = shd.distribute_tree(opt, shd.make_opt_shardings(mesh, opt, p_shard))
out = {"coord": mesh.coordinate()}
for accum in inp["accums"]:
    step = ST.make_sharded_train_step(cfg, opt_cfg, mesh,
                                      global_batch=inp["rows"],
                                      grad_accum=accum)
    local = ST.local_batch(mesh, inp["batch"], accum)
    p2, o2, m = step(params, opt, local)
    state = {"params": p2, "opt": o2}
    out[accum] = {
        "rows": {k: v.shape for k, v in local.items()},
        "loss": m["loss"], "grad_norm": m["grad_norm"],
        "full": {p: t.full_tensor() for p, t in tree_flatten_with_path(state)},
        "local": {p: t.to_local().clone()
                  for p, t in tree_flatten_with_path(state)},
    }
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _opt(mod):
    return mod.AdamWConfig(warmup_steps=1, total_steps=10)


def _global_batch(vocab: int) -> dict:
    return JP.lm_batch(JP.DataConfig(seed=3, vocab_size=vocab, seq_len=SEQ,
                                     global_batch=ROWS), 0)


def _ref_state_paths(jp, js) -> dict:
    """{port path: f32 NumPy} of the reference's params and AdamW state."""
    tree = {"params": jp, "opt": js}
    out = {}
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(k)] = to_np(v)
    return out


def _run_step_ranks(tmp, arch, shape, params, batch, accums):
    torch.save({"arch": arch, "shape": shape, "params": params,
                "batch": batch, "rows": ROWS, "accums": accums},
               os.path.join(tmp, "inputs.pt"))
    world = shape[0] * shape[1]
    run_ranks(STEP_RANK, world, tmp)
    return [load_rank(tmp, r) for r in range(world)]


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """llama3.2-1b smoke in f32: the reference's unsharded steps
    (``grad_accum`` 1 and 2) and one sharded step on each mesh."""
    jcfg, tcfg, jp, _, tp = ref_and_port("llama3.2-1b", "float32")
    jcfg = jcfg.with_(attn_impl="blockwise")
    b = _global_batch(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    ref = {}
    for accum in (1, 2):
        step = jax.jit(JS.make_train_step(jcfg, _opt(JA), grad_accum=accum))
        p, s, m = step(jp, JA.init(jp, _opt(JA)), jb)
        ref[accum] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "state": _ref_state_paths(p, s)}
    with ThreadPoolExecutor(len(MESHES)) as pool:      # the meshes at once
        futures = {name: pool.submit(
            _run_step_ranks, str(tmp_path_factory.mktemp(name)),
            "llama3.2-1b", shape, tp, tb, (1, 2) if name == "2x2" else (1,))
            for name, shape in MESHES.items()}
        runs = {name: f.result() for name, f in futures.items()}
    return ref, runs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_one_step_matches_the_reference_unsharded_step(dense, mesh):
    """Loss, grad norm and every leaf of params, ``mu`` and ``nu`` after
    one step, on every rank."""
    ref, runs = dense
    want = ref[1]
    for rank in runs[mesh]:
        got = rank[1]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   want["grad_norm"], rtol=1e-5)
        assert set(got["full"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(to_np(got["full"][path]), w,
                                       err_msg=path, **PARAM_TOL)


def _shard_of(full, spec, coord, sizes):
    """The block of ``full`` that the rank at ``coord`` holds under
    ``spec`` (an axis group's block index is row-major over it)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else axes
        index, count = 0, 1
        for a in names:
            index, count = index * sizes[a] + coord[a], count * sizes[a]
        size = full.shape[dim] // count
        full = full.narrow(dim, index * size, size)
    return full


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_shard_of_one_state(dense, mesh):
    """Every rank gathers the same state, bit for bit, and holds the
    shard of it that the rules' spec and its coordinates name; the rows
    it computed are its block of the batch (all of it on a data axis of
    1)."""
    from repro_torch.configs import registry as treg
    from repro_torch.distributed import sharding as tshd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs as tspecs
    from repro_torch.optim import adamw as TA

    _, runs = dense
    shape = MESHES[mesh]
    tm = tmesh.Mesh(shape, ("data", "model"))
    cfg = treg.get_config("llama3.2-1b", smoke=True).with_(dtype="float32")
    params = tspecs.params_specs(cfg)
    p_shard = tshd.make_param_shardings(tm, params, cfg)
    specs = {path: sh.spec for path, sh in tree_flatten_with_path(
        {"params": p_shard, "opt": tshd.make_opt_shardings(
            tm, TA.init(params, _opt(TA)), p_shard)})}
    first = runs[mesh][0][1]["full"]
    sharded = 0
    for rank in runs[mesh]:
        got = rank[1]
        assert got["rows"]["tokens"] == (ROWS // shape[0], SEQ)
        assert set(got["full"]) == set(specs)
        for path, full in got["full"].items():
            assert torch.equal(full, first[path]), path
            want = _shard_of(full, specs[path], rank["coord"], tm.shape)
            assert torch.equal(got["local"][path], want), path
            sharded += want.shape != full.shape
    assert sharded > 0


def test_grad_accum_on_a_mesh_equals_grad_accum_1(dense):
    """On the 2 × 2 mesh ``grad_accum`` 2 (each rank a row of each
    2-row microbatch) gives ``grad_accum`` 1's step, and the reference's
    ``grad_accum`` 2 step."""
    ref, runs = dense
    for rank in runs["2x2"]:
        one, two = rank[1], rank[2]
        assert two["rows"]["tokens"] == (2, SEQ)
        np.testing.assert_allclose(float(two["loss"]), float(one["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(two["loss"]), ref[2]["loss"],
                                   rtol=1e-5)
        for path in one["full"]:
            if path.startswith("['params']"):
                np.testing.assert_allclose(
                    to_np(two["full"][path]), to_np(one["full"][path]),
                    err_msg=path, **ACCUM_TOL)
            np.testing.assert_allclose(
                to_np(two["full"][path]), ref[2]["state"][path],
                err_msg=path, **PARAM_TOL)


@pytest.mark.parametrize("accum, want", [
    (1, [[(0, 2)], [(2, 4)]]),
    (2, [[(0, 1), (2, 3)], [(1, 2), (3, 4)]])])
def test_batch_rows_give_each_rank_its_block_of_every_microbatch(accum,
                                                                  want):
    class TwoRanks:
        shape = {"data": 2, "model": 1}
        axis_names = ("data", "model")

        def __init__(self, r):
            self.r = r

        def coordinate(self):
            return {"data": self.r, "model": 0}

    assert [TS.batch_rows(TwoRanks(r), 4, accum) for r in (0, 1)] == want
    # rows that would not make whole blocks replicate
    assert TS.batch_rows(TwoRanks(1), 6, 2) == [(0, 6)]


# ---------------------------------------------------------------------------
# MoE: routing over the global batch
# ---------------------------------------------------------------------------

MOE_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = get_config("granite-moe-1b-a400m", smoke=True).with_(dtype="float32")
mesh = make_host_mesh((2, 1), ("data", "model"))
group = mesh.get_group("data")
rows = inp["x"].shape[0] // 2
x = inp["x"][RANK * rows:(RANK + 1) * rows]
d = x.shape[-1]
split = ctx.RowSplit(group, RANK, 2, rows)
out = {"alone": MOE.route(inp["layer"], cfg, x.reshape(-1, d))}
with ctx.data_rows(split):
    out["route"] = MOE.route(inp["layer"], cfg, x.reshape(-1, d))
    out["y"] = MOE.moe_layer(inp["layer"], cfg, x)

# one train step of the whole model on the rank's rows
opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
p_shard = shd.make_param_shardings(mesh, inp["params"], cfg)
opt = adamw.init(inp["params"], opt_cfg)
params = shd.distribute_tree(inp["params"], p_shard)
opt = shd.distribute_tree(opt, shd.make_opt_shardings(mesh, opt, p_shard))
step = ST.make_sharded_train_step(cfg, opt_cfg, mesh,
                                  global_batch=inp["rows"])
kept = []
real = MOE.route
def spy(p, c, xf):
    r = real(p, c, xf)
    kept.append(r[3])
    return r
MOE.route = spy
p2, o2, m = step(params, opt, ST.local_batch(mesh, inp["batch"]))
out["step_keep"] = kept
out["loss"] = m["loss"]
out["full"] = {p: t.full_tensor()
               for p, t in tree_flatten_with_path({"params": p2, "opt": o2})}
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _ref_routing(p, cfg, xf):
    """The reference's routing of ``xf`` (N, D): its own lines, which
    ``moe_layer`` computes and does not return."""
    m = cfg.moe
    n, k = xf.shape[0], m.top_k
    cap = JMOE.expert_capacity(n, cfg)
    logits = xf.astype(jnp.float32) @ p["router"]
    gate_w, gate_i = lax.top_k(logits, k)
    flat_i = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_i, m.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    flat_pos = jnp.take_along_axis(pos, flat_i[:, None], axis=1)[:, 0]
    return (np.asarray(gate_i), np.asarray(flat_pos.reshape(n, k)),
            np.asarray((flat_pos < cap).reshape(n, k)))


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    """granite-moe smoke in f32 on a (2, 1) mesh: one layer on an input
    whose every token picks expert 3 first (so the capacity of the whole
    batch is what drops), and one sharded train step."""
    jcfg, tcfg, jp, npp, tp = ref_and_port("granite-moe-1b-a400m", "float32")
    jcfg = jcfg.with_(attn_impl="blockwise")
    d = tcfg.d_model
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    x[..., 0] = 3.0
    layer = {k: np.array(v[0]) for k, v in npp["blocks"]["b0"]["moe"].items()}
    layer["router"][0, 3] = 40.0
    b = _global_batch(tcfg.vocab_size)
    tmp = str(tmp_path_factory.mktemp("moe"))
    torch.save({"x": torch.from_numpy(x),
                "layer": {k: torch.from_numpy(v) for k, v in layer.items()},
                "params": tp, "rows": ROWS,
                "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in b.items()}},
               os.path.join(tmp, "inputs.pt"))
    run_ranks(MOE_RANK, 2, tmp)
    ranks = [load_rank(tmp, r) for r in range(2)]
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
    ref_route = _ref_routing(jlayer, jcfg, jnp.asarray(x).reshape(-1, d))
    ref_y = np.asarray(JMOE.moe_layer(jlayer, jcfg, jnp.asarray(x)))
    step = jax.jit(JS.make_train_step(jcfg, _opt(JA)))
    p, s, m = step(jp, JA.init(jp, _opt(JA)),
                   {k: jnp.asarray(v) for k, v in b.items()})
    return ranks, ref_route, ref_y, (float(m["loss"]),
                                     _ref_state_paths(p, s))


def test_moe_drops_the_references_pairs_on_the_global_batch(moe):
    """Each rank holds 32 of the 64 tokens; every token's first choice is
    expert 3, whose capacity for the whole batch is 24 slots.  The ranks'
    positions, kept pairs and outputs, in row order, are the reference's
    on the global batch: rank 0 keeps 24 first choices, rank 1 none.
    Routed alone (without the row split) rank 1 would keep 16 of them —
    other pairs than the reference."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import moe as TMOE

    cfg = treg.get_config("granite-moe-1b-a400m", smoke=True)
    assert TMOE.expert_capacity(64, cfg) == 24
    assert TMOE.expert_capacity(32, cfg) == 16
    ranks, (gate_i, pos, keep), ref_y, _ = moe
    got_i = np.concatenate([r["route"][1].numpy() for r in ranks])
    got_pos = np.concatenate([r["route"][2].numpy() for r in ranks])
    got_keep = np.concatenate([r["route"][3].numpy() for r in ranks])
    np.testing.assert_array_equal(got_i, gate_i)
    np.testing.assert_array_equal(got_pos, pos)
    np.testing.assert_array_equal(got_keep, keep)
    np.testing.assert_array_equal(keep[:, 0], np.arange(64) < 24)
    alone = ranks[1]["alone"][3].numpy()
    assert alone[:, 0].sum() == 16
    got_y = np.concatenate([r["y"].numpy() for r in ranks])
    np.testing.assert_allclose(got_y, ref_y.reshape(got_y.shape),
                               atol=1e-4, rtol=1e-4)


def test_moe_step_on_a_mesh_matches_the_reference(moe):
    """granite-moe's sharded step (its layers drop pairs at init) against
    the reference's unsharded step on the global batch: loss and every
    leaf; both ranks routed with the capacity of the whole batch."""
    ranks, _, _, (loss, state) = moe
    for rank in ranks:
        assert rank["step_keep"] and not all(bool(k.all())
                                             for k in rank["step_keep"])
        np.testing.assert_allclose(float(rank["loss"]), loss, rtol=1e-5)
        for path, w in state.items():
            np.testing.assert_allclose(to_np(rank["full"][path]), w,
                                       err_msg=path, **PARAM_TOL)


# ---------------------------------------------------------------------------
# the training launcher: train(mesh=...)
# ---------------------------------------------------------------------------

COMMON = dict(arch="qwen2-0.5b", smoke=True, batch=2, seq=32, lr=1e-3,
              log_every=0, seed=3, device="cpu", steps=8, ckpt_every=4)

ONE_BY_ONE_RANK = """
import numpy as np
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels import conv2d_stream as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import mamba2_ssd as ms
from repro_torch.launch import train as T
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.tree import tree_flatten_with_path

kw = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
out = {"none": T.train(ckpt_dir=os.path.join(OUT, "none"), fail_at=(6,),
                       **kw)}
mesh = single_device_mesh("cpu")
out["mesh"] = T.train(ckpt_dir=os.path.join(OUT, "mesh"), mesh=mesh,
                      fail_at=(6,), **kw)
run = T.build_run(cfg=T.get_config(kw["arch"], smoke=True),
                  steps=kw["steps"], batch=kw["batch"], seq=kw["seq"],
                  ckpt_dir=None, lr=kw["lr"], seed=kw["seed"], device="cpu",
                  mesh=mesh)
tmpl = run.state_template()
shardings = {"params": run.p_shard, "opt": run.o_shard}
flat = lambda t: {p: (x.full_tensor() if hasattr(x, "full_tensor") else x)
                  for p, x in tree_flatten_with_path(t)}
kinds = lambda t: sorted({type(x).__name__ for _, x in
                          tree_flatten_with_path(t)})
none_ckpt = CheckpointManager(os.path.join(OUT, "none"))
mesh_ckpt = CheckpointManager(os.path.join(OUT, "mesh"))
onto_mesh, _ = none_ckpt.restore(8, tmpl, device="cpu", shardings=shardings)
onto_none, _ = mesh_ckpt.restore(8, tmpl, device="cpu")
out["restored"] = {"none_onto_mesh": flat(onto_mesh),
                   "mesh_onto_none": flat(onto_none),
                   "kinds": (kinds(onto_mesh), kinds(onto_none))}

# a DTensor handed to any kernel wrapper raises
from torch.distributed.tensor import distribute_tensor, Replicate
def dt(*shape, dtype=torch.float32):
    return distribute_tensor(torch.randn(*shape).to(dtype), mesh.device_mesh,
                             [Replicate(), Replicate()])
refused = {}
calls = {
    "flash_attention": lambda: fa.flash_attention(
        dt(2, 8, 16), dt(2, 8, 16), dt(2, 8, 16), heads_q=1, heads_kv=1),
    "flash_attention_bwd": lambda: fa.flash_attention_bwd(
        torch.randn(2, 8, 16), torch.randn(2, 8, 16), torch.randn(2, 8, 16),
        dt(2, 8, 16), dt(2, 8), dt(2, 8, 16), heads_q=1, heads_kv=1),
    "fused_mlp": lambda: fm.fused_mlp(dt(4, 8), dt(8, 16), dt(8, 16),
                                      dt(16, 8), act="silu"),
    "mamba2_ssd": lambda: ms.mamba2_ssd(dt(1, 8, 2, 4), dt(1, 8, 2), dt(2),
                                        dt(1, 8, 4), dt(1, 8, 4),
                                        dt(1, 2, 4, 4), chunk=8),
    "conv2d_stream": lambda: cs.conv2d_stream(dt(1, 6, 6, 2),
                                              dt(3, 3, 2, 4)),
}
for name, call in calls.items():
    try:
        call()
        refused[name] = "ran"
    except TypeError as e:
        refused[name] = str(e)
out["refused"] = refused
out["launches"] = (fa.launches, fm.launches, ms.launches, cs.launches)
torch.save(out, f"{OUT}/rank0.pt")
"""


@pytest.fixture(scope="module")
def one_by_one(tmp_path_factory):
    """In one process with no process group at start: ``train`` with
    ``mesh=None``, then on ``single_device_mesh("cpu")`` (a world of one
    on a ``HashStore``), each crashed at step 6; the step-8 checkpoints
    restored across; a DTensor handed to each kernel wrapper."""
    tmp = str(tmp_path_factory.mktemp("one_by_one"))
    torch.save(COMMON, os.path.join(tmp, "inputs.pt"))
    run_ranks(ONE_BY_ONE_RANK, 0, tmp)
    return tmp, load_rank(tmp, 0)


def test_one_by_one_mesh_logs_mesh_none_losses_bit_for_bit(one_by_one):
    _, got = one_by_one
    none, mesh = got["none"], got["mesh"]
    assert none["final_step"] == mesh["final_step"] == 8
    assert mesh["losses"] == none["losses"]          # exact float equality
    assert len(none["losses"]) == 10                  # steps 4, 5 replayed
    assert chip_smoke.restart_replays(none["losses"][:6] + none["losses"][8:],
                                      none["losses"], fail_at=6,
                                      restored_from=4)


def test_checkpoints_restore_across_mesh_and_no_mesh_bit_for_bit(one_by_one):
    """The step-8 checkpoint written with ``mesh=None`` restores onto the
    1 × 1 mesh (as DTensors) and the one written on the mesh restores
    onto the ``mesh=None`` path (as tensors), bit for bit; the two
    directories hold the same bytes."""
    tmp, got = one_by_one
    r = got["restored"]
    assert r["kinds"] == (["DTensor"], ["Tensor"])
    assert set(r["none_onto_mesh"]) == set(r["mesh_onto_none"])
    for path, t in r["none_onto_mesh"].items():
        assert t.dtype == r["mesh_onto_none"][path].dtype
        assert torch.equal(t, r["mesh_onto_none"][path]), path
    a = os.path.join(tmp, "none", "step_000000008")
    b = os.path.join(tmp, "mesh", "step_000000008")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 2
    for name in names:
        with open(os.path.join(a, name), "rb") as fa_, \
                open(os.path.join(b, name), "rb") as fb_:
            assert fa_.read() == fb_.read(), name


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd",
                                    "fused_mlp", "mamba2_ssd",
                                    "conv2d_stream"])
def test_a_dtensor_handed_to_a_kernel_wrapper_raises(one_by_one, kernel):
    """No DTensor reaches a hand-written kernel, and no wrapper takes its
    plain version for one: a DTensor operand raises ``TypeError``."""
    _, got = one_by_one
    assert "DTensor operand" in got["refused"][kernel]
    assert got["launches"] == (0, 0, 0, 0)


TWO_RANKS_TRAIN = """
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh

kw = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = make_host_mesh((2, 1), ("data", "model"))
out = {"clean": T.train(ckpt_dir=os.path.join(OUT, "clean"), mesh=mesh,
                        **kw),
       "crash": T.train(ckpt_dir=os.path.join(OUT, "crash"), mesh=mesh,
                        fail_at=(6,), **dict(kw, log_every=1))}
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def test_a_crashed_run_on_a_mesh_logs_the_clean_losses(tmp_path):
    """``train(mesh=make_host_mesh((2, 1)))``: a run crashed at step 6
    and restarted from its step-4 checkpoint (written by rank 0, read by
    both) logs the clean run's losses bit for bit on both ranks; only
    rank 0 prints."""
    torch.save(COMMON, os.path.join(tmp_path, "inputs.pt"))
    stdout = run_ranks(TWO_RANKS_TRAIN, 2, tmp_path)
    ranks = [load_rank(tmp_path, r) for r in range(2)]
    for got in ranks:
        lc, lk = got["clean"]["losses"], got["crash"]["losses"]
        assert got["clean"]["final_step"] == got["crash"]["final_step"] == 8
        assert chip_smoke.restart_replays(lc, lk, fail_at=6, restored_from=4)
        assert all(np.isfinite(lc))
    assert ranks[0]["clean"]["losses"] == ranks[1]["clean"]["losses"]
    assert "[train] step" in stdout[0] and "[train]" not in stdout[1]
    assert sorted(os.listdir(tmp_path / "crash")) == [
        "step_000000004", "step_000000008"]


def test_the_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train ... --device cpu``: a gloo (2, 1) mesh from
    torchrun's environment, both ranks training, rank 0 printing."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "32", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ckpt"), "--ckpt-every", "3"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count('"final_step": 3') == 1
    assert os.listdir(tmp_path / "ckpt") == ["step_000000003"]


def test_a_rank_draws_its_rows_as_a_reference_host_does():
    """On a mesh a rank draws its rows keyed as the reference keys a
    host's rows (``SeedSequence([seed, step, host_row_start])``): the
    port's draw of rows 2-3 of 4 equals the reference host's, bit for
    bit — and differs from rows 2-3 of one host's draw of the whole
    batch, in both packages, so a (2, 1) mesh trains on another batch
    than one device does (the 1 × 1 mesh draws the whole batch)."""
    from repro_torch.data import pipeline as TPIPE

    kw = dict(seed=3, vocab_size=256, seq_len=SEQ, global_batch=ROWS)
    ref = JP.lm_batch(JP.DataConfig(host_row_start=2, host_row_end=4, **kw),
                      1)
    got = TPIPE.lm_batch(TPIPE.DataConfig(host_row_start=2, host_row_end=4,
                                          **kw), 1)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], ref[k])
    whole = TPIPE.lm_batch(TPIPE.DataConfig(**kw), 1)
    assert not np.array_equal(whole["tokens"][2:4], got["tokens"])


ONE_BY_ONE_CLI_RANK = """
from repro_torch.launch import train as T
from repro_torch.launch.mesh import single_device_mesh

kw = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
out = T.train(mesh=single_device_mesh("cpu"), ckpt_dir=None, **kw)
torch.save(out, f"{OUT}/rank0.pt")
"""


def test_the_cli_without_torchrun_logs_the_one_by_one_mesh_losses(tmp_path):
    """The command line without ``torchrun`` trains with ``mesh=None``;
    its losses are those of ``train(mesh=single_device_mesh("cpu"))`` in
    a process of its own, bit for bit."""
    kw = dict(COMMON, steps=2, ckpt_every=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         kw["arch"], "--smoke", "--steps", "2", "--batch", str(kw["batch"]),
         "--seq", str(kw["seq"]), "--lr", str(kw["lr"]), "--seed",
         str(kw["seed"]), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert cli.returncode == 0, cli.stderr[-3000:]
    torch.save(kw, os.path.join(tmp_path, "inputs.pt"))
    run_ranks(ONE_BY_ONE_CLI_RANK, 0, tmp_path)
    losses = load_rank(tmp_path, 0)["losses"]
    assert len(losses) == 2
    assert cli.stdout.strip().splitlines()[-1] == (
        f"[train] first loss {losses[0]:.4f} last loss {losses[-1]:.4f}")


TWO_CARD_PHASE = """
sys.path.insert(0, {repo!r})
import chip_smoke
run = dict(batch=4, seq=32, lr=1e-3, seed=3)
res = chip_smoke.two_card_run(torch, run, arch="qwen2-0.5b", smoke=True,
                              device="cpu", out_dir=OUT)
torch.save(res, f"{{OUT}}/rank0.pt")
"""


def test_the_two_card_phase_runs_on_two_gloo_ranks(tmp_path):
    """``chip_smoke.two_card_run``, which the card machine runs only with
    two cards, on the CPU: its rank script under ``torchrun`` as a (2, 1)
    gloo mesh, held to the 1 × 1 mesh on the global batch its ranks
    draw, whose spans are ``steps.batch_rows``' for each rank."""
    assert chip_smoke.two_card_rows(4) == [(0, 2), (2, 4)]
    run_ranks(TWO_CARD_PHASE.format(repo=REPO), 0, tmp_path)
    got = load_rank(tmp_path, 0)
    assert len(got["losses_2x1"]) == len(got["losses_1x1"]) == 2
    assert all(np.isfinite(got["losses_2x1"]))
    assert got["loss_rel_gap"] <= got["rule_rtol"]
