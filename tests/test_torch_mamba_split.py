"""The Mamba-2 mixer split by heads along ``model``: the column order in
which ``distributed/sharding.py`` lays out ``in_proj``, ``conv_w`` and
the conv cache (each part ``z | x | B | C | dt`` cut into ``model``
blocks, a rank's blocks side by side), checkpoints and int8 weights
across meshes in that order, and the fallback where ``model`` does not
divide the heads or the state (``models/mamba2.py:_whole_leaves``: every
rank computes every column), on CPU gloo meshes of spawned ranks
(``_torch_ranks.run_ranks``).

The split itself — serving and the train step at (1, 2), (2, 2) and
(1, 4) against the reference's unsharded functions, B4's head count, the
planted gradient faults — is held in ``test_torch_mesh_serve.py`` and
``test_torch_mesh_train_tp.py`` beside every other family."""
import dataclasses
import os

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.optim import adamw as tadamw
from repro_torch.quant import ptq as tptq
from repro_torch.tree import tree_flatten_with_path

from _torch_ranks import load_rank, run_ranks

ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")


def _cfg(arch: str, smoke: bool):
    return treg.get_config(arch, smoke=smoke)


def _fallback_cfg():
    """mamba2-1.3b's smoke config with a state of 15: ``model`` = 2
    divides the heads (8), ``in_proj``'s 294 columns and the conv's 158,
    so the rules cut those leaves, but not the state."""
    cfg = _cfg("mamba2-1.3b", True)
    return cfg.with_(ssm=dataclasses.replace(cfg.ssm, state_dim=15))


#: (arch, smoke, count): every ``model`` count up to 16 that divides the
#: config's heads and state
ORDER_CASES = [(a, sm, c) for a in ARCHS for sm in (True, False)
               for c in (1, 2, 4, 16)
               if tshd.mixer_splits(treg.get_config(a, smoke=sm), c)]


@pytest.mark.parametrize("arch,smoke,count", ORDER_CASES)
def test_the_column_order_and_its_inverse_round_trip(arch, smoke, count):
    """``mixer_order`` is a permutation whose inverse undoes it, the
    identity at one rank; rank ``r``'s block of the laid-out columns — the
    rules' local extent — holds block ``r`` of each part: its heads' ``z``
    and ``x`` columns and ``dt``, its share of ``B`` and ``C`` (of ``x |
    B | C`` for the conv)."""
    cfg = _cfg(arch, smoke)
    for conv in (False, True):
        parts = tshd.mixer_parts(cfg, conv=conv)
        width = sum(parts)
        order = tshd.mixer_order(cfg, count, conv=conv)
        inverse = tshd.mixer_order_inverse(cfg, count, conv=conv)
        assert sorted(order.tolist()) == list(range(width))
        assert torch.equal(order[inverse], torch.arange(width))
        assert torch.equal(inverse[order], torch.arange(width))
        if count == 1:
            assert torch.equal(order, torch.arange(width))
        starts = [sum(parts[:i]) for i in range(len(parts))]
        local = width // count
        for r in range(count):
            want = [c for s0, w in zip(starts, parts)
                    for c in range(s0 + r * w // count,
                                   s0 + (r + 1) * w // count)]
            assert order[r * local:(r + 1) * local].tolist() == want


def test_the_rules_carry_the_mixer_parts_where_the_split_applies():
    """On the production 16 × 16 mesh mamba2-1.3b's and Jamba's
    ``in_proj`` and ``conv_w`` (their AdamW moments, the int8 ``q`` and
    ``scale``) and the conv cache carry their parts, and no other leaf
    does; the specs stay the reference's (``test_torch_sharding.py``).
    One rank along ``model``, or a state it does not divide, leaves every
    leaf cut as it lies."""
    mesh = tmesh.Mesh((16, 16), ("data", "model"))
    for arch in ARCHS:
        cfg = _cfg(arch, False)
        params = tspecs.params_specs(cfg)
        p_shard = tshd.make_param_shardings(mesh, params, cfg)
        opt = tshd.make_opt_shardings(
            mesh, tadamw.init(params, tadamw.AdamWConfig()), p_shard)
        q = tptq.quantized_param_shardings(p_shard, params)
        for tree in (p_shard, opt, q):
            carried = {p: sh.parts for p, sh in tree_flatten_with_path(tree)
                       if sh.parts is not None}
            assert carried, arch
            for path, parts in carried.items():
                conv = "conv_w" in path
                assert ("in_proj" in path) != conv, path
                assert parts == tshd.mixer_parts(cfg, conv=conv), path
        cache = tspecs.decode_input_specs(cfg, SHAPES["decode_32k"])["cache"]
        c_shard = tshd.make_cache_shardings(mesh, cache, cfg)
        carried = {p for p, sh in tree_flatten_with_path(c_shard)
                   if sh.parts is not None}
        assert carried and carried == {
            p for p, _ in tree_flatten_with_path(cache)
            if p.endswith("['conv']")}
    one = tmesh.Mesh((16, 1), ("data", "model"))
    cfg = _cfg("mamba2-1.3b", True)
    for m, c in ((one, cfg), (tmesh.Mesh((1, 2), ("data", "model")),
                              _fallback_cfg())):
        params = tspecs.params_specs(c)
        shardings = tshd.make_param_shardings(m, params, c)
        assert all(sh.parts is None
                   for _, sh in tree_flatten_with_path(shardings))
    # the fallback's leaves still lie on ``model``, cut as they lie
    spec = dict(tree_flatten_with_path(shardings))[
        "['blocks']['b0']['mamba']['in_proj']"].spec
    assert spec[-1] == "model"


#: a (1, 2) mesh: mamba2-1.3b's smoke params and AdamW state placed by the
#: rules and saved; its int8 tree placed
SAVE_RANK = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd, tp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.quant import ptq
from repro_torch.tree import tree_flatten_with_path

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = get_config("mamba2-1.3b", smoke=True)
mesh = make_host_mesh((1, 2), ("data", "model"))
p_shard = shd.make_param_shardings(mesh, inp["state"]["params"], cfg)
shardings = {"params": p_shard, "opt": shd.make_opt_shardings(
    mesh, inp["state"]["opt"], p_shard)}
placed = shd.distribute_tree(inp["state"], shardings)
CheckpointManager(os.path.join(OUT, "ckpt")).save(
    1, placed, extra={"mesh": "1x2"}, shardings=shardings)
out = {"local": {p: t.to_local().clone()
                 for p, t in tree_flatten_with_path(placed)},
       "whole": dict(tree_flatten_with_path(shd.whole_tree(placed,
                                                           shardings)))}
q_shard = ptq.quantized_param_shardings(p_shard, inp["state"]["params"])
q = shd.distribute_tree(inp["q"], q_shard)
out["q_local"] = dict(tree_flatten_with_path(
    ptq.dequantize_params(tp.to_local(q), torch.float32)))
out["q_whole"] = dict(tree_flatten_with_path(shd.whole_tree(q, q_shard)))
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""

#: a (1, 4) mesh (a process group of its own, in a directory of its own):
#: the (1, 2) checkpoint restored by the rules here, and onto one device
RESTORE_RANK = """
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path

cfg = get_config("mamba2-1.3b", smoke=True)
mesh = make_host_mesh((1, 4), ("data", "model"))
tmpl = {"params": specs.params_specs(cfg)}
tmpl["opt"] = adamw.init(tmpl["params"], adamw.AdamWConfig())
p_shard = shd.make_param_shardings(mesh, tmpl["params"], cfg)
shardings = {"params": p_shard,
             "opt": shd.make_opt_shardings(mesh, tmpl["opt"], p_shard)}
mgr = CheckpointManager(os.path.join(os.path.dirname(OUT), "ckpt"))
restored, extra = mgr.restore(1, tmpl, device="cpu", shardings=shardings)
single, _ = mgr.restore(1, tmpl, device="cpu")
out = {"extra": extra, "coord": mesh.coordinate(),
       "local": {p: t.to_local().clone()
                 for p, t in tree_flatten_with_path(restored)},
       "whole": dict(tree_flatten_with_path(shd.whole_tree(restored,
                                                           shardings))),
       "single": dict(tree_flatten_with_path(single))}
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _laid_out(t: torch.Tensor, path: str, cfg, count: int, rank: int):
    """Rank ``rank``'s block along ``model`` of the whole leaf ``t`` at
    ``path`` as the rules lay it out (the mixer order where the leaf
    carries parts)."""
    if "['in_proj']" in path or "['conv_w']" in path:
        t = t.index_select(-1, tshd.mixer_order(
            cfg, count, conv="conv_w" in path))
        size = t.shape[-1] // count
        return t[..., rank * size:(rank + 1) * size]
    return None


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    """mamba2-1.3b's smoke state (bf16 params, f32 moments after a draw
    of noise) saved on (1, 2) and restored on (1, 4) and one device."""
    from repro_torch.launch import steps as TS

    tmp = tmp_path_factory.mktemp("mamba_ckpt")
    cfg = _cfg("mamba2-1.3b", True)
    params = TS.model_init(torch.Generator().manual_seed(0), cfg)
    opt = tadamw.init(params, tadamw.AdamWConfig())
    gen = torch.Generator().manual_seed(1)
    opt = opt._replace(mu={k: v for k, v in _noise(opt.mu, gen).items()})
    state = {"params": params, "opt": opt}
    q = tptq.quantize_params(params)
    torch.save({"state": state, "q": q}, os.path.join(tmp, "inputs.pt"))
    run_ranks(SAVE_RANK, 2, tmp)
    saved = [load_rank(tmp, r) for r in range(2)]
    run_ranks(RESTORE_RANK, 4, tmp / "restore")
    restored = [load_rank(tmp / "restore", r) for r in range(4)]
    return tmp, cfg, state, q, saved, restored


def _noise(tree, gen):
    if isinstance(tree, dict):
        return {k: _noise(v, gen) for k, v in tree.items()}
    return torch.randn(tree.shape, generator=gen).to(tree.dtype)


def test_a_checkpoint_holds_the_references_column_order(moved):
    """The (1, 2) ranks hold their heads' columns (the mixer order), and
    the file holds every leaf as the whole state, bit for bit: the
    reference's order whatever mesh wrote it."""
    from repro_torch.checkpoint.manager import CheckpointManager

    tmp, cfg, state, _, saved, _ = moved
    want = dict(tree_flatten_with_path(state))
    for r, got in enumerate(saved):
        for path, t in want.items():
            assert torch.equal(got["whole"][path], t), path
            block = _laid_out(t, path, cfg, 2, r)
            if block is not None:
                assert torch.equal(got["local"][path], block), path
    tmpl = {"params": tspecs.params_specs(cfg)}
    tmpl["opt"] = tadamw.init(tmpl["params"], tadamw.AdamWConfig())
    single, extra = CheckpointManager(str(tmp / "ckpt")).restore(
        1, tmpl, device="cpu")
    assert extra == {"mesh": "1x2"}
    for path, t in tree_flatten_with_path(single):
        assert torch.equal(t, want[path]), path


def test_a_checkpoint_from_1x2_restores_on_1x4_and_one_device(moved):
    """Restored by the (1, 4) rules every rank holds its heads' columns of
    the saved state, whole again bit for bit; onto one device the state
    bit for bit."""
    _, cfg, state, _, _, restored = moved
    want = dict(tree_flatten_with_path(state))
    for got in restored:
        r = got["coord"]["model"]
        assert got["extra"] == {"mesh": "1x2"}
        for path, t in want.items():
            assert torch.equal(got["whole"][path], t), path
            assert torch.equal(got["single"][path], t), path
            block = _laid_out(t, path, cfg, 4, r)
            if block is not None:
                assert torch.equal(got["local"][path], block), path


def test_int8_q_and_scale_move_together(moved):
    """On (1, 2) each rank's int8 ``in_proj`` and ``conv_w`` dequantize
    with their own scales to the rank's columns of the dequantized whole,
    and ``whole`` gives back ``q`` and ``scale`` bit for bit."""
    _, cfg, _, q, saved, _ = moved
    deq = dict(tree_flatten_with_path(tptq.dequantize_params(
        q, torch.float32)))
    want = dict(tree_flatten_with_path(q))
    for r, got in enumerate(saved):
        for path, t in want.items():
            assert torch.equal(got["q_whole"][path], t), path
        n = 0
        for path, t in deq.items():
            block = _laid_out(t, path, cfg, 2, r)
            if block is not None:
                assert torch.equal(got["q_local"][path], block), path
                n += 1
        assert n == 2


#: the fallback config on (1, 2): one prefill and decode, and one split
#: train step, beside mesh=None; the mixer's gathers and B4's heads
FALLBACK_RANK = """
import dataclasses
import numpy as np
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd, tp
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import mamba2
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path

base = get_config("mamba2-1.3b", smoke=True).with_(dtype="float32")
cfg = base.with_(ssm=dataclasses.replace(base.ssm, state_dim=15))
mesh = make_host_mesh((1, 2), ("data", "model"))
params = ST.model_init(torch.Generator().manual_seed(0), cfg)
seen = {"whole": 0, "gathered": [], "ssd": []}
real = (mamba2._whole_leaves, tp.gather, ops.mamba2_ssd)

def whole(p, c):
    seen["whole"] += 1
    return real[0](p, c)

def gather(t, dim, split):
    if split is not None:
        seen["gathered"].append(tuple(t.shape))
    return real[1](t, dim, split)

def ssd(x, *a, **kw):
    seen["ssd"].append(x.shape[2])
    return real[2](x, *a, **kw)

mamba2._whole_leaves, tp.gather, ops.mamba2_ssd = whole, gather, ssd
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
out = {}
for name, m in (("none", None), ("mesh", mesh)):
    eng = ServeEngine(cfg, device="cpu", max_len=24, params=params, mesh=m)
    out[name] = {"tokens": eng.generate(prompts, max_new=6)[0]}
    out[name]["logits"] = eng.prefill(prompts)[0]
opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
gen = torch.Generator().manual_seed(1)
batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                          dtype=torch.int32) for k in ("tokens", "labels")}
opt = adamw.init(params, opt_cfg)
p1, o1, m1 = ST.make_train_step(cfg, opt_cfg)(params, opt, batch)
p_shard = shd.make_param_shardings(mesh, params, cfg)
o_shard = shd.make_opt_shardings(mesh, opt, p_shard)
step = ST.make_sharded_train_step(cfg, opt_cfg, mesh, global_batch=2)
p2, o2, m2 = step(shd.distribute_tree(params, p_shard),
                  shd.distribute_tree(opt, o_shard), batch)
out["train"] = {"loss": (float(m1["loss"]), float(m2["loss"])),
                "none": dict(tree_flatten_with_path({"p": p1, "o": o1})),
                "mesh": dict(tree_flatten_with_path(shd.whole_tree(
                    {"p": p2, "o": o2}, {"p": p_shard, "o": o_shard})))}
out["seen"] = dict(seen, gathered=sorted(set(seen["gathered"])),
                   ssd=sorted(set(seen["ssd"])))
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def test_the_fallback_gathers_the_mixer_where_model_does_not_divide_the_state(
        tmp_path):
    """A state of 15 on ``model`` = 2: the mixer gathers ``in_proj``,
    ``conv_w`` and ``out_proj`` whole (``_whole_leaves``) and B4 sees
    every head, and the mesh serves ``mesh=None``'s greedy tokens and
    trains to its state, at ``test_torch_mesh_train_tp.py``'s
    tolerances."""
    import numpy as np

    from _torch_port import to_np

    run_ranks(FALLBACK_RANK, 2, tmp_path)
    cfg = _fallback_cfg()
    s, d = cfg.ssm, cfg.d_model
    di, h = s.d_inner(d), s.num_heads(d)
    width = 2 * di + 2 * s.state_dim + h
    for r in range(2):
        got = load_rank(tmp_path, r)
        seen = got["seen"]
        assert seen["whole"] > 0 and seen["ssd"] == [h]
        for leaf in ((d, width // 2), (s.conv_kernel, s.conv_dim(d) // 2),
                     (di // 2, d)):
            assert leaf in seen["gathered"], (leaf, seen["gathered"])
        np.testing.assert_array_equal(got["mesh"]["tokens"],
                                      got["none"]["tokens"])
        np.testing.assert_allclose(to_np(got["mesh"]["logits"]),
                                   to_np(got["none"]["logits"]),
                                   atol=1e-4, rtol=1e-4)
        loss = got["train"]["loss"]
        np.testing.assert_allclose(loss[1], loss[0], rtol=1e-5)
        for path, want in got["train"]["none"].items():
            np.testing.assert_allclose(to_np(got["train"]["mesh"][path]),
                                       to_np(want), atol=3e-4, rtol=1e-3,
                                       err_msg=path)
