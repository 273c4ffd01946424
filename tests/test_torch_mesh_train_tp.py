"""The mesh train step split along ``model`` and gathering its params
along the data axes one superblock at a time
(``launch.steps.make_sharded_train_step``, ``distributed/tp.py``'s
autograd-aware collectives, the vocabulary-parallel chunked CE of
``models/lm.py``) on CPU gloo meshes of spawned ranks
(``_torch_ranks.run_ranks``), at the smoke configs in f32.

The reference's own mesh train step fails on this jax
(``test_sharding.py::TestMultiDeviceParity``, ROADMAP §C), so each mesh
step is held against the reference's **unsharded** jitted
``make_train_step`` on the same parameters and the same global batch, at
``test_torch_mesh_train.py``'s tolerances: loss rtol 1e-5, every leaf of
the parameters and moments atol 3e-4, rtol 1e-3 (the partial sums over
``model`` and the reduce-scatters over the data axes add in another
order); ``grad_accum`` 2 against 1 on a mesh at the reference's
grad-accum tolerances (atol = rtol = 2e-5).

The smoke configs have 4 query and 2 kv heads (seamless and olmoe 4 and
4), ``d_ff`` 128 (the MoE's 32 a expert, 8 experts) and 256 vocabulary
rows: at ``model`` = 2 every split is taken.  The attention computes by
``layers.head_case``: where both head counts divide ``model`` a rank
computes its query and kv heads (``HEADS``: every config at 2, olmoe at
4); where only the query heads do (``QUERY``: llama, qwen2-vl, Jamba and
seamless with 2 kv heads at 4; ``straddle``, 6 query and 3 kv heads, at
2) its query heads against the kv heads they read, projected from the
whole ``wk`` / ``wv`` / ``bk`` / ``bv``, whose gradients are summed over
``model``; where neither does (``WHOLE``) every rank computes every
head.  No attention leaf is gathered along ``model``."""
import inspect
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.optim import adamw as JA

from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm

import chip_smoke
from _torch_port import REPO, flat, ref_and_port, to_np
from _torch_ranks import load_rank, run_ranks

ROWS, SEQ, FRAMES = 4, 32, 16
#: 6 query and 3 kv heads: at ``model`` = 2 a rank's 3 query heads read 2
#: kv heads
STRADDLE = {"num_heads": 6, "num_kv_heads": 3, "head_dim": 16}
PARAM_TOL = dict(atol=3e-4, rtol=1e-3)
ACCUM_TOL = dict(atol=2e-5, rtol=2e-5)
NU_RTOL = 1e-4

#: case → (arch, config overrides, global batch rows, grad_accum values).
#: ``padded``: 250 vocabulary rows padded to 256, so that the padded
#: columns lie on the last rank of ``model``; ``rows3``: a global batch of
#: 3 rows, which the data axis of 2 does not divide (every rank computes
#: every row); ``straddle``: :data:`STRADDLE`, at ``model`` = 2;
#: ``seamless-m4t-medium-gqa``: 2 kv heads, its self- and
#: cross-attention ``QUERY`` at ``model`` = 4; ``qwen2-vl-72b``: the VLM on
#: embeddings and M-RoPE positions, with q / k / v biases
CASES = {
    "llama3.2-1b": ("llama3.2-1b", {}, ROWS, (1,)),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, ROWS, (1,)),
    "mamba2-1.3b": ("mamba2-1.3b", {}, ROWS, (1,)),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}, ROWS, (1,)),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, ROWS, (1,)),
    "olmoe-1b-7b": ("olmoe-1b-7b", {}, ROWS, (1,)),
    "padded": ("llama3.2-1b", {"vocab_size": 250, "pad_vocab_to": 128},
               ROWS, (1,)),
    "rows3": ("llama3.2-1b", {}, 3, (1,)),
    "accum": ("llama3.2-1b", {}, ROWS, (1, 2)),
    "router_unsummed": ("granite-moe-1b-a400m", {}, ROWS, (1,)),
    "bc_gathered": ("mamba2-1.3b", {}, ROWS, (1,)),
    "stat_partial": ("mamba2-1.3b", {}, ROWS, (1,)),
    "straddle": ("llama3.2-1b", STRADDLE, ROWS, (1,)),
    "kv_unsummed": ("llama3.2-1b", STRADDLE, ROWS, (1,)),
    "seamless-m4t-medium-gqa": ("seamless-m4t-medium", {"num_kv_heads": 2},
                                ROWS, (1,)),
    "qwen2-vl-72b": ("qwen2-vl-72b", {}, ROWS, (1,)),
}
#: cases that run with a fault planted, to show that the checks catch it:
#: case → (the model module whose ``tp`` it replaces, the fault's class)
PLANTED = {"kv_unsummed": ("layers", "KvNotEntered"),
           "router_unsummed": ("moe", "RouterNotEntered"),
           "bc_gathered": ("mamba2", "BCGatheredAsLeaves"),
           "stat_partial": ("mamba2", "NormStatNotShared")}
FAMILIES = ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-1.3b",
            "jamba-1.5-large-398b", "seamless-m4t-medium"]
#: mesh → (shape, cases)
MESHES = {
    "1x2": ((1, 2), FAMILIES + ["padded", *PLANTED]),
    "2x2": ((2, 2), FAMILIES + ["rows3", "accum", "straddle"]),
    "1x4": ((1, 4), ["llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b",
                     "jamba-1.5-large-398b", "seamless-m4t-medium-gqa",
                     "qwen2-vl-72b"]),
}


def spy_kernels(seen):
    """Record the wrappers' shapes into ``seen`` (``attn``: query and kv
    heads; ``experts``: the experts of a ``bmm``; ``ssd``: B4's heads),
    the shapes ``tp.gather`` joins along ``model`` (``gather``) and the
    ``DTensor.full_tensor`` calls (``full``); → what to put back."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import tp
    from repro_torch.kernels import ops

    real = (ops.flash_attention, torch.bmm, DTensor.full_tensor,
            ops.mamba2_ssd, tp.gather)

    def attn(q, k, v, **kw):
        seen["attn"].append((q.shape[1], k.shape[1]))
        return real[0](q, k, v, **kw)

    def bmm(a, b):
        seen["experts"].append(b.shape[0])
        return real[1](a, b)

    def full(self, *a, **kw):
        seen["full"].append(tuple(self.shape))
        return real[2](self, *a, **kw)

    def ssd(x, *a, **kw):
        seen["ssd"].append(x.shape[2])
        return real[3](x, *a, **kw)

    def gather(t, dim, split):
        if split is not None:
            seen["gather"].append(tuple(t.shape))
        return real[4](t, dim, split)

    ops.flash_attention, torch.bmm, DTensor.full_tensor = attn, bmm, full
    ops.mamba2_ssd, tp.gather = ssd, gather
    return real


def unspy_kernels(real) -> None:
    """Put back what :func:`spy_kernels` replaced."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import tp
    from repro_torch.kernels import ops

    (ops.flash_attention, torch.bmm, DTensor.full_tensor, ops.mamba2_ssd,
     tp.gather) = real


class RouterNotEntered:
    """``distributed.tp`` as ``models/moe.py`` sees it, with a fault
    planted: the router leaf — the layer's one 2-D ``enter`` — enters as
    it is, so its gradient stays this rank's partial (a rank weights
    only its own experts' choices) instead of the sum over ``model``."""

    def __getattr__(self, name):
        from repro_torch.distributed import tp

        return getattr(tp, name)

    @staticmethod
    def enter(t, split):
        from repro_torch.distributed import tp

        return t if t.ndim == 2 else tp.enter(t, split)


class BCGatheredAsLeaves:
    """``distributed.tp`` as ``models/mamba2.py`` sees it, with a fault
    planted: ``B`` and ``C`` gathered by ``tp.gather``, whose backward
    keeps this rank's block of its own gradient, where every rank's heads
    give a partial gradient of the whole (``tp.gather_shared`` sums
    them)."""

    def __getattr__(self, name):
        from repro_torch.distributed import tp

        return getattr(tp, name)

    @staticmethod
    def gather_shared(t, dim, split):
        from repro_torch.distributed import tp

        return tp.gather(t, dim, split)


class NormStatNotShared:
    """``distributed.tp`` as ``models/mamba2.py`` sees it, with a fault
    planted: the gated norm's statistic summed by ``tp.sum_partial``,
    whose backward passes the gradient on, where each rank's output
    columns give only their share of it (``tp.sum_shared`` sums them)."""

    def __getattr__(self, name):
        from repro_torch.distributed import tp

        return getattr(tp, name)

    @staticmethod
    def sum_shared(t, split):
        from repro_torch.distributed import tp

        return tp.sum_partial(t, split)


class KvNotEntered:
    """``distributed.tp`` as ``models/layers.py`` sees it, with a fault
    planted: where only the query heads split, the whole ``wk``, ``wv``,
    ``bk`` and ``bv`` — the layer's 2-D and 1-D ``enter`` — enter as
    they are, so each rank updates them with its own heads' share of
    their gradient instead of the sum over ``model``."""

    def __getattr__(self, name):
        from repro_torch.distributed import tp

        return getattr(tp, name)

    @staticmethod
    def enter(t, split):
        from repro_torch.distributed import tp

        return t if t.ndim <= 2 else tp.enter(t, split)


#: one mesh's steps on a rank: each case's params and AdamW state placed
#: by the rules, one step a ``grad_accum`` on the rank's rows of the
#: global batch, the wrappers' shapes and ``full_tensor`` calls recorded
#: inside the step; saved: loss, grad norm, every leaf after the step
STEP_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, mamba2, moe
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path
from torch.distributed.tensor import DTensor

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = make_host_mesh(inp["shape"], ("data", "model"))
opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
out = {"coord": mesh.coordinate()}
for name, case in inp["cases"].items():
    cfg = get_config(case["arch"], smoke=True).with_(dtype="float32",
                                                      **case["kw"])
    p_shard = shd.make_param_shardings(mesh, case["params"], cfg)
    opt = adamw.init(case["params"], opt_cfg)
    o_shard = shd.make_opt_shardings(mesh, opt, p_shard)
    params = shd.distribute_tree(case["params"], p_shard)
    opt = shd.distribute_tree(opt, o_shard)
    res = {}
    for accum in case["accums"]:
        step = ST.make_sharded_train_step(cfg, opt_cfg, mesh,
                                          global_batch=case["rows"],
                                          grad_accum=accum)
        local = ST.local_batch(mesh, case["batch"], accum)
        seen = {"attn": [], "experts": [], "full": [], "ssd": [], "gather": []}
        real, models_tp = spy_kernels(seen), (mamba2.tp, moe.tp, layers.tp)
        if case["planted"]:
            module, fault = globals()[case["planted"][0]], case["planted"][1]
            module.tp = globals()[fault]()
        try:
            p2, o2, m = step(params, opt, local)
        finally:
            unspy_kernels(real)
            mamba2.tp, moe.tp, layers.tp = models_tp
        state = {"params": p2, "opt": o2}
        res[accum] = {
            "rows": {k: tuple(v.shape) for k, v in local.items()},
            "loss": m["loss"], "grad_norm": m["grad_norm"],
            "seen": {k: sorted(set(v)) for k, v in seen.items()},
            "full_calls": len(seen["full"]),
            "full": dict(tree_flatten_with_path(shd.whole_tree(
                state, {"params": p_shard, "opt": o_shard}))),
        }
    out[name] = res
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _opt(mod):
    return mod.AdamWConfig(warmup_steps=1, total_steps=10)


def _batch(case: str, vocab: int, d_model: int) -> dict:
    """The global batch of ``case`` (NumPy): the reference's ``lm_batch``
    draw; the encoder–decoder's with its stub frames."""
    arch, _, rows, _ = CASES[case]
    b = JP.lm_batch(JP.DataConfig(seed=3, vocab_size=vocab, seq_len=SEQ,
                                  global_batch=rows), 0)
    b = {k: np.ascontiguousarray(v) for k, v in b.items()}
    if arch == "seamless-m4t-medium":
        b["frames"] = np.random.default_rng(5).standard_normal(
            (rows, FRAMES, d_model)).astype(np.float32)
    if arch == "qwen2-vl-72b":            # stub embeddings for the tokens
        rng = np.random.default_rng(5)
        del b["tokens"]
        b["embeds"] = rng.standard_normal((rows, SEQ, d_model)).astype(
            np.float32)
        b["mrope_positions"] = rng.integers(0, SEQ, (3, rows, SEQ)).astype(
            np.int32)
    return b


def _ref_state_paths(jp, js) -> dict:
    """{port path: f32 NumPy} of the reference's params and AdamW state."""
    return {jax.tree_util.keystr(k): to_np(v)
            for k, v in jax.tree_util.tree_flatten_with_path(
                {"params": jp, "opt": js})[0]}


def _reference(case: str) -> dict:
    """The reference's unsharded jitted step on ``case``'s global batch,
    for each of its ``grad_accum`` values."""
    arch, kw, _, accums = CASES[case]
    jcfg, tcfg, jp, _, _ = ref_and_port(arch, "float32", **kw)
    jcfg = jcfg.with_(attn_impl="blockwise")
    b = _batch(case, tcfg.vocab_size, tcfg.d_model)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = {}
    for accum in accums:
        step = jax.jit(JS.make_train_step(jcfg, _opt(JA), grad_accum=accum))
        p, s, m = step(jp, JA.init(jp, _opt(JA)), jb)
        out[accum] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "state": _ref_state_paths(p, s)}
    return out


def _run_mesh(tmp, shape, names):
    cases = {}
    for name in names:
        arch, kw, rows, accums = CASES[name]
        _, tcfg, _, _, tp = ref_and_port(arch, "float32", **kw)
        cases[name] = {"arch": arch, "kw": kw, "rows": rows,
                       "accums": accums, "planted": PLANTED.get(name),
                       "params": tp,
                       "batch": {k: torch.from_numpy(v) for k, v in _batch(
                           name, tcfg.vocab_size, tcfg.d_model).items()}}
    torch.save({"shape": shape, "cases": cases},
               os.path.join(tmp, "inputs.pt"))
    world = shape[0] * shape[1]
    run_ranks("".join(inspect.getsource(f) for f in (
        spy_kernels, unspy_kernels, RouterNotEntered, BCGatheredAsLeaves,
        NormStatNotShared, KvNotEntered)) + STEP_RANK, world, tmp)
    return [load_rank(tmp, r) for r in range(world)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Every mesh's cases (the meshes at once) beside the reference's
    unsharded steps."""
    for name in CASES:          # the params, drawn once for every thread
        arch, kw, _, _ = CASES[name]
        ref_and_port(arch, "float32", **kw)
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {name: pool.submit(
            _run_mesh, str(tmp_path_factory.mktemp(name)), shape, names)
            for name, (shape, names) in MESHES.items()}
        ref = {name: _reference(name) for name in CASES
               if name not in PLANTED}
        runs = {name: f.result() for name, f in futures.items()}
    return ref, runs


def _check_against_reference(got, want):
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"],
                               rtol=1e-5)
    assert set(got["full"]) == set(want["state"])
    for path, w in want["state"].items():
        np.testing.assert_allclose(to_np(got["full"][path]), w,
                                   err_msg=path, **PARAM_TOL)
    gaps = _nu_gaps(got, want)
    assert max(gaps.values()) <= NU_RTOL, {
        p: g for p, g in gaps.items() if g > NU_RTOL}


def _nu_gaps(got, want) -> dict:
    """{path: ‖got − want‖ / ‖want‖} of each leaf's AdamW second moment —
    (1 − b2)·g² after one step, so each leaf's own gradient held to the
    reference relative to its size, with no absolute floor: a small leaf
    whose gradient is off by a factor shows here though the update,
    which Adam normalises, and the global norm barely move."""
    out = {}
    for path, w in want["state"].items():
        if path.startswith("['opt'].nu"):
            w = w.astype(np.float64)
            d = to_np(got["full"][path]).astype(np.float64) - w
            out[path] = float(np.linalg.norm(d) / max(np.linalg.norm(w),
                                                      1e-300))
    return out


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_every_family_matches_the_reference_unsharded_step(trained, mesh,
                                                           case):
    """Loss, grad norm and every leaf of params, ``mu`` and ``nu`` after
    one step, on every rank of a mesh split along ``model`` (and along
    the data axes on 2 × 2)."""
    ref, runs = trained
    for rank in runs[mesh]:
        _check_against_reference(rank[case][1], ref[case][1])


@pytest.mark.parametrize("case", MESHES["1x4"][1])
def test_a_model_axis_of_4_matches_the_reference(trained, case):
    """``model`` = 4: llama's attention on a rank's one query head
    against the kv head it reads (its 2 kv heads do not divide 4; as
    qwen2-vl's, Jamba's and seamless-gqa's self- and cross-attention),
    olmoe's on one query and one kv head (4 and 4 heads); the MLP, the
    experts and the vocabulary split either way; the Mamba mixer of
    mamba2-1.3b and Jamba on 2 of its 8 heads a rank."""
    ref, runs = trained
    for rank in runs["1x4"]:
        _check_against_reference(rank[case][1], ref[case][1])


def test_a_planted_unsummed_router_gradient_is_caught(trained):
    """The fault of :class:`RouterNotEntered` at ``model`` = 2: the
    forward is unchanged, so the loss is the reference's, but each rank
    updates the replicated router with its partial gradient.  The
    router's second moment is off by far more than ``NU_RTOL``, and the
    check every case passes refuses the step."""
    ref, runs = trained
    want = ref["granite-moe-1b-a400m"][1]
    for rank in runs["1x2"]:
        got = rank["router_unsummed"][1]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        gaps = _nu_gaps(got, want)
        router = [p for p in gaps if p.endswith("['router']")]
        assert router and min(gaps[p] for p in router) > 100 * NU_RTOL, gaps
        with pytest.raises(AssertionError):
            _check_against_reference(got, want)


def test_a_planted_unsummed_kv_gradient_is_caught(trained):
    """The fault of :class:`KvNotEntered` on ``straddle`` at ``model`` =
    2: the forward is unchanged, so the loss is the reference's, but each
    rank updates the whole ``wk`` and ``wv`` with its heads' share of
    their gradient.  The check every case passes refuses the step."""
    ref, runs = trained
    want = ref["straddle"][1]
    for rank in runs["1x2"]:
        got = rank["kv_unsummed"][1]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        with pytest.raises(AssertionError):
            _check_against_reference(got, want)


@pytest.mark.parametrize("case", ["bc_gathered", "stat_partial"])
def test_a_planted_mixer_gradient_fault_is_caught(trained, case):
    """The faults of :class:`BCGatheredAsLeaves` and
    :class:`NormStatNotShared` at ``model`` = 2: the forward is unchanged,
    so the loss is the reference's, but each rank's gradient of ``B`` and
    ``C``, or of the norm's statistic, is its own share where it should
    be the sum over the ranks.  The check every case passes refuses the
    step."""
    ref, runs = trained
    want = ref["mamba2-1.3b"][1]
    for rank in runs["1x2"]:
        got = rank[case][1]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        with pytest.raises(AssertionError):
            _check_against_reference(got, want)


def _mixer_local_shapes(arch: str, tp: int) -> set:
    """A layer's ``in_proj``, ``conv_w`` and ``out_proj`` as a rank of
    ``model`` = tp holds them."""
    cfg = treg.get_config(arch, smoke=True)
    s, d = cfg.ssm, cfg.d_model
    di = s.d_inner(d)
    width = 2 * di + 2 * s.state_dim + s.num_heads(d)
    return {(d, width // tp), (s.conv_kernel, s.conv_dim(d) // tp),
            (di // tp, d)}


def test_the_mixer_computes_its_heads_and_gathers_no_leaf(trained):
    """mamba2-1.3b and Jamba on every mesh, backward included: B4 (and
    under autograd B4′, which takes the same tensors) gets H/tp heads,
    and no leaf of the mixer is gathered along ``model``."""
    _, runs = trained
    for mesh, ((_, tp), names) in MESHES.items():
        for case in ("mamba2-1.3b", "jamba-1.5-large-398b"):
            if case not in names:
                continue
            cfg = treg.get_config(case, smoke=True)
            heads = cfg.ssm.num_heads(cfg.d_model) // tp
            leaves = _mixer_local_shapes(case, tp)
            for rank in runs[mesh]:
                seen = rank[case][1]["seen"]
                assert seen["ssd"] == [heads], (mesh, case)
                assert not leaves & set(seen["gather"]), (mesh, case)


def test_the_kernels_and_the_experts_run_on_a_model_shard(trained):
    """The wrappers' inputs inside the step, backward included: B2 gets
    H/tp query and Hkv/tp kv heads where both divide tp, H/tp query heads
    on the kv heads they read where only the query heads divide it (one
    on one at tp 4; ``straddle``'s 3 on 3 at tp 2, one kv head a query
    head); the experts' ``bmm`` E/tp experts."""
    _, runs = trained
    for mesh, tp, case, heads in (("1x2", 2, "llama3.2-1b", (2, 1)),
                                  ("1x4", 4, "llama3.2-1b", (1, 1)),
                                  ("1x4", 4, "olmoe-1b-7b", (1, 1)),
                                  ("1x4", 4, "jamba-1.5-large-398b", (1, 1)),
                                  ("1x4", 4, "seamless-m4t-medium-gqa",
                                   (1, 1)),
                                  ("1x4", 4, "qwen2-vl-72b", (1, 1)),
                                  ("2x2", 2, "straddle", (3, 3)),
                                  ("2x2", 2, "granite-moe-1b-a400m", (2, 1))):
        for rank in runs[mesh]:
            seen = rank[case][1]["seen"]
            assert seen["attn"] == [heads], (mesh, case)
            if "moe" in case:
                assert seen["experts"] == [8 // tp]


@pytest.mark.parametrize("case", ["llama3.2-1b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium-gqa", "qwen2-vl-72b",
                                  "straddle"])
def test_the_attention_splits_its_query_heads(trained, case):
    """Where only the query heads divide ``model`` (tp 4; ``straddle`` at
    tp 2 on 2 × 2): the step matches the reference's unsharded step, the
    whole ``wk`` / ``wv`` / ``bk`` / ``bv`` — each rank computing only its
    heads' share of their gradient, summed over ``model`` — after the
    step and in both moments, at the tolerances of every leaf (``nu`` in
    relative norm); and no attention leaf, whole or a rank's shard, is
    gathered along ``model``."""
    ref, runs = trained
    mesh = "2x2" if case == "straddle" else "1x4"
    tp = MESHES[mesh][0][1]
    arch, kw = CASES[case][:2]
    cfg = treg.get_config(arch, smoke=True).with_(**kw)
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp
    want = ref[case][1]
    kv = [p for p in want["state"]
          if p.rsplit("[", 1)[-1] in ("'wk']", "'wv']", "'bk']", "'bv']")]
    # each in the params, mu and nu: 2 or, with biases, 4 leaves a layer
    # stack's attention (the encoder–decoder has three such stacks)
    assert len(kv) == 3 * (4 if cfg.qkv_bias else 2) * (
        3 if cfg.family == "encdec" else 1), kv
    d, hd = cfg.d_model, cfg.resolved_head_dim
    leaves = set()
    for heads in (cfg.num_heads, cfg.num_kv_heads):
        for width in (heads * hd, heads * hd // tp):
            leaves |= {(d, width), (width, d), (width,)}
    for rank in runs[mesh]:
        got = rank[case][1]
        for path in kv:
            np.testing.assert_allclose(to_np(got["full"][path]),
                                       want["state"][path], err_msg=path,
                                       **PARAM_TOL)
        gaps = _nu_gaps(got, want)
        assert max(gaps[p] for p in kv if p.startswith("['opt'].nu")) \
            <= NU_RTOL
        assert not leaves & set(got["seen"]["gather"]), (mesh, case)


def test_the_step_never_makes_a_leaf_whole(trained):
    """``DTensor.full_tensor`` is never called inside the step, on any
    mesh or case (the rank gathers only along the data axes, one
    superblock at a time, and never along ``model``)."""
    _, runs = trained
    for mesh, (_, names) in MESHES.items():
        for rank in runs[mesh]:
            for name in names:
                for accum, got in rank[name].items():
                    assert got["full_calls"] == 0, (mesh, name, accum)


def test_padded_vocabulary_columns_on_the_last_rank(trained):
    """250 rows padded to 256 at ``model`` = 2: rank 1 holds columns
    128-255, the padded six among them, masked in global column
    indices; the step matches the reference, and no padded column of
    ``lm_head`` or row of ``embed`` moves (AdamW's weight decay aside,
    which the reference applies alike)."""
    cfg = treg.get_config("llama3.2-1b", smoke=True).with_(
        **CASES["padded"][1])
    assert cfg.vocab_size == 250 and cfg.padded_vocab == 256
    ref, runs = trained
    for rank in runs["1x2"]:
        got = rank["padded"][1]
        _check_against_reference(got, ref["padded"][1])
        mu = to_np(got["full"]["['opt'].mu['lm_head']"])
        assert not mu[:, 250:].any() and mu[:, :250].any()


def test_a_batch_the_data_axis_does_not_divide_replicates(trained):
    """3 rows on a data axis of 2: every rank computes all 3, the
    reduce-scatter sums two identical copies and the step divides by the
    data axis' size — the reference's step on the 3 rows."""
    ref, runs = trained
    for rank in runs["2x2"]:
        got = rank["rows3"][1]
        assert got["rows"]["tokens"] == (3, SEQ)
        _check_against_reference(got, ref["rows3"][1])


def test_grad_accum_on_a_split_mesh_equals_grad_accum_1(trained):
    """On the 2 × 2 mesh ``grad_accum`` 2 (each rank a row of each 2-row
    microbatch, its local shards' gradients accumulated in f32) gives
    ``grad_accum`` 1's step, and the reference's ``grad_accum`` 2 step."""
    ref, runs = trained
    for rank in runs["2x2"]:
        one, two = rank["accum"][1], rank["accum"][2]
        assert two["rows"]["tokens"] == (2, SEQ)
        np.testing.assert_allclose(float(two["loss"]), float(one["loss"]),
                                   rtol=1e-5)
        for path in one["full"]:
            if path.startswith("['params']"):
                np.testing.assert_allclose(
                    to_np(two["full"][path]), to_np(one["full"][path]),
                    err_msg=path, **ACCUM_TOL)
        _check_against_reference(two, ref["accum"][2])


# ---------------------------------------------------------------------------
# the params gathered one superblock at a time
# ---------------------------------------------------------------------------

GATHER_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd, tp
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = make_host_mesh((2, 1), ("data", "model"))
opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
out = {}
for name, case in inp["cases"].items():
    cfg = get_config(case["arch"], smoke=True).with_(dtype="float32",
                                                      remat=case["remat"])
    p_shard = shd.make_param_shardings(mesh, case["params"], cfg)
    opt = adamw.init(case["params"], opt_cfg)
    params = shd.distribute_tree(case["params"], p_shard)
    opt = shd.distribute_tree(opt, shd.make_opt_shardings(mesh, opt, p_shard))
    step = ST.make_sharded_train_step(cfg, opt_cfg, mesh, global_batch=4)
    tp.reset_gathered()
    before = tp.gathered_bytes()["live"]
    step(params, opt, ST.local_batch(mesh, case["batch"]))
    out[name] = dict(tp.gathered_bytes(), before=before)
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _gather_bounds(tree, blocks: str, layers: int) -> tuple:
    """(bytes of one superblock's leaves under ``blocks``, of the largest
    leaf outside them), each leaf whole."""
    def size(t):
        return t.numel() * t.element_size()

    inside = sum(size(v) for k, v in flat(tree) if k.startswith(blocks))
    return inside // layers, max(size(v) for k, v in flat(tree)
                                 if not k.startswith(blocks))


def test_a_rank_holds_one_superblock_gathered_at_a_time(tmp_path):
    """On a (2, 1) mesh every rank holds half of each leaf the rules
    shard along ``data``.  Under remat (every config's default) the
    largest number of gathered bytes alive at once (``tp.gathered_bytes``,
    counted until autograd or the layer frees each gathered leaf) is at
    most one superblock's leaves plus the largest leaf outside the
    blocks, and at least one superblock's leaves the rules shard; the
    hybrid's 8-layer superblock alike.  Without remat autograd keeps every
    superblock's gathered leaves for the backward: the peak then passes
    that bound."""
    cases = {}
    for name, arch, remat in (("llama", "llama3.2-1b", True),
                              ("jamba", "jamba-1.5-large-398b", True),
                              ("llama_no_remat", "llama3.2-1b", False)):
        _, tcfg, _, _, tp = ref_and_port(arch, "float32")
        b = JP.lm_batch(JP.DataConfig(seed=3, vocab_size=tcfg.vocab_size,
                                      seq_len=SEQ, global_batch=4), 0)
        cases[name] = {"arch": arch, "remat": remat, "params": tp,
                       "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in b.items()}}
    torch.save({"cases": cases}, os.path.join(tmp_path, "inputs.pt"))
    run_ranks(GATHER_RANK, 2, tmp_path)
    for r in range(2):
        got = load_rank(tmp_path, r)
        for name, case in cases.items():
            cfg = treg.get_config(case["arch"], smoke=True)
            one, outside = _gather_bounds(case["params"], "blocks/",
                                          tlm.num_superblocks(cfg))
            peak = got[name]["peak"] - got[name]["before"]
            assert got[name]["live"] == got[name]["before"], name
            if case["remat"]:
                assert one // 2 < peak <= one + outside, (name, peak, one,
                                                          outside)
            else:
                assert peak > one + outside, (name, peak, one, outside)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_combine_softmax_refuses_a_gradient():
    """``tp.combine_softmax`` combines a decode step's blocks of positions
    and has no backward: under autograd it raises before any collective,
    rather than give a wrong gradient."""
    from repro_torch.distributed import ctx as tctx
    from repro_torch.distributed import tp as ttp

    split = tctx.ModelSplit(None, 0, 2)
    m = torch.zeros(2, 3, requires_grad=True)
    l, o = torch.ones(2, 3), torch.ones(2, 3, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        ttp.combine_softmax(m, l, o, split)
    with pytest.raises(RuntimeError, match="no backward"):
        ttp.combine_softmax(m.detach(), l, o.requires_grad_(True), split)


COLLECTIVES_RANK = """
from repro_torch.distributed import ctx, tp

group = dist.new_group([0, 1])
split = ctx.ModelSplit(group, RANK, 2)
gen = torch.Generator().manual_seed(RANK)
x = torch.randn(3, 4, generator=gen, requires_grad=True)
w = torch.randn(4, 6, generator=gen)
out = {}
# enter: identity; the backward sums the ranks' partial gradients
y = tp.enter(x, split)
(y @ w).sum().backward()
out["enter"] = (y.detach().clone(), x.grad.clone(), (w.sum(1)).expand(3, 4))
x.grad = None
# sum_partial: the sum; the backward passes the gradient on
s = tp.sum_partial(x * (RANK + 1), split)
(s * 2).sum().backward()
out["sum_partial"] = (s.detach().clone(), x.grad.clone())
x.grad = None
# gather: the whole; the backward keeps this rank's block
g = tp.gather(x, 1, split)
(g * torch.arange(8.0)).sum().backward()
out["gather"] = (g.detach().clone(), x.grad.clone())
x.grad = None
# the data-axes gather: the whole; the backward reduce-scatters
plan = ctx.ParamGather(group, 2, {("w",): 0})
with ctx.gathering_params(plan):
    d = tp.gather_data(x, ("w",))
(d * (RANK + 1)).sum().backward()
out["data"] = (d.detach().clone(), x.grad.clone())
out["x"] = x.detach().clone()
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def test_the_collectives_and_their_gradients_on_two_ranks(tmp_path):
    """Each collective's forward and backward on two gloo ranks, against
    what the two ranks' inputs give when put together by hand."""
    run_ranks(COLLECTIVES_RANK, 2, tmp_path)
    r = [load_rank(tmp_path, i) for i in range(2)]
    xs = [ri["x"] for ri in r]
    for i, ri in enumerate(r):
        y, gx, want = ri["enter"]
        assert torch.equal(y, xs[i])
        torch.testing.assert_close(gx, r[0]["enter"][2] + r[1]["enter"][2])
        s, gx = ri["sum_partial"]
        torch.testing.assert_close(s, xs[0] + 2 * xs[1])
        assert torch.equal(gx, torch.full_like(gx, 2.0 * (i + 1)))
        g, gx = ri["gather"]
        assert torch.equal(g, torch.cat(xs, 1))
        assert torch.equal(gx, torch.arange(8.0)[4 * i:4 * i + 4].expand(3, 4))
        d, gx = ri["data"]
        assert torch.equal(d, torch.cat(xs, 0))
        assert torch.equal(gx, torch.full_like(gx, 3.0))


# ---------------------------------------------------------------------------
# the (1, 2) tensor-parallel run of chip_smoke's mesh_train
# ---------------------------------------------------------------------------

TWO_CARD_TP_PHASE = """
sys.path.insert(0, {repo!r})
import chip_smoke
res = chip_smoke.two_card_run(torch, chip_smoke.MESH_TRAIN_TWO_CARD_SMOKE,
                              shape=(1, 2), arch={arch!r}, smoke=True,
                              device="cpu", out_dir=OUT)
torch.save(res, f"{{OUT}}/rank0.pt")
"""


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_the_two_card_tp_phase_runs_on_two_gloo_ranks(tmp_path, arch):
    """``chip_smoke.two_card_run`` at ``shape=(1, 2)``, which the card
    machine runs only with two cards, on the CPU: its rank script under
    ``torchrun`` as a (1, 2) gloo mesh — every rank all the rows, half of
    each split (mamba2-1.3b's mixer half its heads) — held to the 1 × 1
    mesh on the same global batch at the bf16 train rule."""
    assert chip_smoke.two_card_rows(4, (1, 2)) == [(0, 4)]
    run_ranks(TWO_CARD_TP_PHASE.format(repo=REPO, arch=arch), 0, tmp_path)
    got = load_rank(tmp_path, 0)
    assert len(got["losses_1x2"]) == len(got["losses_1x1"]) == 2
    assert all(np.isfinite(got["losses_1x2"]))
    assert got["loss_rel_gap"] <= got["rule_rtol"]


#: chip_smoke's split-step check, the card's code, on the CPU at the
#: smoke configs
SPLIT_STEP_PHASE = """
sys.path.insert(0, {repo!r})
import chip_smoke
from repro_torch.launch.mesh import single_device_mesh
mesh = single_device_mesh("cpu")
res = [chip_smoke.mesh_split_step(torch, arch, kw, mesh, smoke=True,
                                  device="cpu", rows=2, seq=32)
       for arch, kw in chip_smoke.MESH_SPLIT_CONFIGS]
torch.save(res, f"{{OUT}}/rank0.pt")
"""


def test_the_split_step_phase_gives_mesh_none_bits_on_a_1x1_cpu_mesh(
        tmp_path):
    """``chip_smoke.mesh_split_step`` for each of its four configs, at
    their smoke sizes in bf16 on the CPU's 1 × 1 mesh: two split steps
    give ``mesh=None``'s losses, params and moments bit for bit (the
    function raises otherwise)."""
    run_ranks(SPLIT_STEP_PHASE.format(repo=REPO), 0, tmp_path)
    got = load_rank(tmp_path, 0)
    assert [r["arch"] for r in got] == [
        a for a, _ in chip_smoke.MESH_SPLIT_CONFIGS]
    for row in got:
        assert row["mesh_equals_none_bit_for_bit"]
        assert len(row["losses"]) == chip_smoke.MESH_SPLIT_STEPS
        assert all(np.isfinite(row["losses"]))
