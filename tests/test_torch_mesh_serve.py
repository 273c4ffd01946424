"""Serving on a device mesh (``ServeEngine(mesh=...)``,
``steps.make_prefill_step`` / ``make_decode_step`` on a mesh, the
tensor-parallel layers of ``distributed/tp.py``) on CPU gloo meshes of
spawned ranks (``_torch_ranks.run_ranks``), at the smoke configs.

The meshes are (1, 2), (1, 4), (2, 1) and (2, 2) over ``("data",
"model")``.  The attention computes by ``layers.head_case``.  The smoke
configs have 4 query and 2 kv heads: at ``model`` = 2 each rank computes
its query and kv heads (``HEADS``); at ``model`` = 4 only the query
heads divide it (``QUERY``), so each rank computes its one query head
against the kv head it reads, projected from the whole ``wk`` / ``wv``,
and a decode step attends over a cache whose positions lie in blocks
along ``model`` (``make_cache_shardings``' fallback) with every rank's
queries gathered, keeping its own head's result.  ``straddle`` has 6
query and 3 kv heads: at ``model`` = 2 a rank's 3 query heads read 2
kv heads, one kv head a query head (``tp.kv_heads_read``'s ratio 1); at
``model`` = 4 neither count divides it and every rank computes every
head (``WHOLE``).  No attention leaf is gathered along ``model``.

The reference's own mesh server fails on this jax
(``test_serve.py::TestGenerate``, ROADMAP §C), so every mesh run is held
to the port's one-device engine on the same parameters and to the
reference's **unsharded** prefill and decode (greedy, its caches laid
out as its ``ServeEngine._expand_cache`` does), in f32: greedy tokens
equal, logits and every cache leaf at ``test_torch_lm_serve.py``'s
``F32_TOL`` (the row-parallel sums are added in another order).  On a
1 × 1 mesh every collective is the identity: tokens, logits and caches
are ``mesh=None``'s bits, in bf16 and with int8 weights.  Gloo takes
bf16 in ``all_reduce`` and ``all_gather``; the partial sums are reduced
in f32 all the same, so that each output is rounded once, as one
device's product is."""
import functools
import inspect
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch import steps as JS

from repro_torch.configs import registry as treg
from repro_torch.distributed import ctx as tctx
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve

from _torch_port import F32_TOL, REPO, ref_and_port, to_np, tokens
from _torch_ranks import load_rank, run_ranks

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x1": (2, 1), "2x2": (2, 2)}
ROWS, PROMPT, NEW, MAX_LEN = 2, 16, 8, 24
FRAMES = 16
#: case → (arch, config overrides, max_len).  ``max26``: a cache of 26
#: positions, which ``model`` = 4 does not divide — the cache replicates
#: along ``model`` and every rank attends over every position.  ``gqa``:
#: seamless with 2 kv heads, so that its cross-attention memory too lies
#: in blocks of positions at ``model`` = 4 (``QUERY``).  ``straddle``: 6
#: query and 3 kv heads (``head_dim`` 16), a rank's query heads on two kv
#: heads at ``model`` = 2.
CASES = {
    "llama3.2-1b": ("llama3.2-1b", {}, MAX_LEN),
    "llama3.2-1b-streamed": ("llama3.2-1b", {"mlp_impl": "streamed"},
                             MAX_LEN),
    "llama3.2-1b-max26": ("llama3.2-1b", {}, 26),
    "qwen2-0.5b": ("qwen2-0.5b", {}, MAX_LEN),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, MAX_LEN),
    "mamba2-1.3b": ("mamba2-1.3b", {}, MAX_LEN),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}, MAX_LEN),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, MAX_LEN),
    "seamless-m4t-medium-gqa": ("seamless-m4t-medium", {"num_kv_heads": 2},
                                MAX_LEN),
    "straddle": ("llama3.2-1b", {"num_heads": 6, "num_kv_heads": 3,
                                 "head_dim": 16}, MAX_LEN),
}
#: the VLM's prefill and decode steps on embeddings and M-RoPE positions
#: (``ServeEngine.generate`` refuses an ``embeds_input`` config)
VLM = "qwen2-vl-72b"


def trace(eng, inputs, new):
    """Prefill ``inputs`` (prompts, or the encoder–decoder's frames) on
    ``eng``, lay out the decode cache, take ``new - 1`` greedy decode
    steps → {"logits" (new, B, V), "tokens" (B, new), "cache" {path: the
    whole leaf, in the reference's column order}}."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import place_token
    from repro_torch.tree import tree_flatten_with_path

    frames = eng.cfg.family == "encdec"
    x = torch.as_tensor(inputs, device=eng.device)
    plen = 1 if frames else x.shape[1]
    with torch.inference_mode():
        logits, caches = eng._prefill_step(
            eng.model_params(), {"frames" if frames else "tokens": x})
        cache = eng._expand_cache(caches, x.shape[0], plen)
        every = [logits]
        for i in range(1, new):
            tok = logits.argmax(-1).to(torch.int32)
            logits, cache = eng._decode_step(eng.model_params(), cache,
                                             place_token(eng.mesh, tok),
                                             plen + i - 1)
            every.append(logits)
    logits = torch.stack(every)
    if eng.mesh is not None:
        cache = shd.whole_tree(cache, shd.make_cache_shardings(
            eng.mesh, cache, eng.cfg))
    whole = dict(tree_flatten_with_path(cache))
    return {"logits": logits, "cache": whole,
            "tokens": logits.argmax(-1).T.to(torch.int32).numpy()}


#: one mesh's runs on a rank: every case of ``inputs.pt`` traced and
#: generated (greedy, and sampled at temperature 1), the kernels'
#: inputs recorded, and on (1, 2) the int8 engine
SERVE_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServeEngine

from repro_torch.kernels import ref

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = make_host_mesh(inp["shape"], ("data", "model"))
from repro_torch.distributed import tp

seen = {"attn": [], "mlp": [], "experts": [], "ssd": [], "ssd_plain": [],
        "gather": []}
real = (ops.flash_attention, ops.fused_mlp, torch.bmm, ops.mamba2_ssd,
        ref.ssd_chunked, tp.gather)

def attn(q, k, v, **kw):
    seen["attn"].append((q.shape[1], k.shape[1]))
    return real[0](q, k, v, **kw)

def mlp(x, wg, wu, wd, **kw):
    seen["mlp"].append(wu.shape[-1])
    return real[1](x, wg, wu, wd, **kw)

def bmm(a, b):
    seen["experts"].append(b.shape[0])
    return real[2](a, b)

def ssd(x, *a, **kw):
    seen["ssd"].append(x.shape[2])
    return real[3](x, *a, **kw)

def ssd_plain(x, *a, **kw):
    seen["ssd_plain"].append(x.shape[2])
    return real[4](x, *a, **kw)

def gather(t, dim, split):
    if split is not None:
        seen["gather"].append(tuple(t.shape))
    return real[5](t, dim, split)

ops.flash_attention, ops.fused_mlp, torch.bmm = attn, mlp, bmm
ops.mamba2_ssd, ref.ssd_chunked, tp.gather = ssd, ssd_plain, gather
out = {"coord": mesh.coordinate()}
for name, case in inp["cases"].items():
    cfg = get_config(case["arch"], smoke=True).with_(dtype="float32",
                                                      **case["kw"])
    for v in seen.values():
        v.clear()
    eng = ServeEngine(cfg, device="cpu", mesh=mesh, max_len=case["max_len"],
                      params=case["params"])
    res = trace(eng, case["inputs"], inp["new"])
    res["seen"] = {k: sorted(set(v)) for k, v in seen.items()}
    if cfg.family != "encdec":
        res["generate"] = eng.generate(case["inputs"], max_new=inp["new"])[0]
        res["sampled"] = eng.generate(case["inputs"], max_new=inp["new"],
                                      temperature=1.0, seed=3)[0]
    if inp["int8"] and name == "llama3.2-1b":
        q8 = ServeEngine(cfg, device="cpu", mesh=mesh, int8_weights=True,
                         max_len=case["max_len"], params=case["params"])
        for v in seen.values():
            v.clear()
        res["int8"] = trace(q8, case["inputs"], inp["new"])
        res["int8"]["seen"] = {k: sorted(set(v)) for k, v in seen.items()}
    out[name] = res
vlm = inp["vlm"]
cfg = get_config(VLM, smoke=True).with_(dtype="float32")
eng = ServeEngine(cfg, device="cpu", mesh=mesh, max_len=MAX_LEN,
                  params=vlm["params"])
for v in seen.values():
    v.clear()
out[VLM] = vlm_trace(eng, vlm["embeds"], vlm["mrope_positions"],
                     vlm["steps"])
out[VLM]["seen"] = {k: sorted(set(v)) for k, v in seen.items()}
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def vlm_trace(eng, embeds, mrope_positions, steps):
    """The VLM's prefill on ``embeds`` (B, P, D) and ``mrope_positions``
    (3, B, P), its caches laid out for decode, and a decode step for each
    of ``steps`` (n, B, 1, D) → {"logits" (1 + n, B, V)}."""
    import torch

    from repro_torch.launch.steps import place_token

    plen = embeds.shape[1]
    with torch.inference_mode():
        logits, caches = eng._prefill_step(eng.model_params(), {
            "embeds": torch.as_tensor(embeds),
            "mrope_positions": torch.as_tensor(mrope_positions)})
        cache = eng._expand_cache(caches, embeds.shape[0], plen)
        every = [logits]
        for i, emb in enumerate(steps):
            logits, cache = eng._decode_step(
                eng.model_params(), cache,
                place_token(eng.mesh, torch.as_tensor(emb)), plen + i)
            every.append(logits)
    return {"logits": torch.stack(every)}


def _inputs(case: str):
    arch, kw, _ = CASES[case]
    if arch == "seamless-m4t-medium":
        return np.random.default_rng(5).standard_normal(
            (ROWS, FRAMES, 64)).astype(np.float32)
    return tokens(9, ROWS, PROMPT)


@functools.lru_cache(maxsize=None)
def _ref_steps(jcfg):
    return (jax.jit(JS.model_prefill, static_argnums=1),
            jax.jit(JS.model_decode, static_argnums=1))


def _reference_greedy(jcfg, jp, inputs, new, max_len):
    """The reference's unsharded prefill and ``new - 1`` greedy decode
    steps, each cache leaf zero-padded to the decode cache's shape (its
    ``ServeEngine._expand_cache``) → (B, new) tokens."""
    prefill, decode = _ref_steps(jcfg)
    frames = jcfg.family == "encdec"
    plen = 1 if frames else inputs.shape[1]
    logits, caches = prefill(
        jp, jcfg, {"frames" if frames else "tokens": jnp.asarray(inputs)})
    shapes = jax.eval_shape(
        lambda: JS.model_init_cache(jcfg, inputs.shape[0], max_len))
    cache = jax.tree.map(
        lambda c, s: jnp.pad(c, [(0, a - b) for a, b in zip(s.shape,
                                                            c.shape)]),
        caches, shapes)
    out = np.zeros((inputs.shape[0], new), np.int32)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out[:, 0] = np.asarray(tok)
    for i in range(1, new):
        logits, cache = decode(jp, jcfg, cache, tok,
                               jnp.asarray(plen + i - 1, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[:, i] = np.asarray(tok)
    return out


def _vlm_inputs():
    """The VLM's prompt embeddings, M-RoPE positions and decode-step
    embeddings (NumPy, seeded)."""
    rng = np.random.default_rng(7)
    return {"embeds": rng.standard_normal((ROWS, PROMPT, 64)).astype(
                np.float32),
            "mrope_positions": rng.integers(0, PROMPT, (3, ROWS, PROMPT))
            .astype(np.int32),
            "steps": rng.standard_normal((NEW - 1, ROWS, 1, 64)).astype(
                np.float32)}


def _reference_vlm(jcfg, jp, inp):
    """The reference's unsharded ``lm_prefill`` and ``lm_decode`` on the
    VLM's inputs, its caches zero-padded to ``MAX_LEN`` positions →
    (1 + n, B, V) logits."""
    from repro.models import lm as jlm

    prefill, decode = (jax.jit(jlm.lm_prefill, static_argnums=1),
                       jax.jit(jlm.lm_decode, static_argnums=1))
    logits, caches = prefill(jp, jcfg, {
        "embeds": jnp.asarray(inp["embeds"]),
        "mrope_positions": jnp.asarray(inp["mrope_positions"])})
    shapes = jax.eval_shape(
        lambda: JS.model_init_cache(jcfg, ROWS, MAX_LEN))
    cache = jax.tree.map(
        lambda c, s: jnp.pad(c, [(0, a - b) for a, b in zip(s.shape,
                                                            c.shape)]),
        caches, shapes)
    every = [np.asarray(logits)]
    for i, emb in enumerate(inp["steps"]):
        logits, cache = decode(jp, jcfg, cache, jnp.asarray(emb),
                               jnp.asarray(PROMPT + i, jnp.int32))
        every.append(np.asarray(logits))
    return np.stack(every)


def _run_mesh(tmp, shape, cases, vlm):
    torch.save({"shape": shape, "cases": cases, "new": NEW,
                "int8": shape in ((1, 2), (1, 4)), "vlm": vlm},
               os.path.join(tmp, "inputs.pt"))
    world = shape[0] * shape[1]
    run_ranks(f"VLM, MAX_LEN = {VLM!r}, {MAX_LEN}\n"
              + inspect.getsource(trace) + inspect.getsource(vlm_trace)
              + SERVE_RANK, world, tmp)
    return [load_rank(tmp, r) for r in range(world)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case on every mesh (the meshes at once), beside the port's
    one-device engine and the reference's unsharded greedy tokens."""
    cases = {}
    for name, (arch, kw, max_len) in CASES.items():
        _, _, _, _, tp = ref_and_port(arch, "float32", **kw)
        cases[name] = {"arch": arch, "kw": kw, "max_len": max_len,
                       "params": tp, "inputs": _inputs(name)}
    jvlm, tvlm, jp_vlm, _, tp_vlm = ref_and_port(VLM, "float32")
    vlm = dict(_vlm_inputs(), params=tp_vlm)
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {name: pool.submit(
            _run_mesh, str(tmp_path_factory.mktemp(name)), shape, cases, vlm)
            for name, shape in MESHES.items()}
        one, ref = {}, {}
        for name, (arch, kw, max_len) in CASES.items():
            jcfg, tcfg, jp, _, tp = ref_and_port(arch, "float32", **kw)
            eng = tserve.ServeEngine(tcfg, device="cpu", max_len=max_len,
                                     params=tp)
            one[name] = trace(eng, cases[name]["inputs"], NEW)
            if tcfg.family != "encdec":
                one[name]["sampled"] = eng.generate(
                    cases[name]["inputs"], max_new=NEW, temperature=1.0,
                    seed=3)[0]
            ref[name] = _reference_greedy(jcfg, jp, cases[name]["inputs"],
                                          NEW, max_len)
        llama = ref_and_port("llama3.2-1b", "float32")[1]
        q8 = tserve.ServeEngine(llama, device="cpu", max_len=MAX_LEN,
                                int8_weights=True,
                                params=cases["llama3.2-1b"]["params"])
        one["int8"] = trace(q8, cases["llama3.2-1b"]["inputs"], NEW)
        one[VLM] = vlm_trace(tserve.ServeEngine(tvlm, device="cpu",
                                                max_len=MAX_LEN,
                                                params=tp_vlm),
                             vlm["embeds"], vlm["mrope_positions"],
                             vlm["steps"])
        ref[VLM] = _reference_vlm(jvlm, jp_vlm, vlm)
        runs = {name: f.result() for name, f in futures.items()}
    return one, ref, runs


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_mesh_serves_the_one_device_and_the_reference_tokens(served, mesh,
                                                                case):
    """Greedy tokens (the traced steps' and ``generate``'s) equal to the
    one-device engine's and to the reference's unsharded greedy, on every
    rank; logits and every cache leaf, gathered whole, at ``F32_TOL``."""
    one, ref, runs = served
    want = one[case]
    np.testing.assert_array_equal(want["tokens"], ref[case])
    for rank in runs[mesh]:
        got = rank[case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        if "generate" in got:
            np.testing.assert_array_equal(got["generate"], want["tokens"])
        assert got["logits"].shape == want["logits"].shape
        np.testing.assert_allclose(to_np(got["logits"]),
                                   to_np(want["logits"]), **F32_TOL)
        assert set(got["cache"]) == set(want["cache"])
        for path, leaf in want["cache"].items():
            assert got["cache"][path].shape == leaf.shape, path
            np.testing.assert_allclose(to_np(got["cache"][path]),
                                       to_np(leaf), err_msg=path, **F32_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_the_kernels_and_the_experts_run_on_a_model_shard(served, mesh):
    """The wrappers' inputs on a rank of ``model`` = tp: B2 gets H/tp
    query and Hkv/tp kv heads where both divide tp (4/2 heads at tp 2),
    H/tp query heads on the kv head they read where only the query heads
    divide it (tp 4: one on one); B3 gets ``d_ff``/tp columns; the
    experts' ``bmm`` E/tp experts; B4 and its plain version (the CPU's)
    the Mamba mixer's H/tp heads, in mamba2-1.3b's prefill and in
    Jamba's."""
    _, _, runs = served
    tp = MESHES[mesh][1]
    heads = [(4 // tp, 2 // tp)] if tp == 2 else [(1, 1)]
    for rank in runs[mesh]:
        for case in ("mamba2-1.3b", "jamba-1.5-large-398b"):
            cfg = treg.get_config(case, smoke=True)
            want = [cfg.ssm.num_heads(cfg.d_model) // tp]
            seen = rank[case]["seen"]
            assert seen["ssd"] == seen["ssd_plain"] == want, case
        streamed = rank["llama3.2-1b-streamed"]["seen"]
        assert streamed["attn"] == heads
        assert streamed["mlp"] == [128 // tp]
        moe = rank["granite-moe-1b-a400m"]["seen"]
        assert moe["experts"] == [8 // tp]
        assert moe["attn"] == heads


def _b2_heads(cfg, tp: int) -> tuple:
    """(query heads, kv heads) that B2 gets on a rank of ``model`` = tp:
    H/tp and Hkv/tp where both divide tp; where only H does, H/tp query
    heads on the kv heads they read — one where they lie in one kv head,
    H/tp/G where they cover whole groups of G = H/Hkv, else one a query
    head; every head where neither divides tp."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if hkv % tp == 0:
        return h // tp, hkv // tp
    if h % tp:
        return h, hkv
    n, g = h // tp, h // hkv
    return n, (1 if g % n == 0 else n // g if n % g == 0 else n)


def _attention_leaf_shapes(cfg, tp: int) -> set:
    """A layer's attention leaves, whole and as a rank of ``model`` = tp
    holds them (its query or kv heads' columns)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = set()
    for heads in (cfg.num_heads, cfg.num_kv_heads):
        for width in {heads * hd, heads * hd // tp}:
            out |= {(d, width), (width, d), (width,)}
    return out


#: every case that attends, and the VLM
ATTENDING = [c for c in CASES if CASES[c][0] != "mamba2-1.3b"] + [VLM]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_attention_computes_its_heads_and_gathers_no_leaf(served, mesh):
    """Every case that attends, the VLM's too: B2 gets the heads of
    :func:`_b2_heads` (in serving the encoder–decoder's B2 is its
    encoder's), and ``tp.gather`` joins no attention leaf along
    ``model`` — with int8 weights on (1, 2) and (1, 4) neither."""
    _, _, runs = served
    tp = MESHES[mesh][1]
    for rank in runs[mesh]:
        for case in ATTENDING:
            arch, kw = (VLM, {}) if case == VLM else CASES[case][:2]
            cfg = treg.get_config(arch, smoke=True).with_(**kw)
            seen = rank[case]["seen"]
            assert seen["attn"] == [_b2_heads(cfg, tp)], (mesh, case)
            leaves = _attention_leaf_shapes(cfg, tp)
            assert not leaves & set(seen["gather"]), (mesh, case)
        if "int8" in rank["llama3.2-1b"]:
            seen = rank["llama3.2-1b"]["int8"]["seen"]
            cfg = treg.get_config("llama3.2-1b", smoke=True)
            assert not _attention_leaf_shapes(cfg, tp) & set(seen["gather"])
    assert [_b2_heads(treg.get_config("llama3.2-1b", smoke=True).with_(
        **CASES["straddle"][1]), t) for t in (2, 4)] == [(3, 3), (6, 3)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_vlm_serves_the_reference_logits_on_a_mesh(served, mesh):
    """qwen2-vl's smoke config (4 query and 2 kv heads, M-RoPE) on
    embeddings: the prefill's and every decode step's logits on every
    rank at ``F32_TOL`` of the reference's unsharded ``lm_prefill`` and
    ``lm_decode`` and of the one-device engine's."""
    one, ref, runs = served
    np.testing.assert_allclose(to_np(one[VLM]["logits"]), ref[VLM],
                               **F32_TOL)
    for rank in runs[mesh]:
        got = to_np(rank[VLM]["logits"])
        assert got.shape == ref[VLM].shape
        np.testing.assert_allclose(got, ref[VLM], **F32_TOL)
        np.testing.assert_allclose(got, to_np(one[VLM]["logits"]),
                                   **F32_TOL)


def test_int8_weights_on_a_model_axis_of_4_serve_the_one_device_tokens(
        served):
    """On (1, 4), where llama's query heads split and its kv heads do
    not: the int8 ``wq`` and ``wo`` shards dequantized after the data
    axes' gather, ``wk`` and ``wv`` whole; tokens, logits and every cache
    leaf against the one-device int8 engine."""
    one, _, runs = served
    want = one["int8"]
    for rank in runs["1x4"]:
        got = rank["llama3.2-1b"]["int8"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(to_np(got["logits"]),
                                   to_np(want["logits"]), **F32_TOL)
        for path, leaf in want["cache"].items():
            np.testing.assert_allclose(to_np(got["cache"][path]),
                                       to_np(leaf), err_msg=path, **F32_TOL)


def test_int8_weights_on_a_mesh_serve_the_one_device_int8_tokens(served):
    """On (1, 2) the int8 engine — leaves and scales placed by
    ``quantized_param_shardings``, each call dequantizing a superblock's
    shards right after their gather — against the one-device int8
    engine on the same weights."""
    one, _, runs = served
    want = one["int8"]
    for rank in runs["1x2"]:
        got = rank["llama3.2-1b"]["int8"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(to_np(got["logits"]),
                                   to_np(want["logits"]), **F32_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seeded_sampling_on_a_mesh_draws_the_one_device_tokens(served, mesh):
    one, _, runs = served
    for rank in runs[mesh]:
        for case in ("llama3.2-1b", "granite-moe-1b-a400m"):
            np.testing.assert_array_equal(rank[case]["sampled"],
                                          one[case]["sampled"])
            assert not np.array_equal(rank[case]["sampled"],
                                      rank[case]["generate"])


#: the 1 × 1 gloo mesh of one process beside ``mesh=None``, in bf16 and
#: with int8 weights: every output's bits
ONE_BY_ONE_RANK = """
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.serve import ServeEngine

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = single_device_mesh("cpu")
out = {}
for name, (arch, kw, int8, inputs) in inp.items():
    cfg = get_config(arch, smoke=True).with_(**kw)
    runs = [trace(ServeEngine(cfg, device="cpu", mesh=m, max_len=24, seed=1,
                              int8_weights=int8), inputs, 6)
            for m in (None, mesh)]
    out[name] = {"same": [torch.equal(runs[0]["logits"], runs[1]["logits"]),
                          np.array_equal(runs[0]["tokens"],
                                         runs[1]["tokens"]),
                          all(torch.equal(v, runs[1]["cache"][k])
                              and v.dtype == runs[1]["cache"][k].dtype
                              for k, v in runs[0]["cache"].items())],
                 "dtype": str(runs[1]["logits"].dtype)}
torch.save(out, f"{OUT}/rank0.pt")
"""


def test_a_1x1_mesh_gives_the_one_device_bits(tmp_path):
    """bf16 smoke configs of every family, and llama's int8 weights, on
    the 1 × 1 mesh: logits, tokens and every cache leaf equal
    ``mesh=None``'s bit for bit."""
    inp = {name: (arch, kw, False, _inputs(name))
           for name, (arch, kw, _) in CASES.items()
           if name not in ("llama3.2-1b-max26", "seamless-m4t-medium-gqa",
                           "straddle")}
    inp["llama3.2-1b-int8"] = ("llama3.2-1b", {}, True,
                               _inputs("llama3.2-1b"))
    torch.save(inp, os.path.join(tmp_path, "inputs.pt"))
    run_ranks(inspect.getsource(trace) + "import numpy as np\n"
              + ONE_BY_ONE_RANK, 0, tmp_path)
    got = load_rank(tmp_path, 0)
    assert set(got) == set(inp)
    for name, res in got.items():
        assert res["same"] == [True, True, True], name
        assert res["dtype"] == "torch.float32", name


def test_a_mesh_without_ranks_raises():
    """As ``make_sharded_train_step`` and ``train(mesh=...)`` do: a mesh
    that is its shape alone has no process group to serve on."""
    cfg = treg.get_config("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="no ranks"):
        tserve.ServeEngine(cfg, device="cpu", max_len=24,
                           mesh=tmesh.Mesh((1, 2), ("data", "model")))


def test_the_activation_hook_checks_the_widths_of_a_model_split():
    """Given the config, the hook checks that ``hidden`` holds the whole
    ``d_model`` and ``logits`` this rank's vocabulary shard — the whole
    vocabulary with no ``ModelSplit`` installed, or where it does not
    divide the split — on top of the row counts."""
    cfg = treg.get_config("llama3.2-1b", smoke=True)
    hook = tshd.activation_hook(tmesh.Mesh((1, 2), ("data", "model")), cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    h, full, half = (torch.zeros(2, 3, d), torch.zeros(2, v),
                     torch.zeros(2, v // 2))
    assert hook(h, "hidden") is h and hook(full, "logits") is full
    with pytest.raises(ValueError, match="columns"):
        hook(half, "logits")
    with tctx.model_shards(tctx.ModelSplit(None, 1, 2)):
        assert hook(h, "hidden") is h and hook(half, "logits") is half
        with pytest.raises(ValueError, match=f"{v} columns"):
            hook(full, "logits")
        with pytest.raises(ValueError, match="columns"):
            hook(torch.zeros(2, 3, d // 2), "hidden")
        with tctx.data_rows(tctx.RowSplit(None, 0, 2, 1)), \
                pytest.raises(ValueError, match="2 rows"):
            hook(half, "logits")
    with tctx.model_shards(tctx.ModelSplit(None, 0, 3)):
        assert hook(full, "logits") is full          # 256 rows: no split
    assert hook(torch.zeros(2, 5), "kv_cache").shape == (2, 5)


#: the (1, 2) tensor-parallel serve of chip_smoke's ``mesh_serve``, run
#: here on two gloo ranks
TWO_CARD_SERVE = """
sys.path.insert(0, {repo!r})
import chip_smoke
res = chip_smoke.mesh_serve_two_card(torch, arch={arch!r}, smoke=True,
                                     device="cpu", dtype="float32",
                                     batch=2, prompt=16, new=8, out_dir=OUT)
torch.save(res, f"{{OUT}}/rank0.pt")
"""


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_the_two_card_serve_runs_on_two_gloo_ranks(tmp_path, arch):
    """``chip_smoke.mesh_serve_two_card``, which the card machine runs
    only with two cards: its rank script under ``torchrun`` as a (1, 2)
    gloo mesh (mamba2-1.3b's mixer on half its heads a rank), held to the
    one-device engine's tokens and prefill logits."""
    run_ranks(TWO_CARD_SERVE.format(repo=REPO, arch=arch), 0, tmp_path)
    got = load_rank(tmp_path, 0)
    assert got["tokens_equal"] is True
    assert len(got["tokens_1x2"]) == 2 and len(got["tokens_1x2"][0]) == 8
    assert got["logits_max_abs_gap"] <= got["rule"]["allowed"]
