"""The mesh server's params gathered along the data axes one superblock
at a time (``steps.make_prefill_step`` / ``make_decode_step`` on a mesh
install a ``ctx.ParamGather``; the model gathers each superblock's
leaves when it runs through ``tp.gather_data``), on CPU gloo meshes of
spawned ranks (``_torch_ranks.run_ranks``), at the smoke configs in f32.

A gather is exact, so the steps are held bit for bit (``torch.equal``)
to the same steps computed on params made whole along the data axes at
once by ``DTensor.redistribute`` — the mechanism the server had before,
kept here only as the oracle — at (1, 2), (2, 1) and (2, 2) over
``("data", "model")``: the logits of a prefill and of each decode step,
the prefill's tight caches and the decode cache after the steps, each
rank's own.  The families: llama3.2-1b (dense; also with int8 weights,
each superblock's ``q`` and ``scale`` gathered in its one collective and
dequantized right after), olmoe-1b-7b (MoE), mamba2-1.3b (its mixer
split by heads at ``model`` = 2), the Jamba hybrid (an 8-layer
superblock) and seamless-m4t-medium (encoder–decoder, a layer its
"superblock").  The greedy tokens equal the reference's unsharded
greedy (its own mesh server fails on this jax, ROADMAP §C).

On (2, 1), where every rank holds half of each leaf the rules shard
along ``data``, ``tp.gathered_bytes()`` bounds what a rank holds: the
peak of a prefill and of each of five decode steps in a row, with gc
off, is at most one superblock's leaves plus the largest leaf outside
the blocks, and at least one superblock's leaves that the rules shard;
after each call the live bytes are back where they were, once gloo's
worker thread has let go of the call's last gathered buffer, which it
drops only after it has woken the caller.  A cache that keeps a view of
a gathered leaf fails that last check, and so does a reference cycle
that holds one."""
import inspect
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg

from _torch_port import flat, ref_and_port, tokens
from _torch_ranks import load_rank, run_ranks
from test_torch_mesh_serve import _reference_greedy

ROWS, PROMPT, NEW, FRAMES = 2, 16, 4, 16
#: decode steps measured one after another on (2, 1), and the most
#: seconds a rank waits after a call for the process group to drop the
#: call's last gathered buffer (``tp.gathered_bytes``)
DECODES, SETTLE_S = 5, 1.0
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
FAMILIES = ["llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b",
            "jamba-1.5-large-398b", "seamless-m4t-medium"]
#: case → (arch, int8 weights)
CASES = {**{arch: (arch, False) for arch in FAMILIES},
         "llama3.2-1b-int8": ("llama3.2-1b", True)}


def run_steps(eng, prefill, decode, x, new):
    """``prefill`` of ``x`` (prompts, or the encoder–decoder's frames) and
    ``new - 1`` greedy ``decode`` steps on ``eng``'s params and cache
    layout → {"logits" (new, B, V), "prefill_caches", "cache": {path:
    this rank's local tensor}}."""
    import torch

    from repro_torch.distributed import tp
    from repro_torch.launch.steps import place_token
    from repro_torch.tree import tree_flatten_with_path

    frames = eng.cfg.family == "encdec"
    plen = 1 if frames else x.shape[1]
    with torch.inference_mode():
        logits, caches = prefill(eng.model_params(),
                                 {"frames" if frames else "tokens": x})
        tight = {k: v.clone() for k, v in tree_flatten_with_path(caches)}
        cache = eng._expand_cache(caches, x.shape[0], plen)
        every = [logits]
        for i in range(1, new):
            tok = place_token(eng.mesh, logits.argmax(-1).to(torch.int32))
            logits, cache = decode(eng.model_params(), cache, tok,
                                   plen + i - 1)
            every.append(logits)
    return {"logits": torch.stack(every), "prefill_caches": tight,
            "cache": dict(tree_flatten_with_path(tp.to_local(cache)))}


#: one mesh's runs on a rank: each case through the server's steps and
#: through the oracle's (its params made whole along the data axes by
#: ``DTensor.redistribute``, then int8 leaves dequantized, with no
#: ``ParamGather`` installed); on (2, 1) the gathered bytes of a prefill
#: and of a decode step, and a prefill with a cache viewing a gathered
#: leaf
GATHER_SERVE_RANK = """
import gc
import time

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, tp
from repro_torch.distributed.sharding import (_leaves_with_path,
                                              _map_with_path)
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import lm
from repro_torch.quant import dequantize_params

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = make_host_mesh(inp["shape"], ("data", "model"))


def whole_along_data(params, cfg):
    def one(_, x):
        keep = [p if name == "model" else Replicate()
                for name, p in zip(mesh.axis_names, x.placements)]
        return x.redistribute(x.device_mesh, keep).to_local()

    return dequantize_params(_map_with_path(one, params), cfg.param_dtype)


def oracle(cfg):
    def prefill(params, batch):
        with ST._serving_on(mesh, cfg, params, ST._rows_of(batch)) as rows, \\
                ctx.gathering_params(None):
            logits, caches = ST.model_prefill(whole_along_data(params, cfg),
                                              cfg, ST.local_batch(mesh, batch))
            return tp.gather_rows(logits, rows), caches

    def decode(params, cache, token, pos):
        seq = tp.positions_on_model(cache, mesh)
        with ST._serving_on(mesh, cfg, params, token.shape[0],
                            kv_seq=seq) as rows, ctx.gathering_params(None):
            logits, _ = ST.model_decode(
                whole_along_data(params, cfg), cfg, tp.to_local(cache),
                token.to_local(), pos)
            return tp.gather_rows(logits, rows), cache

    return prefill, decode


def settled(before):
    # the live gathered bytes once they are back at ``before``, waiting at
    # most SETTLE_S: gloo's worker thread drops a collective's output
    # (here the step's last gathered buffer) only after it has woken the
    # caller (tp.gathered_bytes)
    deadline = time.monotonic() + SETTLE_S
    while tp.gathered_bytes()["live"] != before and \
            time.monotonic() < deadline:
        time.sleep(1e-3)
    return tp.gathered_bytes()["live"]


def measured(call):
    # the gathered bytes of one call, with gc off: a reference cycle
    # holding a gathered leaf would keep it alive
    tp.reset_gathered()
    before = tp.gathered_bytes()["live"]
    result = call()
    return result, {"peak": tp.gathered_bytes()["peak"], "before": before,
                    "live": settled(before)}


def gathered(eng, x):
    frames = eng.cfg.family == "encdec"
    batch = {"frames" if frames else "tokens": x}
    plen = 1 if frames else x.shape[1]
    out = {"dims": sorted(ST.param_gather(mesh, eng.params).dims)}
    gc.disable()
    try:
        with torch.inference_mode():
            (logits, caches), out["prefill"] = measured(
                lambda: eng._prefill_step(eng.model_params(), batch))
            cache = eng._expand_cache(caches, x.shape[0], plen)
            token = ST.place_token(mesh, logits.argmax(-1).to(torch.int32))
            out["decode"] = [measured(lambda: eng._decode_step(
                eng.model_params(), cache, token, plen))[1]
                for _ in range(DECODES)]
    finally:
        gc.enable()
    return out


def cycled(eng, x):
    # a planted fault: a decode step's first gathered leaf kept in a
    # reference cycle, which only gc frees
    real, planted = tp.gather_data, []

    def gather_data(tree, path, **kw):
        got = real(tree, path, **kw)
        if not planted:
            loop = {"leaf": _leaves_with_path(got)[0][1]}
            loop["loop"] = loop
            planted.append(True)
        return got

    with torch.inference_mode():
        logits, caches = eng._prefill_step(eng.model_params(), {"tokens": x})
        cache = eng._expand_cache(caches, *x.shape)
        token = ST.place_token(mesh, logits.argmax(-1).to(torch.int32))
        gc.disable()
        tp.gather_data = gather_data
        try:
            _, got = measured(lambda: eng._decode_step(
                eng.model_params(), cache, token, x.shape[1]))
        finally:
            tp.gather_data = real
            gc.enable()
        gc.collect()
        got["collected"] = settled(got["before"])
    return got


def pinned(eng, x):
    # a planted fault: the prefill's caches keep a view of a gathered
    # leaf of the first superblock
    real = lm.backbone

    def backbone(params, cfg, *a, **kw):
        h, caches = real(params, cfg, *a, **kw)
        first = tp.gather_data(lm._layer(params["blocks"], 0), ("blocks",),
                               layer=True)
        caches["pinned"] = {"wq": first["b0"]["attn"]["wq"][0]}
        return h, caches

    lm.backbone = backbone
    try:
        with torch.inference_mode():
            before = tp.gathered_bytes()["live"]
            _, caches = eng._prefill_step(eng.model_params(), {"tokens": x})
            return {"before": before, "live": settled(before)}
    finally:
        lm.backbone = real


out = {}
for name, case in inp["cases"].items():
    cfg = get_config(case["arch"], smoke=True).with_(dtype="float32")
    eng = ServeEngine(cfg, device="cpu", mesh=mesh, max_len=PROMPT + NEW,
                      params=case["params"], int8_weights=case["int8"])
    x = torch.as_tensor(case["inputs"])
    res = {"new": run_steps(eng, eng._prefill_step, eng._decode_step, x,
                            NEW),
           "old": run_steps(eng, *oracle(cfg), x, NEW)}
    if inp["shape"] == (2, 1) and not case["int8"]:
        res["gathered"] = gathered(eng, x)
        if name == "llama3.2-1b":
            res["pinned"] = pinned(eng, x)
            res["cycled"] = cycled(eng, x)
    out[name] = res
torch.save(out, f"{OUT}/rank{RANK}.pt")
"""


def _inputs(arch: str):
    if arch == "seamless-m4t-medium":
        return np.random.default_rng(5).standard_normal(
            (ROWS, FRAMES, 64)).astype(np.float32)
    return tokens(9, ROWS, PROMPT)


def _run_mesh(tmp, shape, cases):
    torch.save({"shape": shape, "cases": cases},
               os.path.join(tmp, "inputs.pt"))
    world = shape[0] * shape[1]
    code = (f"PROMPT, NEW, DECODES, SETTLE_S = {PROMPT}, {NEW}, "
            f"{DECODES}, {SETTLE_S}\n"
            + inspect.getsource(run_steps) + GATHER_SERVE_RANK)
    run_ranks(code, world, tmp)
    return [load_rank(tmp, r) for r in range(world)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case on every mesh (the meshes at once), and the reference's
    unsharded greedy tokens of each family."""
    cases, ref, params = {}, {}, {}
    for name, (arch, int8) in CASES.items():
        if arch not in params:
            jcfg, _, jp, _, tparams = ref_and_port(arch, "float32")
            params[arch] = tparams
            ref[arch] = (jcfg, jp)
        cases[name] = {"arch": arch, "int8": int8, "params": params[arch],
                       "inputs": _inputs(arch)}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {name: pool.submit(
            _run_mesh, str(tmp_path_factory.mktemp(name)), shape, cases)
            for name, shape in MESHES.items()}
        greedy = {arch: _reference_greedy(jcfg, jp, _inputs(arch), NEW,
                                          PROMPT + NEW)
                  for arch, (jcfg, jp) in ref.items()}
        runs = {name: f.result() for name, f in futures.items()}
    return runs, greedy, params


def _assert_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, (what, path)
        assert torch.equal(got[path], leaf), (what, path)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_gather_a_superblock_gives_the_whole_gathers_bits(served, mesh,
                                                               case):
    """On every rank: the logits of the prefill and of each decode step,
    the prefill's tight caches and the decode cache after the steps
    (this rank's blocks) ``torch.equal`` to the oracle's, which made
    every leaf whole along the data axes at once."""
    runs, _, _ = served
    for rank in runs[mesh]:
        new, old = rank[case]["new"], rank[case]["old"]
        assert new["logits"].shape == (NEW, ROWS, 256)
        assert bool(torch.isfinite(new["logits"]).all())
        assert torch.equal(new["logits"], old["logits"])
        _assert_equal(new["prefill_caches"], old["prefill_caches"],
                      "prefill")
        _assert_equal(new["cache"], old["cache"], "decode")


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_greedy_tokens_are_the_references(served, arch):
    """The greedy tokens of every mesh and rank equal the reference's
    unsharded greedy on the same params and inputs."""
    runs, greedy, _ = served
    for mesh, ranks in runs.items():
        for rank in ranks:
            got = rank[arch]["new"]["logits"].argmax(-1).T.to(torch.int32)
            np.testing.assert_array_equal(got.numpy(), greedy[arch],
                                          err_msg=mesh)


#: leaves of an encoder–decoder's decoder layer that its decode step
#: never reads: the cross-attention's kv projections (the memory's keys
#: and values are in the cache)
UNREAD_IN_DECODE = tuple(f"decoder/blocks/cross_attn/{k}"
                         for k in ("wk", "wv", "bk", "bv"))


def _bounds(params, arch: str, dims: list) -> dict:
    """kind → (bytes of the largest superblock's leaves that the rules
    shard along ``data``, of the largest superblock's leaves plus the
    largest leaf outside the blocks), each leaf whole; kinds: the
    prefill, and the decode step (the encoder–decoder's decoder layers
    alone, less the leaves its decode step never reads, which the
    prefill's decode step does not gather either)."""
    cfg = treg.get_config(arch, smoke=True)
    sharded = {"/".join(k) for k in dims}

    def size(t):
        return t.numel() * t.element_size()

    def read(k):
        return k not in UNREAD_IN_DECODE

    if cfg.family == "encdec":
        stacks = {"encoder/blocks/": cfg.enc_layers,
                  "decoder/blocks/": cfg.dec_layers}
    else:
        from repro_torch.models import lm
        stacks = {"blocks/": lm.num_superblocks(cfg)}
    per = {prefix: (sum(size(v) for k, v in flat(params)
                        if k.startswith(prefix) and k in sharded
                        and read(k)) // n,
                    sum(size(v) for k, v in flat(params)
                        if k.startswith(prefix)) // n,
                    sum(size(v) for k, v in flat(params)
                        if k.startswith(prefix) and read(k)) // n)
           for prefix, n in stacks.items()}
    outside = max(size(v) for k, v in flat(params)
                  if not any(k.startswith(p) for p in stacks))
    decode = per.get("decoder/blocks/", per.get("blocks/"))
    return {"prefill": (max(lo for lo, _, _ in per.values()),
                        max(hi for _, hi, _ in per.values()) + outside),
            "decode": (decode[0], decode[2] + outside)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_rank_holds_one_superblock_gathered_at_a_time(served, arch):
    """On (2, 1), with gc off, a prefill and then ``DECODES`` decode steps
    one after another: in each call the most gathered bytes alive at
    once (``tp.gathered_bytes``, counted until each gathered leaf's
    storage is freed) lie between one superblock's leaves that the rules
    shard and one superblock's leaves plus the largest leaf outside the
    blocks; after each call the live bytes are back at their value
    before it, once gloo's worker thread has dropped the call's last
    gathered buffer (at most ``SETTLE_S`` later): no cache and no
    reference cycle holds a gathered leaf."""
    runs, _, params = served
    for rank in runs["2x1"]:
        got = rank[arch]["gathered"]
        bounds = _bounds(params[arch], arch, got["dims"])
        assert len(got["decode"]) == DECODES
        for kind, calls in (("prefill", [got["prefill"]]),
                            ("decode", got["decode"])):
            lo, hi = bounds[kind]
            for i, call in enumerate(calls):
                peak = call["peak"] - call["before"]
                assert call["live"] == call["before"], (kind, i, call)
                assert 0 < lo <= peak <= hi, (kind, i, lo, peak, hi)


def test_a_cache_that_views_a_gathered_leaf_fails_the_live_check(served):
    """A planted fault: a prefill whose caches keep one row of the first
    superblock's gathered ``wq`` (a view, whose storage is the
    superblock's gathered buffer) leaves live bytes above their value
    before the call, ``SETTLE_S`` after it — the check above would fail."""
    runs, _, _ = served
    for rank in runs["2x1"]:
        got = rank["llama3.2-1b"]["pinned"]
        assert got["live"] > got["before"], got


def test_a_gathered_leaf_in_a_reference_cycle_fails_the_live_check(served):
    """A planted fault: a decode step that keeps its first gathered leaf
    in a reference cycle, with gc off, leaves live bytes above their
    value before the call ``SETTLE_S`` after it — the check above would
    fail — and they come back once ``gc.collect()`` has freed the cycle:
    the hold was the cycle's."""
    runs, _, _ = served
    for rank in runs["2x1"]:
        got = rank["llama3.2-1b"]["cycled"]
        assert got["live"] > got["before"], got
        assert got["collected"] == got["before"], got
