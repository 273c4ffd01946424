"""``repro_torch.launch.dryrun`` held against the reference's
``launch/dryrun.py``: its pure functions and model counts for every
(architecture × shape) cell, the per-device argument bytes of a decode
cell, the CLI on the reference's own smoke cells, and the invariants of
the counts at full width on the production mesh.

The reference's module sets ``XLA_FLAGS`` when it is imported, so it is
imported only in a subprocess, with the device count its own tests use.
Every run of the port's dry-run starts a fake process group, which is
process-global: each runs in a subprocess too (``subproc``)."""
import json

import pytest

from repro_torch.configs.base import SHAPES, count_params, shape_applicable
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.kernels import work
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline

CELLS = [(a, s) for a in all_archs() for s in SHAPES]

#: the reference's smoke cells (``tests/test_dryrun_smoke.py``)
SMOKE_CELLS = [
    ("llama3.2-1b", "train_4k", "single"),
    ("qwen2-0.5b", "prefill_32k", "single"),
    ("qwen2-0.5b", "decode_32k", "single"),
    ("mamba2-1.3b", "long_500k", "single"),
    ("granite-moe-1b-a400m", "train_4k", "multi"),
    ("seamless-m4t-medium", "decode_32k", "single"),
]
SMALL_MESHES = {"REPRO_MESH_SHAPE": "4,2", "REPRO_MESH_SHAPE_MULTI": "2,2,2"}
#: the reference's report keys the port keeps (all but
#: ``xla_cost_analysis``)
REF_KEYS = ("arch", "shape", "chips", "entry", "grad_accum", "params_total",
            "params_active", "hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "collective_by_kind",
            "collective_counts", "traffic_by_shape", "collective_by_shape",
            "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
            "model_flops_total", "model_flops_per_chip", "cache_bytes",
            "useful_flops_ratio", "roofline_mfu", "memory_analysis", "mesh",
            "mesh_shape", "ok", "skipped", "compile_s")
DP_SIZES = (1, 4, 8, 16, 32)
CHIP_COUNTS = (8, 256, 512)
KNOBS = ("attn_block_q", "attn_block_k", "remat", "pad_vocab_to",
         "tp_preference")

_REFERENCE_VALUES = f"""
import json
from repro.configs.base import SHAPES, shape_applicable
from repro.configs.registry import all_archs, get_config
from repro.launch import dryrun as D


class Compiled:
    '''What ``roofline_report`` reads of a compiled step, for a cell whose
    model counts alone are wanted: an empty program.'''

    def cost_analysis(self):
        return {{}}

    def memory_analysis(self):
        raise RuntimeError("no program")

    def as_text(self):
        return ("HloModule m\\n\\nENTRY %main.1 () -> f32[] {{\\n"
                "  ROOT %c.1 = f32[] constant(0)\\n}}\\n")


out = {{}}
for arch in all_archs():
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        ok, reason = shape_applicable(cfg, shape)
        row = {{
            "ok": ok, "reason": reason,
            "grad_accum": [D.pick_grad_accum(cfg, shape, dp)
                           for dp in {DP_SIZES!r}],
            "tp": [D.pick_tp(cfg, shape, c) for c in {CHIP_COUNTS!r}],
            "runtime": [{{k: getattr(D.runtime_config(cfg, shape, b), k)
                         for k in {KNOBS!r}}} for b in (False, True)],
        }}
        if ok:
            rep = D.roofline_report(arch, name, Compiled(), {{}}, 256)
            row.update({{k: rep[k] for k in (
                "params_total", "params_active", "model_flops_total",
                "model_flops_per_chip", "cache_bytes")}})
        out[arch + "|" + name] = row
print(json.dumps(out))
"""


def _last_json(r):
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_values(subproc):
    return _last_json(subproc(_REFERENCE_VALUES, devices=8, timeout=300))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_pure_functions_and_model_counts_equal_the_references(
        reference_values, arch, shape_name):
    """``pick_grad_accum``, ``runtime_config`` (both ``baseline``
    values), ``pick_tp``, the skip reason, params, model FLOPs and cache
    bytes: equal to the reference's for this cell."""
    want = reference_values[f"{arch}|{shape_name}"]
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    assert (ok, reason) == (want["ok"], want["reason"])
    assert [D.pick_grad_accum(cfg, shape, dp) for dp in DP_SIZES] \
        == want["grad_accum"]
    assert [D.pick_tp(cfg, shape, c) for c in CHIP_COUNTS] == want["tp"]
    assert [{k: getattr(D.runtime_config(cfg, shape, b), k) for k in KNOBS}
            for b in (False, True)] == want["runtime"]
    if not ok:
        return
    model_total, _ = D.model_flops(cfg, shape)
    assert count_params(cfg) == want["params_total"]
    assert count_params(cfg, active_only=cfg.moe is not None) \
        == want["params_active"]
    assert model_total == want["model_flops_total"]
    assert model_total / 256 == want["model_flops_per_chip"]
    assert D.cache_bytes(cfg, shape) == want["cache_bytes"]


def _port_cell(subproc, tmp_path, arch, shape, mesh, env=None, *,
               rank: int = 0, timeout: int = 300):
    code = f"""
import json, sys
from repro_torch.launch import dryrun
rec = dryrun.run_cell({arch!r}, {shape!r}, {mesh!r}, {str(tmp_path)!r},
                      rank={rank})
print(json.dumps(rec))
"""
    return _last_json(subproc(code, env=env, timeout=timeout))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium"])
def test_decode_argument_bytes_equal_the_references(arch, subproc, tmp_path):
    """decode_32k on the (4, 2) mesh: a device's argument bytes — the
    shards of the params it reads and of the caches, the token, the
    position — as the reference's ``memory_analysis`` gives them on 8
    forced host devices, and as the port's counter holds them.  The
    port's decode step takes this device's rows of the token, as the
    reference's does, and counts only the arguments it reads, as the
    reference's ``jax.jit`` (``keep_unused=False``) keeps only those: the
    encoder–decoder's decode reads neither the encoder's params nor its
    cross-attention's kv projections.  They differ by the position's 4
    bytes, named here (ROADMAP.md, differences the port keeps): a Python
    int in the port, a 4-byte int32 argument in the reference."""
    ref_dir = tmp_path / "ref"
    code = f"""
import sys
from repro.launch.dryrun import main
sys.exit(main(["--arch", {arch!r}, "--shape", "decode_32k",
               "--mesh", "single", "--out", {str(ref_dir)!r}]))
"""
    r = subproc(code, env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "REPRO_MESH_SHAPE": "4,2"}, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    safe = arch.replace(".", "_")
    ref = json.load(open(ref_dir / f"{safe}__decode_32k__single.json"))
    port = _port_cell(subproc, tmp_path / "port", arch, "decode_32k",
                      "single", {"REPRO_MESH_SHAPE": "4,2"})
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    got = port["memory_analysis"]["argument_size_in_bytes"]
    pos = 4
    assert got == want - pos
    assert port["cache_bytes"] == ref["cache_bytes"]
    assert port["peak_bytes_per_device"] >= got


@pytest.mark.parametrize("arch,shape,mesh", SMOKE_CELLS)
def test_cli_on_the_references_cells(arch, shape, mesh, subproc, tmp_path):
    """The reference's smoke cells on its small meshes: rc 0, the
    reference's keys (less ``xla_cost_analysis``), terms ≥ 0, FLOPs > 0,
    8 chips on the multi mesh.  granite-moe's multi cell passes here,
    where the reference's fails under jax 0.9.0 (ROADMAP.md §C)."""
    code = f"""
import sys
from repro_torch.launch.dryrun import main
sys.exit(main(["--arch", {arch!r}, "--shape", {shape!r},
               "--mesh", {mesh!r}, "--out", {str(tmp_path)!r}]))
"""
    r = subproc(code, env=SMALL_MESHES, timeout=300)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    assert f"[dryrun] {arch}" in r.stdout
    safe = arch.replace(".", "_")
    rec = json.load(open(tmp_path / f"{safe}__{shape}__{mesh}.json"))
    assert rec["ok"], rec
    assert set(REF_KEYS) <= set(rec)
    assert "xla_cost_analysis" not in rec
    assert rec["entry"] in ("train_step", "prefill_step", "decode_step")
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rec[term] >= 0
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["hlo_flops_per_device"] > 0
    assert rec["modeled"] == roofline.MODELED
    assert rec["peak_bytes_per_device"] >= \
        rec["memory_analysis"]["argument_size_in_bytes"] > 0
    if mesh == "multi":
        assert rec["chips"] == 8


def test_skip_recorded_for_full_attention_long(subproc, tmp_path):
    code = f"""
import sys
from repro_torch.launch.dryrun import main
sys.exit(main(["--arch", "yi-9b", "--shape", "long_500k",
               "--mesh", "single", "--out", {str(tmp_path)!r}]))
"""
    r = subproc(code, env={"REPRO_MESH_SHAPE": "4,2"})
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.load(open(tmp_path / "yi-9b__long_500k__single.json"))
    assert rec["skipped"] and "edge-infeasible" in rec["reason"]


def test_a_failing_cell_fails_the_run(subproc, tmp_path):
    """A cell whose trace raises is recorded with its error, printed as
    FAIL, and the run exits 1."""
    code = f"""
import sys
from repro_torch.launch import dryrun

def broken(*args, **kwargs):
    raise RuntimeError("planted")

dryrun.trace_cell = broken
sys.exit(dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--out", {str(tmp_path)!r}]))
"""
    r = subproc(code, env={"REPRO_MESH_SHAPE": "2,2"})
    assert r.returncode == 1, r.stderr[-2000:]
    assert "FAIL RuntimeError: planted" in r.stdout
    rec = json.load(open(tmp_path / "qwen2-0_5b__decode_32k__single.json"))
    assert not rec["ok"] and "planted" in rec["error"]


def _embedding_share(cfg, rec) -> float:
    """The model FLOPs of the input embedding table, a lookup and not a
    product: its params' share of ``model_flops_per_chip``."""
    if cfg.embeds_input and cfg.family != "encdec":
        return 0.0
    return rec["model_flops_per_chip"] * cfg.padded_vocab * cfg.d_model \
        / rec["params_active"]


def _unapplied_head_share(cfg, rec, shape: str) -> float:
    """A prefill applies the output head to the last position of each row
    only, where the model's count applies it at every position: the
    share of an untied ``lm_head``'s params in ``model_flops_per_chip``
    (a tied head is the embedding's, which :func:`_embedding_share`
    leaves out already)."""
    if SHAPES[shape].kind != "prefill" or cfg.tie_embeddings or \
            cfg.family == "encdec":
        return 0.0
    return rec["model_flops_per_chip"] * cfg.padded_vocab * cfg.d_model \
        / rec["params_active"]


#: one prefill and one train cell per family, at full width on the
#: production 16 × 16 mesh, where a cell traces in well under a minute
FULL_WIDTH = [
    ("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "train_4k"),
    ("granite-moe-1b-a400m", "prefill_32k"),
    ("granite-moe-1b-a400m", "train_4k"),
    ("mamba2-1.3b", "prefill_32k"), ("seamless-m4t-medium", "prefill_32k"),
    ("seamless-m4t-medium", "train_4k"), ("qwen2-vl-72b", "prefill_32k"),
    ("jamba-1.5-large-398b", "prefill_32k"),
]


@pytest.mark.parametrize("arch,shape", FULL_WIDTH)
def test_invariants_at_full_width(arch, shape, subproc, tmp_path):
    """On the production mesh: the counted FLOPs a device are at least
    the model's share less the embedding lookup's and, in a prefill, the
    head's at every position but the last (no undercount), the peak
    holds the arguments, and rank 0 and the last rank count the same in
    every key (SPMD) — the MoE routing's running sum over the ranks too,
    which every rank takes over all of them.  (The cell's ``data`` ×
    ``model`` is ``pick_tp``'s, as the reference's.)"""
    first = _port_cell(subproc, tmp_path / "first", arch, shape, "single")
    assert first["ok"] and first["chips"] == 256, first
    cfg = get_config(arch)
    assert first["hlo_flops_per_device"] >= \
        first["model_flops_per_chip"] - _embedding_share(cfg, first) \
        - _unapplied_head_share(cfg, first, shape)
    assert first["peak_bytes_per_device"] >= \
        first["memory_analysis"]["argument_size_in_bytes"]
    assert first["kernel_calls"], first
    if shape == "train_4k":
        return
    last = _port_cell(subproc, tmp_path / "last", arch, shape, "single",
                      rank=255)
    assert last["rank"] == 255
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device",
                "collective_by_kind", "kernel_calls", "memory_analysis",
                "peak_bytes_per_device"):
        assert last[key] == first[key], key


# ---------------------------------------------------------------------------
# pinned findings (ROADMAP.md §C): a later slice flips them
# ---------------------------------------------------------------------------


def test_mamba_mixer_is_split_by_heads_along_model(subproc, tmp_path):
    """mamba2-1.3b prefill at the same ``data`` size: on (4, 2) a device
    computes half of (4, 1)'s mixer, because the mixer computes a rank's
    heads along ``model``.  Every product — ``in_proj``, ``out_proj`` and
    the vocabulary-parallel head — is exactly half, and B4 runs on half
    the heads: its FLOPs are ``ssd_flops`` at H/2, half of (4, 1)'s but
    for the c·bᵀ product that every head shares, which each rank
    computes whole."""
    one = _port_cell(subproc, tmp_path / "one", "mamba2-1.3b", "prefill_32k",
                     "single", {"REPRO_MESH_SHAPE": "4,1"})
    two = _port_cell(subproc, tmp_path / "two", "mamba2-1.3b", "prefill_32k",
                     "single", {"REPRO_MESH_SHAPE": "4,2"})
    assert one["product_flops_by_dtype"]["bfloat16"] == \
        2 * two["product_flops_by_dtype"]["bfloat16"]
    cfg = get_config("mamba2-1.3b")
    s = cfg.ssm
    rows = SHAPES["prefill_32k"].global_batch // 4

    def ssd(heads):
        return cfg.num_layers * work.ssd_flops(rows, 32_768, heads,
                                               s.head_dim, s.state_dim)

    h = s.num_heads(cfg.d_model)
    calls = one["kernel_calls"]["mamba2_ssd"], two["kernel_calls"][
        "mamba2_ssd"]
    assert calls[0]["launches"] == calls[1]["launches"] == cfg.num_layers
    assert (calls[0]["flops"], calls[1]["flops"]) == (ssd(h), ssd(h // 2))
    assert 2 * calls[1]["flops"] - calls[0]["flops"] == ssd(0)


def _wq_wo_shards(cfg, tp: int = 16) -> set:
    """The ``collective_by_shape`` keys of a ``wq`` or ``wo`` shard of one
    layer gathered along ``model`` = tp."""
    d, width = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim // tp
    return {f"all-gather bfloat16[{d},{width}]",
            f"all-gather bfloat16[{width},{d}]"}


def test_llama_splits_its_query_heads_at_model_16(subproc, tmp_path):
    """llama3.2-1b on the production 16 × 16 mesh: its 8 kv heads do not
    divide ``model`` = 16 but its 32 query heads do, so, as the
    reference's rules place the leaves, a rank computes its 2 query
    heads against the one kv head they read (``layers.head_case``'s
    ``QUERY``): the flash kernel's FLOPs are 16 launches at 2 query and 1
    kv heads, no ``wq`` / ``wo`` shard is gathered along ``model``, and a
    device computes under 2.5 × its share of the model FLOPs."""
    rec = _port_cell(subproc, tmp_path, "llama3.2-1b", "prefill_32k",
                     "single")
    cfg = get_config("llama3.2-1b")
    assert cfg.num_kv_heads % 16 and cfg.num_heads % 16 == 0
    rows, s = SHAPES["prefill_32k"].global_batch // 16, 32_768
    call = rec["kernel_calls"]["flash_attention"]
    assert call["launches"] == cfg.num_layers
    one = roofline.attention_work(rows, cfg.num_heads // 16, 1, s, s,
                                  cfg.resolved_head_dim, True, 0,
                                  cfg.param_dtype)
    assert call["flops"] == cfg.num_layers * one.flops
    assert call["bytes"] == cfg.num_layers * one.bytes
    assert not _wq_wo_shards(cfg) & set(rec["collective_by_shape"])
    # the attention's S² products are the kernel's, counted once: the
    # plain version's full score matrices (2× the kernel's causal half)
    # would outweigh everything else the prefill multiplies
    products = rec["product_flops_by_dtype"]["bfloat16"]
    assert rec["hlo_flops_per_device"] == products + call["flops"]
    assert rec["hlo_flops_per_device"] <= 2.5 * rec["model_flops_per_chip"]


def test_llama_decode_moves_its_queries_not_its_weights_along_model(
        subproc, tmp_path):
    """llama3.2-1b ``decode_32k`` on 16 × 16: the caches hold their
    positions in blocks along ``model``, so each layer gathers its ranks'
    queries — (B, 32, 1, 64) of this rank's 8 rows — and no ``wq`` or
    ``wo`` shard: under 16 MB a step on the ``model`` axis."""
    rec = _port_cell(subproc, tmp_path, "llama3.2-1b", "decode_32k",
                     "single")
    cfg = get_config("llama3.2-1b")
    assert not _wq_wo_shards(cfg) & set(rec["collective_by_shape"])
    assert rec["collective_by_axis"]["model"]["bytes"] < 16e6


def test_nemotron_prefill_runs_3_query_heads_on_1_kv_head(subproc,
                                                          tmp_path):
    """nemotron-4-15b ``prefill_32k`` on 16 × 16: 48 query and 8 kv
    heads, so a rank's 3 query heads lie in one kv head (6 a group): B2's
    FLOPs and bytes are its 32 launches at 3 query heads on 1 kv head of
    128."""
    rec = _port_cell(subproc, tmp_path, "nemotron-4-15b", "prefill_32k",
                     "single")
    cfg = get_config("nemotron-4-15b")
    assert (cfg.num_heads // 16, cfg.num_heads // cfg.num_kv_heads) == (3, 6)
    rows, s = SHAPES["prefill_32k"].global_batch // 16, 32_768
    call = rec["kernel_calls"]["flash_attention"]
    one = roofline.attention_work(rows, 3, 1, s, s, cfg.resolved_head_dim,
                                  True, 0, cfg.param_dtype)
    assert call["launches"] == cfg.num_layers
    assert (call["flops"], call["bytes"]) == (cfg.num_layers * one.flops,
                                              cfg.num_layers * one.bytes)
    assert not _wq_wo_shards(cfg) & set(rec["collective_by_shape"])


_BUILT_ON_A_DEVICE = """
import json
import torch
import torch.distributed as dist
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.graph_analysis import StepCounter
from repro_torch.launch.mesh import make_host_mesh, single_device_mesh

out = {}
for arch, kind in (("llama3.2-1b", "prefill"), ("qwen2-0.5b", "train")):
    cfg, shape = get_config(arch, smoke=True), ShapeConfig("t", 32, 2, kind)
    mesh = single_device_mesh("cpu")
    step, args = D.build_step(cfg, shape, mesh, device="cpu")
    held = StepCounter()
    held.arguments(*args)
    res = step(*args)
    watched = res[2]["loss"] if kind == "train" else res[0]
    finite = bool(torch.isfinite(watched).all())
    dist.destroy_process_group()
    D.fake_world(1)
    step, args = D.build_step(cfg, shape,
                              make_host_mesh((1, 1), ("data", "model")))
    _, stats = D.count_step(step, *args)
    dist.destroy_process_group()
    out[arch] = [held.stats.unread_argument_bytes, stats.argument_bytes,
                 stats.unread_argument_bytes, finite,
                 dict(stats.collective_bytes)]
print(json.dumps(out))
"""


def test_a_step_built_on_a_device_holds_the_predicted_arguments(subproc):
    """``build_step`` on the CPU (a gloo world of one, params drawn,
    random tokens) runs, and holds the argument bytes that its meta twin
    on a fake world of one counts, every one of them read by the step:
    what ``chip_smoke.py``'s ``dryrun`` phase holds against the card's
    allocator.  (A counter that runs no step has read nothing: all its
    arguments' bytes are unread.)  A world of one moves no collective
    bytes."""
    got = _last_json(subproc(_BUILT_ON_A_DEVICE, timeout=300))
    for arch, (real, meta, unread, finite, coll) in got.items():
        assert real == meta > 0, arch
        assert unread == 0, arch
        assert finite, arch
        assert coll == {}, arch


_META_KERNELS_SWITCH = """
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.graph_analysis import use_compiled_meta_kernels
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import tree_flatten_with_path

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_host_mesh((2, 2), ("data", "model"))


def layout(tree):
    rows = []
    for path, t in tree_flatten_with_path(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = getattr(t, "_local_tensor", t)
        rows.append([str(path), list(t.shape), str(t.dtype),
                     list(local.shape), list(local.stride()),
                     str(getattr(t, "placements", ""))])
    return rows


def counts():
    out = {}
    for arch, kind in CASES:
        cfg = get_config(arch, smoke=True)
        step, args = D.build_step(cfg, ShapeConfig("t", 32, 4, kind), mesh)
        res, stats = D.count_step(step, *args)
        out[arch + " " + kind] = [stats.summary(), layout(res)]
    return out


python = counts()
kept = use_compiled_meta_kernels()
print(json.dumps({"kept": kept, "python": python, "compiled": counts()}))
"""


def test_compiled_meta_kernels_count_what_the_python_ones_count(subproc):
    """``use_compiled_meta_kernels`` (which the dry-run's world turns on)
    changes how fast an op on ``meta`` is shaped, not what it counts: on
    a fake 2 × 2 world, each smoke-config step counted with torch's Python
    meta functions and again with ATen's compiled Meta kernels gives the
    same ``GraphStats.summary()`` (FLOPs, bytes, collectives, kernel
    launches, argument, output and peak bytes) and results of the same
    shapes, dtypes, local strides and placements."""
    cases = [("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
             ("granite-moe-1b-a400m", "train"), ("mamba2-1.3b", "prefill"),
             ("qwen2-0.5b", "decode")]
    got = _last_json(subproc(f"CASES = {cases!r}\n" + _META_KERNELS_SWITCH,
                             timeout=300))
    assert got["kept"] > 0          # the switch took the Python ones down
    assert set(got["python"]) == {f"{a} {k}" for a, k in cases}
    for cell, (summary, layout) in got["python"].items():
        assert summary["memory_bytes"] > 0, cell
        assert got["compiled"][cell] == [summary, layout], cell


# ---------------------------------------------------------------------------
# a fault the meta path showed, repaired
# ---------------------------------------------------------------------------


def test_a_mamba_prefill_cache_holds_only_its_rows():
    """The prefill's conv cache (the last K-1 rows of the conv input) was
    a view of the layer's whole (B, L, conv_dim) projection, so a prefill
    held every layer's projection until the caches were stacked — on
    the 16 × 16 mesh mamba2-1.3b's ``prefill_32k`` peaked at 60.2 GB a
    device, 48 projections of 1.1 GB.  The cache is now a copy of its
    rows, the same values."""
    import torch

    from repro_torch.models import mamba2 as M

    cfg = get_config("mamba2-1.3b", smoke=True)
    p = M.init_mamba(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(cfg.param_dtype)
    out, cache = M.mamba_layer(p, cfg, x, return_state=True)
    conv = cache["conv"]
    assert conv.shape == (2, cfg.ssm.conv_kernel - 1, cfg.ssm.conv_dim(
        cfg.d_model))
    assert conv.untyped_storage().nbytes() == conv.numel() * \
        conv.element_size()
    plain = M.mamba_layer(p, cfg, x)
    assert torch.equal(out, plain)


def test_mamba_prefill_peak_holds_no_projection_per_layer(subproc,
                                                          tmp_path):
    """On the production mesh a device's peak through mamba2-1.3b's
    prefill stays under what the view held: one (rows, S, in_proj
    columns) projection a layer."""
    rec = _port_cell(subproc, tmp_path, "mamba2-1.3b", "prefill_32k",
                     "single")
    cfg = get_config("mamba2-1.3b")
    s = cfg.ssm
    rows, seq = SHAPES["prefill_32k"].global_batch // 16, 32_768
    cols = 2 * s.d_inner(cfg.d_model) + 2 * s.state_dim \
        + s.num_heads(cfg.d_model)
    held = cfg.num_layers * rows * seq * cols * cfg.param_dtype.itemsize
    assert rec["peak_bytes_per_device"] < held / 4


#: (shape, mesh) → the most bytes a device of the production mesh may
#: hold at the peak of jamba-1.5-large-398b's serve step
JAMBA_SERVE_PEAKS = {("prefill_32k", "single"): 80e9,
                     ("prefill_32k", "multi"): 80e9,
                     ("decode_32k", "single"): 20e9}


@pytest.mark.parametrize("shape,mesh", list(JAMBA_SERVE_PEAKS))
def test_jamba_serves_within_the_cards_memory(shape, mesh, subproc,
                                              tmp_path):
    """jamba-1.5-large-398b's serve steps gather their params along the
    data axes one superblock (8 layers) at a time, as the reference's
    scanned ``jit`` does, not a device's whole ``model`` shard (≈ 53 GB)
    at once.  The dry-run's peak a device: ``prefill_32k`` on 16 × 16
    47 681 532 608 bytes and on 2 × 16 × 16 38 964 540 192, under the
    card's 80e9 (92 086 629 056 and 83 369 636 640 with every leaf
    gathered at once); ``decode_32k`` on 16 × 16 15 433 446 048, under
    20e9 (57 506 542 208)."""
    rec = _port_cell(subproc, tmp_path, "jamba-1.5-large-398b", shape, mesh)
    assert rec["ok"] and rec["entry"] == f"{shape.split('_')[0]}_step", rec
    assert rec["peak_bytes_per_device"] < JAMBA_SERVE_PEAKS[shape, mesh]
    assert rec["peak_bytes_per_device"] >= \
        rec["memory_analysis"]["argument_size_in_bytes"]
