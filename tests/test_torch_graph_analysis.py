"""``repro_torch.launch.graph_analysis`` (the counts of one step on
``meta`` tensors) held against the reference's ``launch/hlo_analysis.py``
on the same small programs, the kernels' ``meta`` branches held against
their plain versions and the shared work functions, and
``launch/roofline.py`` against the bounds PERF.md §6 records.

The reference's side runs as its own tests run it: ``jax.jit`` on the
CPU, ``lax.scan`` loops, and the collectives on 4 forced host devices in
a subprocess.  The port's side runs the same program as a Python loop on
``meta`` tensors; its collectives on a fake 4-rank world, in a
subprocess of its own (the world is process-global)."""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import mamba2_ssd as ms
from repro_torch.launch import roofline
from repro_torch.launch.graph_analysis import count_step


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# dot FLOPs: the reference's three programs
# ---------------------------------------------------------------------------


def _ref_scanned(m, n_steps):
    def f(x, w):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=n_steps)
        return h
    return f, (jnp.ones((m, m)), jnp.ones((m, m)))


def _port_scanned(m, n_steps):
    def f(x, w):
        for _ in range(n_steps):
            x = torch.tanh(x @ w)
        return x
    return f, (_meta(m, m), _meta(m, m))


def _ref_nested(m, inner, outer):
    def f(x, w):
        def outer_body(h, _):
            def inner_body(hh, _):
                return hh @ w, None
            h2, _ = jax.lax.scan(inner_body, h, None, length=inner)
            return h2, None
        h, _ = jax.lax.scan(outer_body, x, None, length=outer)
        return h
    return f, (jnp.ones((m, m)), jnp.ones((m, m)))


def _port_nested(m, inner, outer):
    def f(x, w):
        for _ in range(outer):
            for _ in range(inner):
                x = x @ w
        return x
    return f, (_meta(m, m), _meta(m, m))


def _ref_plain(m):
    return (lambda a, b: a @ b), (jnp.ones((m, m)), jnp.ones((m, m)))


def _port_plain(m):
    return (lambda a, b: a @ b), (_meta(m, m), _meta(m, m))


PROGRAMS = {
    "scanned_64_x24": (_ref_scanned, _port_scanned, (64, 24)),
    "nested_16_4x6": (_ref_nested, _port_nested, (16, 4, 6)),
    "unscanned_32": (_ref_plain, _port_plain, (32,)),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_dot_flops_equal_the_references(name):
    """The same program's dot FLOPs from the reference's trip-scaled HLO
    and from one eager run of its Python loop on meta: equal to 1 %, and
    the port's equal to the analytic 2·m³·trips exactly."""
    ref_fn, port_fn, args = PROGRAMS[name]
    f, xs = ref_fn(*args)
    want = analyze_hlo(jax.jit(f).lower(*xs).compile().as_text()).dot_flops
    g, ts = port_fn(*args)
    _, stats = count_step(g, *ts)
    assert stats.dot_flops == pytest.approx(want, rel=0.01)
    m, trips = args[0], 1
    for t in args[1:]:
        trips *= t
    assert stats.dot_flops == 2 * m ** 3 * trips
    assert stats.product_flops_by_dtype == {"float32": stats.dot_flops}


# ---------------------------------------------------------------------------
# collectives: the reference's psum and all-gather on 4 devices
# ---------------------------------------------------------------------------

_REF_COLLECTIVES = """
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_host_mesh
from repro.launch.hlo_analysis import analyze_hlo

mesh = make_host_mesh((4,), ("data",))
f = shard_map(lambda x: jax.lax.psum(x, "data"), mesh=mesh,
              in_specs=P("data"), out_specs=P())
psum = analyze_hlo(jax.jit(f).lower(
    jnp.ones((16, 256), jnp.float32)).compile().as_text())
sh = NamedSharding(mesh, P("data", None))
xs = jax.device_put(jnp.ones((16, 64), jnp.float32), sh)
g = jax.jit(lambda v: v * 2.0, in_shardings=(sh,),
            out_shardings=NamedSharding(mesh, P()))
gather = analyze_hlo(g.lower(xs).compile().as_text())
print(json.dumps({"psum": dict(psum.collective_bytes),
                  "all_gather": dict(gather.collective_bytes)}))
"""

_PORT_COLLECTIVES = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.graph_analysis import count_step
from repro_torch.launch.mesh import make_host_mesh

fake_world(4)
mesh = make_host_mesh((4,), ("data",))
dm = mesh.device_mesh
block = torch.empty(4, 256, device="meta")        # a rank's (16, 256) rows


def c10d_psum(t):
    dist.all_reduce(t, group=mesh.get_group("data"))
    return t


def dtensor_psum(t):
    return DTensor.from_local(t, dm, [Partial()]).redistribute(
        dm, [Replicate()]).to_local()


xs = distribute_tensor(torch.empty(16, 64, device="meta"), dm, [Shard(0)],
                       src_data_rank=None)
out = {}
for name, fn, arg in (("psum", c10d_psum, block),
                      ("psum_dtensor", dtensor_psum, block),
                      ("all_gather", lambda v: (v * 2.0).redistribute(
                          dm, [Replicate()]).to_local(), xs)):
    _, s = count_step(fn, arg)
    assert abs(sum(s.collective_by_shape.values())
               - s.total_collective_bytes) < 1e-6, s.summary()
    assert set(s.collective_by_group) == {mesh.get_group("data").group_name}
    out[name] = dict(s.collective_bytes)
    out[name + "_ranks"] = list(s.group_ranks.values())
print(json.dumps(out))
"""


def _last_json(r):
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_collective_bytes_equal_the_references(subproc):
    """All-reduce and all-gather bytes per kind on a 4-rank world: the
    reference's psum and all-gather on 4 forced host devices, the port's
    c10d all-reduce and DTensor redistributes on a fake world — equal,
    and each sums by shape to its total."""
    ref = _last_json(subproc(_REF_COLLECTIVES, devices=4))
    port = _last_json(subproc(_PORT_COLLECTIVES))
    assert ref["psum"] == {"all-reduce": 2 * 4 * 256 * 4}
    assert port["psum"] == ref["psum"]
    assert port["psum_dtensor"] == ref["psum"]
    assert port["all_gather"] == ref["all_gather"] == {"all-gather": 16 * 64 * 4}
    assert port["psum_ranks"] == [[0, 1, 2, 3]]


# ---------------------------------------------------------------------------
# the memory proxy
# ---------------------------------------------------------------------------


def test_in_place_cache_update_is_charged_the_update():
    """A one-row write into a 2 MiB buffer: the reference charges under
    64 KiB; the port charges 2 × the update exactly."""
    big = _meta(4096, 128)
    upd = _meta(1, 128)

    def f(b, u):
        b[17:18].copy_(u)
        return b

    _, stats = count_step(f, big, upd)
    assert stats.memory_bytes == 2 * 128 * 4 < 64 * 1024

    def ref(b, u):
        return jax.lax.dynamic_update_slice(b, u, (17, 0))

    compiled = jax.jit(ref, donate_argnums=(0,)).lower(
        jnp.zeros((4096, 128), jnp.float32),
        jnp.ones((1, 128), jnp.float32)).compile()
    assert analyze_hlo(compiled.as_text()).memory_bytes < 64 * 1024


def test_traffic_by_shape_sums_to_memory_bytes():
    m = 64
    _, stats = count_step(lambda a, b, c: (a @ b) @ c, _meta(m, m),
                          _meta(m, m), _meta(m, m))
    assert stats.memory_bytes == 2 * 3 * m * m * 4     # two products
    assert sum(stats.traffic_by_shape.values()) == stats.memory_bytes


def test_elementwise_ops_and_views():
    """An elementwise op is a launch (inputs + outputs); a view and a bare
    allocation cost nothing."""
    x = _meta(32, 16)

    def f(t):
        v = t.view(16, 32).transpose(0, 1)
        e = torch.empty_like(t)
        return v * 2.0, e

    _, stats = count_step(f, x)
    assert stats.memory_bytes == 2 * 32 * 16 * 4
    assert stats.dot_flops == 0


def test_peak_follows_the_storages_that_live():
    """Ten chained adds hold the argument, the last result and the one in
    making — three buffers, not eleven; the arguments count from the
    start."""
    n = 1024 * 4

    def f(x):
        for _ in range(10):
            x = x + 1
        return x

    _, stats = count_step(f, _meta(1024))
    assert stats.argument_bytes == n
    assert stats.output_bytes == n
    assert stats.peak_bytes == 3 * n


def test_an_argument_the_step_never_reads_is_not_counted():
    """As the reference's ``jax.jit`` drops a parameter its program never
    reads: an argument counts, and is live from the start, only if an op
    of the step reads it — ``y``, read by the step's last op, counts in
    the peak from the start; ``z``, whose shape alone the step reads,
    counts nowhere but in ``unread_argument_bytes``."""
    n = 1024 * 4

    def f(x, y, z):
        a = x + 1
        b = a * 2
        del a
        assert z.shape == (1024,)
        return b + y

    _, stats = count_step(f, _meta(1024), _meta(1024), _meta(1024))
    assert stats.argument_bytes == 2 * n
    assert stats.unread_argument_bytes == n
    assert stats.peak_bytes == 2 * n + 2 * n


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _rand(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)
                       ).to(dtype)


def _attn(dev):
    mk = _rand if dev == "cpu" else _meta
    q, k, v = mk(2 * 4, 40, 32, dtype=BF), mk(2 * 2, 56, 32, dtype=BF), \
        mk(2 * 2, 56, 32, dtype=BF)
    out = fa.flash_attention(q, k, v, heads_q=4, heads_kv=2, q_offset=16,
                             return_lse=True)
    return out, roofline.attention_work(2, 4, 2, 40, 56, 32, True, 16, BF,
                                        lse=True)


def _attn_bwd(dev):
    mk = _rand if dev == "cpu" else _meta
    q, k, v = mk(2 * 4, 40, 32, dtype=BF), mk(2 * 2, 56, 32, dtype=BF), \
        mk(2 * 2, 56, 32, dtype=BF)
    out, lse = mk(2 * 4, 40, 32, dtype=BF), mk(2 * 4, 40)
    got = fa.flash_attention_bwd(q, k, v, out, lse, out, heads_q=4,
                                 heads_kv=2, causal=False)
    return got, roofline.attention_bwd_work(2, 4, 2, 40, 56, 32, False, 0, BF)


def _mlp(dev):
    mk = _rand if dev == "cpu" else _meta
    x, wg, wu, wd = mk(10, 64, dtype=BF), mk(64, 96, dtype=BF), \
        mk(64, 96, dtype=BF), mk(96, 64, dtype=BF)
    return fm.fused_mlp(x, wg, wu, wd), roofline.mlp_work(10, 64, 96, True, BF)


def _mlp_bwd(dev):
    mk = _rand if dev == "cpu" else _meta
    x, wu, wd = mk(10, 64, dtype=BF), mk(64, 96, dtype=BF), mk(96, 64,
                                                                 dtype=BF)
    got = fm.fused_mlp_bwd(x, None, wu, wd, x, act="relu")
    return got, roofline.mlp_bwd_work(10, 64, 96, False, BF)


def _ssd_inputs(mk):
    b, l, h, p, n = 2, 70, 3, 8, 16
    return (mk(b, l, h, p, dtype=BF), mk(b, l, h), mk(h), mk(b, l, n, dtype=BF),
            mk(b, l, n, dtype=BF), mk(b, h, p, n))


def _ssd(dev):
    mk = _rand if dev == "cpu" else _meta
    y, sf, states = ms.mamba2_ssd(*_ssd_inputs(mk), chunk=7,
                                  return_states=True)
    if dev == "meta":
        assert states.shape == (2, 3, 3, 8, 16)
        assert states.dtype == torch.float32
    return (y, sf), roofline.ssd_work(2, 70, 3, 8, 16, BF, states=True)


def _ssd_bwd(dev):
    mk = _rand if dev == "cpu" else _meta
    ins = _ssd_inputs(mk)
    states = None if dev == "cpu" else _meta(2, 3, 3, 8, 16)
    got = ms.mamba2_ssd_bwd(*ins, ins[0], ins[5], chunk=7, states=states)
    return got, roofline.ssd_bwd_work(2, 70, 3, 8, 16, BF, state_grad=True)


KERNELS = {"flash_attention": _attn, "flash_attention_bwd": _attn_bwd,
           "fused_mlp": _mlp, "fused_mlp_bwd": _mlp_bwd,
           "mamba2_ssd": _ssd, "mamba2_ssd_bwd": _ssd_bwd}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_meta_branch(name):
    """On meta tensors a wrapper returns its kernel's outputs' shapes and
    dtypes (the plain version's on the CPU), records one launch with the
    shared work function's FLOPs and bytes, runs none of the plain
    version's ops, and touches no launch count."""
    mod = {"flash": fa, "fused": fm, "mamba2": ms}[name.split("_")[0]]
    counts = (mod.launches, mod.bwd_launches, mod.plain_cuda_calls,
              mod.bwd_plain_cuda_calls)
    cpu, _ = KERNELS[name]("cpu")
    (meta, work), stats = count_step(lambda: KERNELS[name]("meta"))
    got, want = _flat(meta), _flat(cpu)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    assert stats.kernel_calls == {name: {
        "launches": 1, "flops": work.flops, "bytes": work.bytes,
        "seconds": work.flops / work.rate}}
    assert stats.dot_flops == 0 and stats.conv_flops == 0
    if name != "mamba2_ssd_bwd":        # the wrapper's partial sums after it
        assert stats.memory_bytes == work.bytes
    assert (mod.launches, mod.bwd_launches, mod.plain_cuda_calls,
            mod.bwd_plain_cuda_calls) == counts


def test_no_counter_no_record():
    """Outside a StepCounter a wrapper on meta records nothing and still
    returns its shapes."""
    out = fa.flash_attention(_meta(4, 8, 16), _meta(4, 8, 16),
                             _meta(4, 8, 16), heads_q=1, heads_kv=1)
    assert out.shape == (4, 8, 16) and out.device.type == "meta"


# ---------------------------------------------------------------------------
# the roofline: one count of the card and of each kernel's work
# ---------------------------------------------------------------------------

#: PERF.md §6's bounds (ms), NVIDIA H100 SXM data sheet, at their shapes
BOUNDS = {
    "B2": (lambda: roofline.attention_work(4, 32, 8, 1024, 1024, 64, True, 0,
                                           BF), 0.01739),
    "B3": (lambda: roofline.mlp_work(4096, 2048, 8192, True, BF), 0.4169),
    "B4": (lambda: roofline.ssd_work(4, 1024, 64, 64, 128, BF), 0.02598),
    "B2'": (lambda: roofline.attention_bwd_work(4, 32, 8, 4096, 4096, 64,
                                                True, 0, BF), 0.6950),
    "B3'": (lambda: roofline.mlp_bwd_work(16384, 2048, 8192, True, BF),
            3.335),
    "B4'": (lambda: roofline.ssd_bwd_work(4, 4096, 64, 64, 128, BF,
                                          state_grad=False), 0.1327),
    "B1": (lambda: roofline.conv_work(224 * 224 * 136 * 4, 9 * 136 * 136 * 4,
                                      224 * 224 * 136 * 4, 224 * 224 * 136,
                                      3, 136, False), 0.4993),
}


@pytest.mark.parametrize("kernel", sorted(BOUNDS))
def test_roofline_reproduces_the_recorded_bounds(kernel):
    work, want = BOUNDS[kernel]
    assert float(f"{work().bound_ms():.4g}") == want


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _attn_io(b, hq, hkv, sq, sk, d, causal, off, bwd):
    """(the tensors a call reads and writes, its work) at one shape, bf16
    on the CPU (the plain version): the forward's q, k, v and out; the
    backward's q, k, v, out, lse and dout read, dq, dk and dv written."""
    q, dout = _rand(b * hq, sq, d, dtype=BF), _rand(b * hq, sq, d, dtype=BF)
    k, v = _rand(b * hkv, sk, d, dtype=BF), _rand(b * hkv, sk, d, dtype=BF)
    kw = dict(heads_q=hq, heads_kv=hkv, causal=causal, q_offset=off)
    if not bwd:
        out = fa.flash_attention(q, k, v, **kw)
        return (q, k, v, out), roofline.attention_work(
            b, hq, hkv, sq, sk, d, causal, off, BF)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, scale=d ** -0.5,
                                 **kw)
    return (q, k, v, out, lse, dout, *got), roofline.attention_bwd_work(
        b, hq, hkv, sq, sk, d, causal, off, BF)


def _mlp_io(m, d, f, gated, bwd):
    """The forward's x, weights and out; the backward's x, weights and dy
    read, dx and the weight gradients written."""
    x, dy = _rand(m, d, dtype=BF), _rand(m, d, dtype=BF)
    wg = _rand(d, f, dtype=BF) if gated else None
    wu, wd = _rand(d, f, dtype=BF), _rand(f, d, dtype=BF)
    act = "silu" if gated else "relu"
    if not bwd:
        return (x, wg, wu, wd, fm.fused_mlp(x, wg, wu, wd, act=act)), \
            roofline.mlp_work(m, d, f, gated, BF)
    got = fm.fused_mlp_bwd(x, wg, wu, wd, dy, act=act)
    return (x, wg, wu, wd, dy, *got), roofline.mlp_bwd_work(m, d, f, gated,
                                                           BF)


def _ssd_io(b, l, h, p, n, state_grad, bwd):
    """The scan's x, dt, a, b, c and initial state read, y and the final
    state written; the backward's inputs, dy and the state's cotangent
    read, its six gradients written."""
    x, dy = _rand(b, l, h, p, dtype=BF), _rand(b, l, h, p, dtype=BF)
    dt, a, s0 = _rand(b, l, h), _rand(h), _rand(b, h, p, n)
    bm, cm = _rand(b, l, n, dtype=BF), _rand(b, l, n, dtype=BF)
    if not bwd:
        return (x, dt, a, bm, cm, s0, *ms.mamba2_ssd(
            x, dt, a, bm, cm, s0, chunk=l)), roofline.ssd_work(
                b, l, h, p, n, BF)
    dsf = _rand(b, h, p, n) if state_grad else None
    got = ms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy, dsf, chunk=l)
    return (x, dt, a, bm, cm, s0, dy, dsf, *got), roofline.ssd_bwd_work(
        b, l, h, p, n, BF, state_grad=state_grad)


#: ``chip_smoke.py``'s shapes where a bound is limited by bytes (and two
#: gated ones), each kernel and backward
IO_CASES = {
    "B2 ragged.s100": lambda: _attn_io(3, 14, 2, 100, 100, 64, True, 0,
                                       False),
    "B2' ragged.s100": lambda: _attn_io(3, 14, 2, 100, 100, 64, True, 0,
                                        True),
    "B2' d16.s1": lambda: _attn_io(1, 4, 2, 1, 1, 16, True, 0, True),
    "B2' ragged.offset": lambda: _attn_io(2, 8, 1, 77, 300, 64, True, 223,
                                          True),
    "B3 m1.ungated": lambda: _mlp_io(1, 256, 320, False, False),
    "B3' m1.ungated": lambda: _mlp_io(1, 256, 320, False, True),
    "B3' gated": lambda: _mlp_io(10, 64, 96, True, True),
    "B4 ragged.l37.p8.n8": lambda: _ssd_io(2, 37, 5, 8, 8, False, False),
    "B4' ragged.l37.p8.n8": lambda: _ssd_io(2, 37, 5, 8, 8, True, True),
    "B4' no state grad": lambda: _ssd_io(2, 37, 5, 8, 8, False, True),
}


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_work_bytes_are_the_calls_inputs_and_outputs(case):
    """A kernel's bytes are each tensor the call reads once and each it
    writes once — what ``chip_smoke.py``'s bound rows summed over the
    call's own tensors before the count moved to ``kernels/work.py`` —
    exactly, at shapes where the bound is limited by bytes."""
    tensors, work = IO_CASES[case]()
    assert work.bytes == _nbytes(*tensors)
    if case.startswith(("B2' ragged.s100", "B3' m1")):
        assert work.bound_by() == "bytes"


def test_the_kernels_import_nothing_of_launch():
    """The kernel layer sits under the launch layer: a wrapper records its
    meta work through ``kernels/work.py``, and no module of
    ``repro_torch.kernels`` imports ``repro_torch.launch``."""
    import ast
    import pathlib

    import repro_torch.kernels as K

    for path in pathlib.Path(K.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.startswith("repro_torch.launch")
                           for n in names), path.name


def test_chip_smoke_reads_the_one_count():
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S is roofline.HBM_BYTES_PER_S
    for fn in ("attention_work", "attention_bwd_work", "mlp_work",
               "mlp_bwd_work", "mlp_bwd_mma_work", "ssd_work",
               "ssd_bwd_work", "ssd_bwd_design_bytes", "conv_work",
               "visible_pairs"):
        assert getattr(chip_smoke, fn) is getattr(roofline, fn)


def test_visible_pairs_closed_form():
    def loop(sq, sk, o):
        return sum(max(0, min(sk, r + o + 1)) for r in range(sq))

    for sq, sk, o in ((1, 1, 0), (100, 100, 0), (1000, 777, 0),
                      (77, 300, 223), (64, 64, -3), (256, 1024, 768),
                      (5, 3, -10), (300, 40, 500)):
        assert roofline.visible_pairs(sq, sk, True, o) == loop(sq, sk, o)
    assert roofline.visible_pairs(7, 9, False, 0) == 63


def test_link_rates():
    assert roofline.link_rate(range(8)) == roofline.NVLINK_BYTES_PER_S
    assert roofline.link_rate((8, 9, 15)) == roofline.NVLINK_BYTES_PER_S
    assert roofline.link_rate(range(16)) == roofline.NETWORK_BYTES_PER_S
    assert roofline.link_rate((0, 16, 32)) == roofline.NETWORK_BYTES_PER_S
