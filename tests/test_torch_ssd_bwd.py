"""The SSD scan's gradient in the port held against the reference's on the
CPU: ``jax.vjp`` of ``repro.kernels.ref.ssd_chunked`` (the reference
trains Mamba-2 by XLA's autodiff of that function) against the port's
``mamba2_ssd_bwd_plain`` (autograd through its own ``ref.ssd_chunked``)
and ``SsdScan`` (the differentiable op ``ops.mamba2_ssd`` takes under
autograd; on a CPU tensor its forward and backward are the plain
versions), at the shapes of ``tests/test_kernels.py`` (B 2, L 32, H 4, P
8, N 8), chunks 1 to L, a ragged tile, a random initial state and a
random cotangent of the final state.  f32 at the oracle tolerance 1e-4;
bf16 by the rule ``chip_smoke.py`` holds the card's kernel to.

The CUDA kernels' own arithmetic cannot run here.  Their sums, written
out in plain PyTorch — ``chip_smoke.ssd_bwd_walk`` (one serial walk of
the tiles carrying dS, ``exp`` only where s ≤ t) and
``chip_smoke.ssd_bwd_split`` (the dS pass, then every tile on its own, as
the two kernels compute it, with the bf16 kernels' hi + lo rounding on
request) — are held against the plain backward, and at the train shape's
length they set the card's bf16 rule, show why the bf16 kernels split
their f32 operands into hi + lo, and show that the rule catches the
faults ``chip_smoke.py`` plants in the kernels' gradients and that its
hi + lo bound catches an operand in bf16 alone.
The plain gradient is NaN where ``exp`` of a masked (t, s) difference
overflows, in both packages; the kernel's formula stays finite there
(ROADMAP §C)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.core import dse
from repro_torch.kernels import mamba2_ssd as tms
from repro_torch.kernels import ops as tops

import chip_smoke
from _torch_port import to_np

ORACLE_TOL = dict(atol=1e-4, rtol=1e-4)
GRADS = chip_smoke.SSD_BWD_GRADS


def _inputs(seed, b=2, l=32, h=4, p=8, n=8, *, dt_scale=1.0):
    """The reference test's distributions (dt = softplus(N(0, 1)) times
    ``dt_scale``, a = -exp(0.3 N(0, 1)), b and c 0.5 N(0, 1)), a random
    initial state and the cotangents of y and the final state, as NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * dt_scale
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, s0, dy, ds


def _t(arrs, dtype=torch.float32):
    """x, b, c and dy in ``dtype``; dt, a and the states f32."""
    x, dt, a, bm, cm, s0, dy, ds = (torch.from_numpy(v) for v in arrs)
    return (x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype), s0,
            dy.to(dtype), ds)


def _ref_grads(arrs, chunk, dtype="float32"):
    """(dx, ddt, da, db, dc, d_init_state) of the reference: ``jax.vjp``
    of its ``ssd_chunked`` against (dy, d final state)."""
    x, dt, a, bm, cm, s0, dy, ds = arrs
    ins = (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(a),
           jnp.asarray(bm).astype(dtype), jnp.asarray(cm).astype(dtype),
           jnp.asarray(s0))
    out, vjp = jax.vjp(lambda x, dt, a, b, c, s0: jref.ssd_chunked(
        x, dt, a, b, c, chunk=chunk, init_state=s0), *ins)
    return vjp((jnp.asarray(dy).astype(out[0].dtype), jnp.asarray(ds)))


def _close(got, want, tol):
    for name, g, w in zip(GRADS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=name, **tol)


def _held_by_the_card_rule(got, want, dtype_name):
    atol = chip_smoke.SSD_BWD_TOL[dtype_name][1]
    for name, g, w in zip(GRADS, got, want):
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.array(to_np(w)))
        assert chip_smoke._ssd_need(g, w, name, dtype_name) <= atol, name


# ---------------------------------------------------------------------------
# the plain backward and SsdScan against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32])
def test_plain_backward_matches_the_reference(chunk):
    """Chunks 1 to L: the gradient is the same function whatever the
    chunk, and each equals the reference's autodiff at that chunk (NaN
    where the reference's is, at the same places)."""
    arrs = _inputs(chunk)
    got = tms.mamba2_ssd_bwd_plain(*_t(arrs), chunk=chunk)
    for g, t in zip(got, _t(arrs)):
        assert g.dtype == t.dtype
    _close(got, _ref_grads(arrs, chunk), ORACLE_TOL)


@pytest.mark.parametrize("l,chunk", [(32, 8), (37, 37), (24, 3)])
def test_ssd_scan_under_autograd_matches_the_reference(l, chunk):
    """``ops.mamba2_ssd`` under autograd goes through ``SsdScan``; the
    gradients of a loss on y and the final state equal the reference's."""
    arrs = _inputs(l, l=l)
    x, dt, a, bm, cm, s0, dy, ds = _t(arrs)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, s0)]
    y, sf = tops.mamba2_ssd(*ins[:5], init_state=ins[5], chunk=chunk)
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    torch.autograd.backward([y, sf], [dy, ds])
    _close([t.grad for t in ins], _ref_grads(arrs, chunk), ORACLE_TOL)


@pytest.mark.parametrize("chunk", [8, 32])
def test_bf16_gradients_meet_the_card_rule(chunk):
    """bf16 x, b, c and dy (dt, a and the states f32), the f32 arithmetic
    of both packages rounded to bf16 once: the port's plain backward and
    ``SsdScan`` against the reference, by ``chip_smoke.py``'s bf16 rule."""
    arrs = _inputs(100 + chunk)
    want = [torch.from_numpy(np.array(to_np(w)))
            for w in _ref_grads(arrs, chunk, "bfloat16")]
    x, dt, a, bm, cm, s0, dy, ds = _t(arrs, torch.bfloat16)
    got = tms.mamba2_ssd_bwd_plain(x, dt, a, bm, cm, s0, dy, ds,
                                   chunk=chunk)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    _held_by_the_card_rule([g.float() for g in got], want, "bfloat16")
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, s0)]
    y, sf = tms.ssd_scan(*ins, chunk=chunk)
    torch.autograd.backward([y, sf], [dy, ds])
    _held_by_the_card_rule([t.grad.float() for t in ins], want, "bfloat16")


def test_no_state_cotangent_is_zeros():
    arrs = _inputs(5)
    x, dt, a, bm, cm, s0, dy, _ = _t(arrs)
    none = tms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy, None, chunk=8)
    zeros = tms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy,
                               torch.zeros_like(s0), chunk=8)
    for name, u, v in zip(GRADS, none, zeros):
        torch.testing.assert_close(u, v, atol=0, rtol=0, msg=name)


def test_the_backward_checks_its_cotangents():
    x, dt, a, bm, cm, s0, dy, ds = _t(_inputs(6))
    with pytest.raises(ValueError, match="y_grad"):
        tms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy[:, :16], ds, chunk=8)
    with pytest.raises(ValueError, match="state_grad"):
        tms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy, ds[:, :2], chunk=8)


def test_serving_launches_the_forward_alone_without_states(monkeypatch):
    """With no gradient wanted ``ops.mamba2_ssd`` calls the forward
    wrapper once and asks for no tile states — serving's launch is
    unchanged; under autograd it asks for them and the backward runs
    once."""
    calls, bwd = [], []
    real, real_bwd = tms.mamba2_ssd, tms.mamba2_ssd_bwd

    def fwd(*a, **kw):
        calls.append(kw.get("return_states", False))
        return real(*a, **kw)

    def back(*a, **kw):
        bwd.append(kw.get("states", "missing"))
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tms, "mamba2_ssd", fwd)
    monkeypatch.setattr(tms, "mamba2_ssd_bwd", back)
    x, dt, a, bm, cm, *_ = _t(_inputs(7))
    x.requires_grad_(True)
    with torch.no_grad():
        tops.mamba2_ssd(x, dt, a, bm, cm, chunk=8)
    assert calls == [False] and bwd == []
    y, _ = tops.mamba2_ssd(x, dt, a, bm, cm, chunk=8)
    y.float().sum().backward()
    assert calls == [False, True] and bwd == [None]   # no tiles on the CPU
    assert x.grad is not None and dt.grad is None


# ---------------------------------------------------------------------------
# the kernel's formula, the card's rule and its planted faults
# ---------------------------------------------------------------------------


FORMULA_SHAPES = [(2, 32, 4, 8, 8, 32), (2, 37, 3, 8, 8, 32),
                  (1, 100, 5, 7, 20, 32), (2, 64, 2, 16, 16, 16)]


@pytest.mark.parametrize("b,l,h,p,n,tile", FORMULA_SHAPES)
def test_the_kernel_formula_equals_the_plain_backward(b, l, h, p, n, tile):
    """``chip_smoke.ssd_bwd_walk`` — the sums ``csrc/mamba2_ssd_bwd.cu``'s
    header states, as one serial walk of the tiles carrying dS — against
    autograd through ``ssd_chunked``, f32, ragged tiles and odd widths
    included."""
    arrs = _inputs(l + n, b, l, h, p, n)
    ins = _t(arrs)
    chunk = max(c for c in range(1, chip_smoke.SSD_BWD_FINITE_CHUNK + 1)
                if l % c == 0)         # short enough for a finite plain
    want = tms.mamba2_ssd_bwd_plain(*ins, chunk=chunk)
    got = chip_smoke.ssd_bwd_walk(*ins, tile=tile)
    _close(got, want, ORACLE_TOL)


@pytest.mark.parametrize("b,l,h,p,n,tile", FORMULA_SHAPES)
def test_the_split_formula_equals_the_plain_backward(b, l, h, p, n, tile):
    """``chip_smoke.ssd_bwd_split`` — the dS pass, then every tile from its
    own saved state and dS, as the two kernels compute it — against
    autograd through ``ssd_chunked``, f32, at the walk's shapes."""
    arrs = _inputs(l + n, b, l, h, p, n)
    ins = _t(arrs)
    chunk = max(c for c in range(1, chip_smoke.SSD_BWD_FINITE_CHUNK + 1)
                if l % c == 0)
    want = tms.mamba2_ssd_bwd_plain(*ins, chunk=chunk)
    got = chip_smoke.ssd_bwd_split(*ins, tile=tile)
    _close(got, want, ORACLE_TOL)


def _train_length_case(dtype):
    """The train microbatch's L 4096, P 64 and N 128 (B 1 and H 2 here,
    where the card runs B 4 and H 64), the model's call: zero initial
    state, no cotangent of the final state.  → (inputs, the formula's
    gradients rounded as the kernel's, the plain gradients)."""
    gen = torch.Generator().manual_seed(4096)
    x, dt, a, bm, cm = chip_smoke._ssd_inputs(torch, gen, 1, 4096, 2, 64,
                                               128)
    dy = torch.randn(x.shape, generator=gen)
    s0 = torch.zeros(1, 2, 64, 128)
    inputs = (x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype), s0,
              dy.to(dtype), None)
    want = tms.mamba2_ssd_bwd_plain(*inputs, chunk=16)
    got = [g.to(w.dtype) for g, w in zip(chip_smoke.ssd_bwd_walk(*inputs),
                                         want)]
    return inputs, got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernel_formula_meets_the_card_rule_at_the_train_length(dtype):
    """The kernel's arithmetic — f32 from the same inputs, summed in its
    own order, dx, db and dc rounded once to the input dtype — needs a
    tenth of the card's rule at most: the rule's margin is for the card's
    own f32 order."""
    _, got, want = _train_length_case(getattr(torch, dtype))
    rule = chip_smoke.SSD_BWD_TOL[dtype][1]
    for name, g, w in zip(GRADS, got, want):
        assert torch.isfinite(w).all(), name
        assert chip_smoke._ssd_need(g, w, name, dtype) <= 0.1 * rule, name


def _split_needs(inputs, want, dtype, **kw):
    """The share of the card's rule each gradient of
    ``chip_smoke.ssd_bwd_split(**kw)`` needs (need / atol)."""
    rule = chip_smoke.SSD_BWD_TOL[dtype][1]
    got = chip_smoke.ssd_bwd_split(*inputs, **kw)
    return {name: chip_smoke._ssd_need(g.to(w.dtype), w, name, dtype) / rule
            for name, g, w in zip(GRADS, got, want)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_split_formula_with_the_kernels_rounding_meets_the_card_rule(
        dtype):
    """The two kernels' arithmetic at the train length, rounded where each
    route rounds — bf16: every f32 operand of a tensor-core product (G,
    Gd summed over a block's heads, S, dS, exp(cum)·dy) as bf16 hi + lo;
    f32: none, the CUDA cores' f32 — needs a tenth of the unchanged rule
    at most."""
    inputs, _, want = _train_length_case(getattr(torch, dtype))
    needs = _split_needs(inputs, want, dtype, hilo=dtype == "bfloat16")
    for name, need in needs.items():
        assert need <= 0.1, (name, need)


@pytest.mark.parametrize("operand", chip_smoke.SSD_BWD_HILO)
def test_rounding_one_operand_to_bf16_alone_spends_the_rule(operand):
    """Why the bf16 kernels take each f32 operand as hi + lo: rounding
    any one of them to bf16 alone (the rest hi + lo) needs at least 0.3
    of the card's bf16 rule — three times the tenth the kernels' own
    arithmetic may spend — where hi + lo for all needs under 1/100 (at
    this seed G, Gd and exp(cum)·dy miss the rule outright)."""
    inputs, _, want = _train_length_case(torch.bfloat16)
    assert max(_split_needs(inputs, want, "bfloat16", hilo=True).values()) \
        < 0.01
    alone = _split_needs(inputs, want, "bfloat16", hilo=True,
                         bf16_alone=operand)
    assert max(alone.values()) >= 0.3, alone
    if operand in ("G", "Gd", "edy"):
        assert max(alone.values()) > 1.0, alone


def test_the_hilo_bound_catches_an_operand_in_bf16_alone():
    """``chip_smoke._ssd_hilo_check`` at the train length, with the bf16
    kernels' rounding emulated (``ssd_bwd_split`` with hi + lo) in the
    place of their gradients: that keeps within ``SSD_BWD_HILO_SHARE`` of
    the rule, each operand of ``SSD_BWD_HILO`` rounded to bf16 alone — a
    kernel that dropped that lo part — is caught, and gradients with S in
    bf16 alone are refused."""
    inputs, _, want = _train_length_case(torch.bfloat16)

    def check(**kw):
        got = [g.to(w.dtype) for g, w in
               zip(chip_smoke.ssd_bwd_split(*inputs, **kw), want)]
        needs = {name: chip_smoke._ssd_need(g, w, name, "bfloat16")
                 for name, g, w in zip(GRADS, got, want)}
        return chip_smoke._ssd_hilo_check(inputs, got, want, needs)

    report = check(hilo=True)
    assert report["share"] < 0.01 < chip_smoke.SSD_BWD_HILO_SHARE
    assert set(report["lo_dropped"]) == set(chip_smoke.SSD_BWD_HILO)
    assert min(report["lo_dropped"].values()) >= 0.3, report
    with pytest.raises(AssertionError, match="beyond"):
        check(hilo=True, bf16_alone="S")


def test_the_card_rule_catches_planted_faults():
    """``chip_smoke.py``'s planted faults — dS not carried across the
    middle tile boundary, dS carried without its decay, db without the
    state-update term, ddt without the path through cum, da zero, and
    tile k reading the pass's dS_{k−1} — each fail the bf16 rule by a
    wide margin (≥ 30 times its 1e-3)."""
    inputs, got, want = _train_length_case(torch.bfloat16)
    report = chip_smoke._ssd_planted_faults(inputs, got, want, "bfloat16")
    assert set(report) == set(chip_smoke.SSD_BWD_FAULTS)
    for fault, r in report.items():
        assert r["caught"] and max(r["need"].values()) >= 3e-2, fault


def test_the_reference_gradient_is_nan_where_the_kernel_formula_is_finite():
    """``ssd_chunked`` takes ``exp`` of every (t, s) difference of a chunk
    and masks the upper triangle afterwards: where a difference passes
    ≈ 88 the masked exp is inf and its gradient 0·inf = NaN, in the
    reference and in the port's plain version alike (dt and a only: the
    other inputs reach it through the mask's zero).  The kernel takes
    ``exp`` only where s ≤ t: its formula stays finite and equals the
    plain gradient at a chunk short enough to stay finite."""
    arrs = _inputs(9, l=64, dt_scale=4.0)
    ref = _ref_grads(arrs, 64)
    assert np.isnan(to_np(ref[1])).any() and np.isnan(to_np(ref[2])).any()
    ins = _t(arrs)
    plain = tms.mamba2_ssd_bwd_plain(*ins, chunk=64)
    assert torch.isnan(plain[1]).any() and torch.isnan(plain[2]).any()
    _close(plain, ref, ORACLE_TOL)             # NaN at the same places
    walk = chip_smoke.ssd_bwd_walk(*ins)
    assert all(torch.isfinite(g).all() for g in walk)
    _close(walk, tms.mamba2_ssd_bwd_plain(*ins, chunk=8), ORACLE_TOL)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def test_a_forward_that_saves_states_takes_the_backward_tile():
    kw = dict(batch=4, length=4096, heads=64, head_dim=64, state_dim=128)
    serve = dse.plan_ssd_blocks(dtype="bfloat16", **kw)
    train = dse.plan_ssd_blocks(dtype="bfloat16", save_states=True, **kw)
    assert serve.blocks["block_l"] == dse.SSD_MMA_WIDE[0]
    assert train.blocks["block_l"] == dse.SSD_BWD_BLOCK_L == 32
    assert dse.plan_ssd_blocks(dtype="float32", save_states=True,
                               **kw).blocks["block_l"] == 32
    bwd = dse.plan_ssd_bwd_blocks(dtype="bfloat16", **kw)
    assert bwd.blocks == {"route": "mma", "block_l": 32,
                          "heads_per_block": 16}
    assert bwd.grids == {"pass": (4 * 64, 1), "tile": (4, 128, 4)}
    # two tile blocks an SM at the widest head and state (each block holds
    # 1 KB of the SM's 228 KB besides)
    assert 2 * (bwd.smem_bytes["tile"] + 1024) <= 228 * 1024


def test_the_backward_planner_raises_where_the_forward_does():
    for kw, match in ((dict(head_dim=65, state_dim=8), "head_dim"),
                      (dict(head_dim=8, state_dim=129), "state_dim"),
                      (dict(head_dim=0, state_dim=8), "empty")):
        with pytest.raises(ValueError, match=match):
            dse.plan_ssd_bwd_blocks(batch=1, length=8, heads=1,
                                    dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="no route"):
        dse.plan_ssd_bwd_blocks(batch=1, length=8, heads=1, head_dim=8,
                                state_dim=8, dtype="float16")


def test_the_backward_planner_names_both_grids():
    """Both routes: the dS pass per (batch row, head) — f32: per (batch
    row, head, 16 rows of P) — the tile kernel per (batch row, tile, 16
    heads), a ragged last tile and a ragged last group of heads counted
    in."""
    kw = dict(batch=3, length=100, heads=20, head_dim=17, state_dim=20)
    for dtype, route, rows in (("bfloat16", "mma", 1),
                               ("float32", "cuda_core", 2)):
        plan = dse.plan_ssd_bwd_blocks(dtype=dtype, **kw)
        assert plan.blocks["route"] == route
        assert plan.grids == {"pass": (60, rows), "tile": (3, 4, 2)}
        assert plan.smem_bytes == dse.ssd_bwd_smem_bytes(
            head_dim=17, state_dim=20, dtype=dtype)


def _expr(src, start):
    """The expression from ``start`` to the next ``;``, whitespace cut."""
    return " ".join(src[src.index(start):].split(";")[0].split())


def test_the_backward_smem_formula_is_the_kernels():
    """``dse.ssd_bwd_smem_bytes`` is each launch's formula in
    ``csrc/mamba2_ssd_bwd.cu`` — bf16: the pass's static tiles and the tile
    kernel's ``TileSmem``; f32: the pass's static tiles and the tile
    kernel's launch formula — and the kernels take exactly the planner's
    tile, pass rows and heads a tile block, and launch the planner's
    grids."""
    src = tms.BWD_LIBRARY.source.read_text()
    assert "constexpr int BQ = %d;" % dse.SSD_BWD_BLOCK_L in src
    assert "constexpr int PASS_ROWS = %d;" % dse.SSD_BWD_PASS_ROWS in src
    assert "constexpr int HB = %d;" % dse.SSD_BWD_HEADS_PER_BLOCK in src
    assert "p.ntiles = tile_k;" in src and "p.groups = tile_g;" in src
    assert "mamba2_ssd_bwd_pass_kernel<<<(unsigned)pass_x," in src
    assert "const dim3 pass_grid((unsigned)pass_x, (unsigned)pass_y);" in src
    assert _expr(src, "const long long tile_blocks =") == (
        "const long long tile_blocks = (long long)tile_b * tile_k * tile_g")
    assert "constexpr int PASS_STAGES = 2;" in src
    assert _expr(src, "constexpr int PASS_SMEM =") == (
        "constexpr int PASS_SMEM = PASS_STAGES * (2 * BQ * CPITCH + "
        "2 * BQ * XPITCH + 4 * BQ)")
    assert "uint16_t cs0[PASS_STAGES * BQ * CPITCH];" in src
    assert "uint16_t dys0[PASS_STAGES * BQ * XPITCH];" in src
    assert "float dts0[PASS_STAGES * BQ];" in src
    assert _expr(src, "static constexpr int BYTES =") == (
        "static constexpr int BYTES = 2 * (2 * CB + 2 * XT + 4 * ST + 2 * GT)"
        " + 4 * (19 * BQ + 8 + 2)")
    assert "__shared__ float cs[BQ * MAX_N];" in src
    assert "__shared__ float dys[BQ * PASS_ROWS];" in src
    assert _expr(src, "const size_t smem =") == (
        "const size_t smem = 4 * (2 * (size_t)BQ * p.NP + "
        "2 * (size_t)BQ * p.XP + 2 * (size_t)p.P * p.NP + "
        "3 * (size_t)BQ * GP + 6 * BQ + 8)")
    cp, xp, gp = 128 + 8, 64 + 8, 32 + 8
    assert dse.ssd_bwd_smem_bytes(head_dim=16, state_dim=16,
                                  dtype="bfloat16") == {
        "pass": 2 * (2 * 32 * cp + 2 * 32 * xp + 4 * 32),
        "tile": 2 * (2 * 32 * cp + 2 * 32 * xp + 4 * 64 * cp + 2 * 32 * gp)
        + 4 * (19 * 32 + 10)}
    assert dse.ssd_bwd_smem_bytes(head_dim=64, state_dim=128,
                                  dtype="float32") == {
        "pass": 4 * (32 * 128 + 32 * 16),
        "tile": 4 * (2 * 32 * 129 + 2 * 32 * 65 + 2 * 64 * 129
                     + 3 * 32 * 33 + 6 * 32 + 8)}
    assert dse.ssd_bwd_smem_bytes(head_dim=16, state_dim=16,
                                  dtype="float32") == \
        dse.ssd_bwd_smem_bytes(head_dim=16, state_dim=17,
                               dtype="float32")   # odd pitch


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (the full sweep is
    ``chip_smoke.py``'s ``ssd_bwd_check``): a ragged L, x, b and c as
    strided slices, a random initial state and state cotangent; two runs
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tdt = getattr(torch, dtype)
    x, dt, a, bm, cm, s0, dy, ds = (t.cuda() for t in _t(
        _inputs(3, b=2, l=100, h=3, p=16, n=32), tdt))
    proj = torch.cat([x.reshape(2, 100, 48), bm, cm], -1)
    xs, bs, cs = proj[..., :48].reshape(2, 100, 3, 16), proj[..., 48:80], \
        proj[..., 80:]
    _, _, states = tms.mamba2_ssd(xs, dt, a, bs, cs, s0, chunk=4,
                                  return_states=True)
    run = lambda: tms.mamba2_ssd_bwd(xs, dt, a, bs, cs, s0, dy, ds,
                                     chunk=4, states=states)
    got, again = run(), run()
    want = tms.mamba2_ssd_bwd_plain(xs, dt, a, bs, cs, s0, dy, ds, chunk=4)
    for name, g, h, w in zip(GRADS, got, again, want):
        assert torch.equal(g, h), name
        assert chip_smoke._ssd_need(g, w, name, dtype) <= \
            chip_smoke.SSD_BWD_TOL[dtype][1], name
