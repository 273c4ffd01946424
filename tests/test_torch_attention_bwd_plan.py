"""The attention backward's planner (``dse.plan_attn_bwd_blocks``) on the
CPU: the route each config's train shape takes, what TMA cannot read
falling back to ``"mma"``, the grids and their heaviest-first order, the
shared memory, and the kernels' own constants and alignment test held
equal to the planner's.  The kernels themselves run only on the card
(``chip_smoke.py``'s ``attn_bwd_check``)."""
import re

import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.configs.seamless_m4t_medium import DEC_TRAIN_FRAC
from repro_torch.core import dse
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa

SEQ = SHAPES["train_4k"].seq_len
DEC_TRAIN_LEN = SEQ // DEC_TRAIN_FRAC   # the encoder-decoder's targets
BATCH = 4                       # a microbatch of chip_smoke's train steps


def _attention_shapes(arch):
    """(Hq, Hkv, Sq, Sk, D, causal) of each attention of ``arch``'s train
    step at ``train_4k``: self-attention, and for the encoder-decoder its
    encoder, decoder and cross attention."""
    cfg = get_config(arch)
    if cfg.num_heads == 0:
        return []
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "encdec":
        return [(h, kv, SEQ, SEQ, d, False),
                (h, kv, DEC_TRAIN_LEN, DEC_TRAIN_LEN, d, True),
                (h, kv, DEC_TRAIN_LEN, SEQ, d, False)]
    return [(h, kv, SEQ, SEQ, d, True)]


def _plan(hq, hkv, sq, sk, d, dtype="bfloat16", aligned=True, batch=BATCH):
    return dse.plan_attn_bwd_blocks(
        batch_heads_q=batch * hq, heads_q=hq, heads_kv=hkv, seq_q=sq,
        seq_k=sk, head_dim=d, dtype=dtype, aligned=aligned)


@pytest.mark.parametrize("arch", all_archs())
def test_every_configs_train_shape_takes_wgmma(arch):
    """Every config's attention at its train shape has a head of 64 or
    128, and bf16 takes ``"wgmma"`` there; f32 the CUDA cores."""
    shapes = _attention_shapes(arch)
    if get_config(arch).family == "ssm":
        assert shapes == []
    for hq, hkv, sq, sk, d, _ in shapes:
        assert d in dse.ATTN_BWD_WG_HEADS
        assert _plan(hq, hkv, sq, sk, d).route == "wgmma"
        assert _plan(hq, hkv, sq, sk, d, "float32").route == "cuda_core"


@pytest.mark.parametrize("d,aligned", [(16, True), (32, True), (40, True),
                                       (100, True), (64, False),
                                       (128, False)])
def test_what_tma_cannot_read_plans_mma(d, aligned):
    """A head other than 64 or 128, or a base off 16 bytes, takes the
    ``"mma"`` route with its 64 × 64 tiles; f32 stays on the CUDA cores."""
    plan = _plan(8, 2, 1000, 777, d, aligned=aligned)
    assert plan.route == "mma"
    assert plan.tiles == {"dkdv": (64, 64), "dq": (64, 64)}
    assert plan.smem_bytes == dse.attn_bwd_smem_bytes(route="mma",
                                                      head_dim=d)
    assert _plan(8, 2, 1000, 777, d, "float32",
                 aligned=aligned).route == "cuda_core"


def _tile_of(route, kernel, block, heads, n):
    """(batch·head, tile) of block ``block`` of ``kernel`` over ``heads``
    heads of ``n`` tiles: the kernels' index arithmetic, which
    ``test_the_kernels_block_order_is_this`` reads in their source."""
    if route == "wgmma":
        head, t = block % heads, block // heads
    else:
        head, t = block // n, block % n
    return head, (t if kernel == "dkdv" else n - 1 - t)


@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 128),
                                     ("bfloat16", 40), ("float32", 64)])
@pytest.mark.parametrize("sq,sk", [(4096, 4096), (100, 100), (77, 300)])
def test_grids_are_the_ceil_arithmetic_heaviest_first(dtype, d, sq, sk):
    """Each grid is its tiles' ceiling over the lengths times the heads;
    every (head, tile) comes once; and, causal, the first blocks of each
    kernel hold its heaviest tiles — key tile 0 (seen by every query tile)
    and the last query tile (seeing every key) — on ``"wgmma"`` of every
    head at once, on the other routes of each head first."""
    hq, hkv = 32, 8
    plan = _plan(hq, hkv, sq, sk, d, dtype)
    bhq, bhkv = BATCH * hq, BATCH * hkv
    (kb, _), (qb, _) = plan.tiles["dkdv"], plan.tiles["dq"]
    assert plan.grids == {"delta": -(-bhq * sq // 8),
                          "dkdv": bhkv * -(-sk // kb),
                          "dq": bhq * -(-sq // qb)}
    for kernel, heads, n in (("dkdv", bhkv, -(-sk // kb)),
                             ("dq", bhq, -(-sq // qb))):
        tiles = [_tile_of(plan.route, kernel, i, heads, n)
                 for i in range(plan.grids[kernel])]
        assert sorted(tiles) == [(h, t) for h in range(heads)
                                 for t in range(n)]
        heaviest = 0 if kernel == "dkdv" else n - 1
        if plan.route == "wgmma":
            assert tiles[:heads] == [(h, heaviest) for h in range(heads)]
            # blocks run tile major, lightest tiles last
            work = [t if kernel == "dq" else n - 1 - t for _, t in tiles]
            assert work == sorted(work, reverse=True)
        else:
            assert tiles[0] == (0, heaviest)
            assert [t for h, t in tiles if h == 0] == (
                list(range(n)) if kernel == "dkdv"
                else list(range(n - 1, -1, -1)))


@pytest.mark.parametrize("route", ["wgmma", "mma", "cuda_core"])
@pytest.mark.parametrize("d", [16, 40, 64, 128])
def test_shared_memory_fits_one_block(route, d):
    if route == "wgmma" and d not in dse.ATTN_BWD_WG_HEADS:
        return
    smem = dse.attn_bwd_smem_bytes(route=route, head_dim=d)
    assert set(smem) == {"dkdv", "dq"}
    assert all(0 < v <= 232_448 for v in smem.values())
    assert dse.H100.smem_per_block == 232_448


def test_the_wgmma_smem_is_the_formula():
    """At a head of 64: K and V of 128 keys (32 KB) and 4 slots of a Q and
    a dO tile of 64 rows with their lse and delta; the dQ kernel's Q and dO
    of 128 rows and 4 slots of a K and a V tile of 64 keys; each plus 1024
    bytes of alignment."""
    assert dse.attn_bwd_smem_bytes(route="wgmma", head_dim=64) == {
        "dkdv": 2 * 128 * 128 + 4 * (2 * 64 * 128 + 512) + 1024,
        "dq": 2 * 128 * 128 + 4 * 2 * 64 * 128 + 1024}
    assert dse.attn_bwd_smem_bytes(route="wgmma", head_dim=128) == {
        "dkdv": 2 * 128 * 256 + 4 * (2 * 64 * 256 + 512) + 1024,
        "dq": 2 * 128 * 256 + 4 * 2 * 64 * 256 + 1024}


@pytest.mark.parametrize("kw,match", [
    (dict(dtype="float16"), "no route"),
    (dict(dtype="int8"), "no route"),
    (dict(d=129), "head_dim"),
    (dict(d=0), "head_dim"),
    (dict(sq=0), "empty"),
    (dict(hkv=5), "whole groups"),
])
def test_what_has_no_route_raises(kw, match):
    args = dict(hq=12, hkv=4, sq=64, sk=64, d=64, dtype="bfloat16")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        _plan(**args)


# ---------------------------------------------------------------------------
# the kernels' constants and the launcher's test, held to the planner's
# ---------------------------------------------------------------------------


def _cu_source() -> str:
    return (build.CSRC / "flash_attention_bwd.cu").read_text()


def _cu_constant(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", _cu_source()).group(1))


def test_the_kernels_tiles_are_the_planners():
    """Every tile, slot and thread constant of the three routes is the
    planner's, the wgmma kernels' shared memory is the formula of
    ``dse.attn_bwd_smem_bytes``, and the card's planted faults tile keys
    as the planner does."""
    import chip_smoke

    assert (_cu_constant("WG_KEYS"), _cu_constant("WG_QSTEP")) == \
        dse.ATTN_BWD_WG_TILES["dkdv"]
    assert (_cu_constant("WG_ROWS"), _cu_constant("WG_KSTEP")) == \
        dse.ATTN_BWD_WG_TILES["dq"]
    assert _cu_constant("WG_STAGES") == dse.ATTN_BWD_WG_STAGES
    assert _cu_constant("WG_THREADS") == dse.ATTN_BWD_WG_THREADS
    assert _cu_constant("THREADS") == dse.ATTN_BWD_THREADS
    assert _cu_constant("MMA_THREADS") == dse.ATTN_BWD_MMA_THREADS
    assert _cu_constant("BQ") == _cu_constant("BK") == dse.ATTN_BWD_TILE
    assert (chip_smoke.ATTN_BWD_KEY_TILE, chip_smoke.ATTN_BWD_Q_STEP) == \
        dse.ATTN_BWD_WG_TILES["dkdv"]
    src = " ".join(_cu_source().split())
    assert ("return (size_t)2 * WG_KEYS * dh * 2 + (size_t)WG_STAGES * "
            "(2 * WG_QSTEP * dh * 2 + 2 * WG_QSTEP * 4) + 1024;") in src
    assert ("return (size_t)2 * WG_ROWS * dh * 2 + (size_t)WG_STAGES * 2 * "
            "WG_KSTEP * dh * 2 + 1024;") in src
    assert "constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;" in src
    assert 128 * 24 + 2 * 128 * 240 <= 65536


def test_the_kernels_block_order_is_this():
    """The block index arithmetic ``_tile_of`` models, as each kernel
    writes it: ``"wgmma"`` tile major (dK/dV key tile = block / B·Hkv, dQ
    the query tiles from the last), the other routes head major."""
    src = " ".join(_cu_source().split())
    for line in (
            # "wgmma"
            "const int kt = (int)blockIdx.x / p.bhkv; "
            "const int bkv = (int)blockIdx.x - kt * p.bhkv; "
            "const int k0 = kt * WG_KEYS;",
            "const int t = (int)blockIdx.x / p.bhq; "
            "const int bh = (int)blockIdx.x - t * p.bhq; "
            "const int q0 = (n_qb - 1 - t) * WG_ROWS;",
            # "mma" and "cuda_core"
            "const int bkv = blockIdx.x / p.n_kt; "
            "const int k0 = (blockIdx.x - bkv * p.n_kt) * BK;",
            "const int bh = blockIdx.x / p.n_qt; // the heaviest causal tiles "
            "(last query rows) start first const int q0 = (p.n_qt - 1 - "
            "(blockIdx.x - bh * p.n_qt)) * BQ;"):
        assert line in src, line


def test_the_launchers_route_test_is_the_planners():
    """The launcher takes the wgmma route only where its own test holds —
    a head of 64 or 128, every base 16-byte aligned — refuses the route
    elsewhere rather than take another, and the wrapper hands the planner
    the bases' alignment and the launcher the planner's route."""
    src = " ".join(_cu_source().split())
    assert dse.ATTN_BWD_WG_HEADS == (64, 128)
    assert ("const bool tma_ok = (D == 64 || D == 128) && (bases & 15) == 0;"
            in src)
    assert "if (route == 2) { if (!tma_ok) return (int)cudaErrorInvalidValue;" \
        in src
    assert "(dtype == 0 ? route != 0 : route != 1 && route != 2))" in src
    for name in ("q", "k", "v", "dout", "dq", "dk", "dv"):
        assert f"reinterpret_cast<uintptr_t>({name})" in src, name
    assert tfa.BWD_ROUTE_CODES == {"cuda_core": 0, "mma": 1, "wgmma": 2}
    # the wrapper's alignment on tensors: one bf16 element off is 2 bytes
    q = torch.zeros(8, 100, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(2, 100, 64, dtype=torch.bfloat16)
    kw = dict(heads_q=4, heads_kv=1)
    assert tfa.bwd_plan(q, k, v, q, **kw).route == "wgmma"
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    off = buf[1:].view(q.shape)
    assert off.data_ptr() % 16 == 2 or off.data_ptr() % 16 != 0
    assert tfa.bwd_plan(off, k, v, q, **kw).route == "mma"
    assert tfa.bwd_plan(q, k, v, off, **kw).route == "mma"
    assert tfa.bwd_plan(*(t.float() for t in (q, k, v, q)),
                        **kw).route == "cuda_core"
