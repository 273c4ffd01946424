"""The yardstick: the frozen copy of the kernels' work agrees with the
port's ``kernels/work.py`` at the cells' shapes (but for the SSD tile
states the copy leaves out), and the roofline and ``mfu`` arithmetic
agrees with counts worked out by hand."""
import pytest
import torch

from perfbench.lib import cells, flops, trace
from perfbench.lib import work as W

BF16 = torch.bfloat16


def _cfg(name):
    return cells.load_cell(name).config


def test_frozen_work_matches_the_port_at_the_cells_shapes():
    from repro_torch.kernels import work as port

    g, m = _cfg("granite-moe-1b-a400m.train_8x4096"), \
        _cfg("mamba2-1.3b.train_8x4096")
    for b, s in ((4, 4096), (16, 512), (16, 1024), (16, 2048), (16, 4096)):
        args = (b, g["num_heads"], g["num_kv_heads"], s, s, g["head_dim"],
                True, 0, BF16)
        assert W.attention_work(*args) .__dict__ == \
            port.attention_work(*args).__dict__
        assert W.attention_work(*args, lse=True).__dict__ == \
            port.attention_work(*args, lse=True).__dict__
        assert W.attention_bwd_work(*args).__dict__ == \
            port.attention_bwd_work(*args).__dict__
        h = m["ssm"]["expand"] * m["d_model"] // m["ssm"]["head_dim"]
        sargs = (b, s, h, m["ssm"]["head_dim"], m["ssm"]["state_dim"], BF16)
        assert W.ssd_work(*sargs).__dict__ == port.ssd_work(*sargs).__dict__
        with_states = port.ssd_work(*sargs, states=True)
        tiles = -(-s // W.SSD_WORK_TILE)
        left_out = b * h * m["ssm"]["head_dim"] * m["ssm"]["state_dim"] * 4
        assert with_states.bytes - W.ssd_work(*sargs).bytes == \
            left_out * tiles
        for grad in (False, True):
            assert W.ssd_bwd_work(*sargs, state_grad=grad).__dict__ == \
                port.ssd_bwd_work(*sargs, state_grad=grad).__dict__
    assert (W.HBM_BYTES_PER_S, W.TENSOR_CORE_BF16_OPS_PER_S,
            W.CUDA_CORE_OPS_PER_S, W.SSD_WORK_TILE) == (
        port.HBM_BYTES_PER_S, port.TENSOR_CORE_BF16_OPS_PER_S,
        port.CUDA_CORE_OPS_PER_S, port.SSD_WORK_TILE)


def test_attention_roofline_by_hand():
    cfg = _cfg("granite-moe-1b-a400m.train_8x4096")
    # one forward call on 4 rows of 4096: 16 heads · (4096·4097/2) pairs ·
    # 4 · 64 operations
    pairs = 4096 * 4097 // 2
    ops = 4 * 64 * 16 * pairs * 4
    least = ops / 989e12
    s = trace.Summary(window_s=1.0, busy_s=1.0,
                      by_name={"flash_attention_mma_kernel<64>": 4 * least,
                               "nvjet_x": 0.5, "elementwise": 0.25},
                      units=[trace.Unit("train", 8, 4096, 4,
                                        {"attn_fwd": 2})],
                      idle_gaps=[])
    share, by = flops.roofline(s, cfg, "attn_fwd", "train")
    assert by == "operations" and share == pytest.approx(50.0)
    assert flops.roofline(s, cfg, "attn_fwd", "prefill") is None
    assert flops.roofline(s, cfg, "attn_bwd", "train") is None
    assert trace.glue_share(s, "train") == pytest.approx(
        100 * 0.25 / (4 * least + 0.75))


def test_ssd_roofline_is_bound_by_bytes_and_ignores_tiles():
    cfg = _cfg("mamba2-1.3b.train_8x4096")
    b, l, h, p, n = 16, 1024, 64, 64, 128
    xs, bc = b * l * h * p * 2, b * l * n * 2
    state = b * h * p * n * 4
    nbytes = 2 * xs + 2 * bc + b * l * h * 4 + h * 4 + 2 * state
    w = flops.kernel_work(cfg, "ssd_fwd", b, l)
    assert w.bytes == nbytes and w.bound_by() == "bytes"
    s = trace.Summary(1.0, 1.0, {"mamba2_ssd_mma_kernel": 48 * nbytes
                                 / 3.35e12 * 4}, [trace.Unit(
                                     "prefill", b, l, b, {"ssd_fwd": 48})],
                      [])
    assert flops.roofline(s, cfg, "ssd_fwd", "prefill")[0] == \
        pytest.approx(25.0)


def test_mfu_by_hand():
    g = _cfg("granite-moe-1b-a400m.train_8x4096")
    # a layer: attention 1024·(16+16)·64 + 1024·1024 weights, router
    # 1024·32, 8 experts of 3·1024·512
    per_token = 1024 * 32 * 64 + 1024 * 1024 + 1024 * 32 + 8 * 3 * 1024 * 512
    attn = 4 * 64 * 16 * (4096 * 4097 // 2) * 8
    body = (2 * per_token * 8 * 4096 + attn) * 24
    head = 2 * 1024 * 49155
    train = 3 * (body + head * 8 * 4096)
    assert flops.model_flops(g, "train", 8, 4096) == train
    s = trace.Summary(2.0, 1.9, {}, [trace.Unit("train", 8, 4096, 4)], [])
    assert flops.mfu(s, g, "train") == pytest.approx(
        100 * train / (2.0 * 989e12))
    m = _cfg("mamba2-1.3b.train_8x4096")
    # a layer: in_proj 2048·(4096 + 4352 + 64), conv 4·4352, out_proj
    # 4096·2048; the SSD 4·64·128 a head and position, 64 heads
    per_token = 2048 * 8512 + 4 * 4352 + 4096 * 2048
    ssd = 4 * 64 * 128 * 64
    prefill = (2 * per_token + ssd) * 16 * 512 * 48 + 2 * 2048 * 50277 * 16
    assert flops.model_flops(m, "prefill", 16, 512) == prefill
    idle = trace.Summary(2.0, 1.5, {}, [trace.Unit("prefill", 16, 512, 16)],
                         [])
    assert trace.idle_share(idle, "prefill") == pytest.approx(25.0)
    assert trace.idle_share(idle, "train") is None


def test_trace_reduction_unions_overlaps_and_names_gaps():
    ev = [("user_annotation", "perfbench.unit.0", 0.0, 10.0),
          ("kernel", "a", 1.0, 4.0), ("kernel", "b", 3.0, 5.0),
          ("kernel", "a", 8.0, 12.0), ("gpu_memcpy", "copy", -1.0, 0.5),
          ("cpu_op", "aten::mm", 5.5, 6.0), ("cpu_op", "aten::sum", 4.5, 7.5),
          ("cpu_op", "aten::item", 0.2, 0.9)]
    s = trace.summarize(ev, [trace.Unit("train", 1, 1, 1)])
    assert s.window_s == 10.0
    # [0, 0.5] (the copy, clipped to the window), [1, 5] and [8, 10]
    assert s.busy_s == pytest.approx(0.5 + 4.0 + 2.0)
    assert s.by_name == pytest.approx({"a": 5.0, "b": 2.0, "copy": 0.5})
    assert s.idle_gaps[0] == ["aten::sum", pytest.approx(3.0)]
    assert s.idle_gaps[1][0] == "aten::item"
