"""The JAX-free compile stack, copied into the port, proved identical:
same DFG after the default pipeline node for node, same groups / spills
/ weight tiles / modeled cycles, BRAM and DSP, same emitted HLS text —
against the reference package and against ``tests/golden``."""
import dataclasses
import os

import pytest

import repro.api as japi
import repro.core.cnn_graphs as jgraphs
import repro.instrument as jinstr
import repro.passes as jpasses
from repro.core.emit_hls import emit_design as jemit
from repro.core.emit_hls import emit_partitioned as jemit_part

import repro_torch.api as tapi
import repro_torch.core.cnn_graphs as tgraphs
import repro_torch.instrument as tinstr
import repro_torch.passes as tpasses
from repro_torch.core import dse as tdse
from repro_torch.core import resource_model as trm
from repro_torch.core.emit_hls import emit_design as temit
from repro_torch.core.emit_hls import emit_partitioned as temit_part

from _torch_port import TARGETS, compiled_pair, strip_telemetry

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

#: every suite graph that compiles quickly, plus the partition showcase
GRAPHS = sorted(
    n for n in japi.suite() if "224" not in n
) + ["deep_cascade_224"]


def test_suites_name_the_same_graphs():
    assert sorted(japi.suite()) == sorted(tapi.suite())


@pytest.mark.parametrize("name", GRAPHS)
def test_pipeline_dfg_equal_node_for_node(name):
    jd = jpasses.run_default_pipeline(japi.suite()[name]()).dfg
    td = tpasses.run_default_pipeline(tapi.suite()[name]()).dfg
    assert jinstr.snapshot_dfg(jd) == tinstr.snapshot_dfg(td)
    assert [op.name for op in jd.topo_order()] == [
        op.name for op in td.topo_order()]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", GRAPHS)
class TestCompileDesign:
    def test_schedule_equal(self, name, target):
        ja, ta = compiled_pair(name, target)
        jd, td = ja.design, ta.design
        assert len(jd.groups) == len(td.groups)
        for jg, tg in zip(jd.groups, td.groups):
            assert jg.name == tg.name
            assert list(jg.node_names) == list(tg.node_names)
            assert list(jg.spill_in) == list(tg.spill_in)
            assert list(jg.spill_out) == list(tg.spill_out)
            assert dict(jg.dse.weight_tiles) == dict(tg.dse.weight_tiles)
            assert dict(jg.dse.unrolls) == dict(tg.dse.unrolls)
            assert (jg.cycles, jg.bram, jg.dsp) == (tg.cycles, tg.bram, tg.dsp)
        assert [dataclasses.astuple(s) for s in jd.spills()] == [
            dataclasses.astuple(s) for s in td.spills()]
        assert jd.total_cycles == td.total_cycles
        assert jd.boundary_traffic() == td.boundary_traffic()
        assert jinstr.snapshot_dfg(jd.source) == tinstr.snapshot_dfg(td.source)

    def test_report_equal(self, name, target):
        ja, ta = compiled_pair(name, target)
        assert strip_telemetry(ja.report()) == strip_telemetry(ta.report())

    def test_hls_text_equal(self, name, target):
        ja, ta = compiled_pair(name, target)
        jf, tf = jemit(ja.design), temit(ta.design)
        assert list(jf) == list(tf)
        for fname in jf:
            assert jf[fname] == tf[fname], fname

    def test_diagnostics_equal(self, name, target):
        ja, ta = compiled_pair(name, target)
        assert [d.to_json() for d in ja.diagnostics] == [
            d.to_json() for d in ta.diagnostics]


class TestGolden:
    """The port's emitter reproduces ``tests/golden/*.cpp`` byte for
    byte (the scenarios of the reference's own golden tests)."""

    @staticmethod
    def _golden(name):
        with open(os.path.join(GOLDEN_DIR, name)) as f:
            return f.read()

    @pytest.mark.parametrize("fname", [
        "cascade_conv_16_g0.cpp", "cascade_conv_16_g1.cpp",
        "host_schedule.cpp"])
    def test_forced_partition(self, fname):
        fused = tpasses.run_default_pipeline(
            tgraphs.cascade_conv(16, c_mid=8)).dfg
        pp = tpasses.partition_layer_groups(fused, b_total=2)
        assert pp.partitioned
        assert temit_part(pp)[fname] == self._golden(f"cascade16_{fname}")

    def test_weight_streamed(self):
        from repro_torch.core.compile_driver import compile_design

        d = compile_design(tgraphs.fat_conv())
        assert temit(d)["fat_conv_16_g0.cpp"] == self._golden(
            "fat_conv_16_g0.cpp")

    def test_zu3eg_resident(self):
        from repro_torch.core.compile_driver import ZU3EG, compile_design

        d = compile_design(tgraphs.fat_conv(), ZU3EG)
        assert not d.weight_streamed and len(d.groups) == 1
        assert temit_part(d)["fat_conv_16_g0.cpp"] == self._golden(
            "fat_conv_16_zu3eg_g0.cpp")

    def test_reference_emits_the_same_partition(self):
        fused = jpasses.run_default_pipeline(
            jgraphs.cascade_conv(16, c_mid=8)).dfg
        jf = jemit_part(jpasses.partition_layer_groups(fused, b_total=2))
        fused_t = tpasses.run_default_pipeline(
            tgraphs.cascade_conv(16, c_mid=8)).dfg
        tf = temit_part(tpasses.partition_layer_groups(fused_t, b_total=2))
        assert jf == tf


class TestDeviceDescription:
    """The FPGA model is untouched; the device half states an H100's
    data-sheet numbers and the planner returns tiles that fit."""

    def test_fpga_constants_unchanged(self):
        import repro.core.resource_model as jrm

        for k in ("KV260_BRAM18K", "KV260_DSP", "DRAM_BURST_BYTES",
                  "DRAM_BYTES_PER_CYCLE"):
            assert getattr(jrm, k) == getattr(trm, k)
        for w, r in ((0, 0), (4096, 0), (100_000, 7), (123, 456_789)):
            assert jrm.transition_cycles(w, r) == trm.transition_cycles(w, r)

    def test_hopper_spec_is_the_data_sheet(self):
        s = trm.H100
        assert s.sms == 132
        assert s.smem_per_block == 227 * 1024
        assert s.l2_bytes == 50_000_000
        assert s.hbm_bytes == 80_000_000_000
        assert s.hbm_bw == 3.35e12
        assert not hasattr(trm, "TpuSpec") and not hasattr(tdse, "plan_matmul_blocks")

    @pytest.mark.parametrize("shape", [
        dict(h_out=32, w_out=32, c_in=1, c_out=6, kh=5, kw=5, batch=32),
        dict(h_out=32, w_out=32, c_in=16, c_out=16, kh=3, kw=3),
        dict(h_out=8, w_out=8, c_in=8, c_out=16, kh=3, kw=3, stride=2, batch=32),
        dict(h_out=224, w_out=224, c_in=136, c_out=136, kh=3, kw=3),
        dict(h_out=16, w_out=16, c_in=288, c_out=288, kh=3, kw=3),
        dict(h_out=1, w_out=32, c_in=4096, c_out=10, kh=1, kw=1),
        dict(h_out=9, w_out=13, c_in=3, c_out=5, kh=5, kw=5, stride=3, rows=2),
    ], ids=lambda d: "x".join(str(v) for v in d.values()))
    def test_plan_conv_rows_is_legal(self, shape):
        plan = tdse.plan_conv_rows(**shape)
        b = plan.blocks
        tp, tc = b["tile_pixels"], b["tile_channels"]
        assert (tp, tc) in tdse.CONV_TILES
        assert b["w_tile"] % tp == 0
        assert b["c_tile"] % tc == 0
        # one register tile per thread per step; only a resident block
        # whose launch is one wave carries more threads (they only load)
        tiles = b["rows_step"] * (b["w_tile"] // tp) * (b["c_tile"] // tc)
        assert tiles <= b["threads"] <= tdse.CONV_BLOCK_THREADS
        gx, gy, gz = plan.grid
        full = b["threads"] > tiles
        assert not full or (not b["streamed"]
                            and b["threads"] == tdse.CONV_BLOCK_THREADS
                            and gx * gy * gz <= trm.H100.sms)
        assert 1 <= b["rows_step"] <= b["rows"]
        if "rows" in shape:
            assert b["rows"] == shape["rows"]
        else:
            assert b["rows"] % b["rows_step"] == 0
        assert plan.smem_bytes <= trm.H100.smem_per_block
        assert plan.smem_bytes == tdse.conv_smem_bytes(
            kh=shape["kh"], kw=shape["kw"], c_in=shape["c_in"],
            stride=shape.get("stride", 1), rows_step=b["rows_step"],
            w_tile=b["w_tile"], c_tile=b["c_tile"], streamed=b["streamed"],
            stage_chunks=b["stage_chunks"])
        assert b["stage_chunks"] in tdse.CONV_STAGE_CHUNKS
        assert b["streamed"] or b["stage_chunks"] == 1
        if not b["streamed"] and not full:  # room for a second block
            assert plan.smem_bytes <= tdse.CONV_TWO_BLOCKS_SMEM
        assert gy * b["rows"] >= shape["h_out"]
        assert gz == shape.get("batch", 1)
        assert plan.smem_fill_bytes > 0

    def test_plan_conv_rows_raises_when_nothing_fits(self):
        # streaming Cin in chunks fits any Cin; a 200 x 200 kernel's
        # weight slice and input slab do not fit even one stage
        with pytest.raises(ValueError, match="shared-memory budget"):
            tdse.plan_conv_rows(h_out=4, w_out=4, c_in=100_000, c_out=4,
                                kh=200, kw=200)
