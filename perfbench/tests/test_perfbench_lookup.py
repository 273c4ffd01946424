"""Cells, configurations, mixes and per-layer metrics are found by their
names in ``BENCHMARK.json``: a later change adds them as files and
entries and edits no file that is there."""
import json
import shutil

import pytest

from perfbench import run
from perfbench.lib import cells
from perfbench.tests.smoke import smoke_cell


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, as a later change would find it."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    return tmp_path, before


def _add(root, rel, text):
    path = root / rel
    assert not path.exists(), f"{rel} is already there"
    path.write_text(text)


def test_new_config_mix_cell_and_metric_are_found_by_name(checkout):
    root, before = checkout
    cfg = json.loads((root / "perfbench/configs/mamba2-1.3b.json").read_text())
    cfg["name"] = "mamba2-780m"
    cfg["d_model"] = 1536
    _add(root, "perfbench/configs/mamba2-780m.json", json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/train_8x4096.json").read_text())
    mix.update(rows=4, seq=8192)
    _add(root, "perfbench/traffic/train_4x8192.json", json.dumps(mix))
    _add(root, "perfbench/limits/mamba2-780m.train_4x8192.json",
         json.dumps({"limits": {"loss_gap": 1, "grad_gap": 1,
                                "change_gap": 1}}))
    _add(root, "perfbench/metrics/busy_s.train.py",
         "def read(summary, cell):\n    return summary.busy_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mamba2-780m", "source": "x",
                             "file": "perfbench/configs/mamba2-780m.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mamba2-780m.train_4x8192",
                               "config": "mamba2-780m",
                               "traffic": "train_4x8192", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "busy_s.train", "unit": "s",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_tokens_per_s",
                               "workloads": ["mamba2-780m.train_4x8192"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("mamba2-780m.train_4x8192")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("mamba2-780m.train_4x8192", root)
    assert cell.config["d_model"] == 1536
    assert (cell.traffic["rows"], cell.traffic["seq"]) == (4, 8192)
    assert cell.limits["limits"]["loss_gap"] == 1
    assert "busy_s.train" in [m["name"] for m in cell.per_layer]
    assert "roofline.attn_fwd.train" not in [m["name"] for m in cell.per_layer]
    assert {m["name"] for m in cell.end_to_end} == {
        "train_tokens_per_s", "setup_s"}
    assert cells.driver(cell, root).__name__.endswith("train")
    read = cells.metric_reader("busy_s.train", root)
    assert read(type("S", (), {"busy_s": 2.5})(), cell) == 2.5
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_every_listed_name_has_its_files():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        cells.driver(cell)
        assert cell.config["name"] == w["config"]
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_missing_names_are_named():
    with pytest.raises(LookupError, match="no workload"):
        cells.load_cell("no-such-model.train")
    with pytest.raises(LookupError, match="no file"):
        cells.metric_reader("no_such_metric")


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = smoke_cell("mamba2-1.3b.train_8x4096")
    result = run.execute(cell, 3, 0.05, True, "cpu", log=lambda *_: None)
    # on the CPU no kernel of the port's runs on a card: no roofline
    assert not any(n.startswith("roofline.") for n in result["metrics"])
