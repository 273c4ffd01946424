"""A smoke-size run of each cell's traffic through the harness on the
CPU, up to the result line the contract asks for; the runner's refusals."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.lib import cells
from perfbench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "timing",
        "checks"]


def _quiet(*_):
    pass


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_smoke_run_prints_the_result_line(name, trace):
    cell = smoke_cell(name)
    result = run.execute(cell, 2 ** 31 + 17, 0.05, trace, "cpu", log=_quiet)
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[-1] == "checks"
    assert [k for k in keys if k != "breakdown"] == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line["checks"]) == list(cell.limits["limits"])
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert "breakdown" in line and line["device"]["window_s"] > 0


def _same(a, b):
    from perfbench.lib import weights

    pairs = list(zip(weights.leaves_with_path(a), weights.leaves_with_path(b)))
    assert all(pa == pb for (pa, _), (pb, _) in pairs)
    return all(torch.equal(ta, tb) for (_, ta), (_, tb) in pairs)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    from perfbench.lib import tokens, weights

    cfg = smoke_cell(name).config
    big = 2 ** 33 + 1
    assert _same(weights.draw(cfg, big, "cpu"), weights.draw(cfg, big, "cpu"))
    assert (tokens.token_block(big, 3, 2, 9, 100)
            == tokens.token_block(big, 3, 2, 9, 100)).all()
    assert not (tokens.token_block(big, 3, 2, 9, 100)
                == tokens.token_block(big + 1, 3, 2, 9, 100)).all()


@pytest.mark.parametrize("name", CELLS)
def test_a_weights_seed_fixes_the_weights_and_nothing_else(name):
    from perfbench.lib import weights

    cfg = smoke_cell(name).config
    fixed = "weights_seed" in cfg
    # the mixture of experts runs one draw of its weights for every seed
    assert fixed == (cfg["family"] == "moe")
    assert _same(weights.draw(cfg, 1, "cpu"),
                 weights.draw(cfg, 2, "cpu")) == fixed
    free = {k: v for k, v in cfg.items() if k != "weights_seed"}
    assert not _same(weights.draw(free, 1, "cpu"),
                     weights.draw(free, 2, "cpu"))


def test_runner_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "no CUDA card" in err


def test_runner_refuses_without_the_program(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no program" in r.stderr
