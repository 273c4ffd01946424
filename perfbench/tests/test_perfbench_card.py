"""On the card: one short run of each cell through the runner, as the
check runs it.  Run there with ``python -m pytest -m cuda
perfbench/tests``."""
import json
import subprocess
import sys

import pytest

from perfbench.lib import cells

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 99), "--seconds", "2",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True, line["checks"]
