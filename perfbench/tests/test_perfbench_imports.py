"""Nothing the runner or the reference loads is JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
program."""
import json
import os
import subprocess
import sys

from perfbench.lib import cells

ROOT = str(cells.ROOT)

RUNNER = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench import run
from perfbench.tests.smoke import smoke_cell
for name in {names!r}:
    run.execute(smoke_cell(name), 3, 0.01, True, "cpu", log=lambda *a: None)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from perfbench.reference import lm, adamw
from perfbench.lib import weights, tokens
from perfbench.tests.smoke import SMOKE_CONFIG
for name in ("granite-moe-1b-a400m", "mamba2-1.3b"):
    cfg = json.load(open({root!r} + f"/perfbench/configs/{{name}}.json"))
    cfg.update(SMOKE_CONFIG, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32)
    if cfg["family"] == "moe":
        cfg["moe"] = dict(cfg["moe"], num_experts=4, top_k=2)
    else:
        cfg["ssm"] = dict(cfg["ssm"], state_dim=8, head_dim=8)
    p = weights.draw(cfg, 1, "cpu", as_float32=True)
    b = tokens.lm_batch(1, 0, 2, 12, cfg["vocab_size"])
    lm.loss(p, cfg, torch.from_numpy(b["tokens"]),
            torch.from_numpy(b["labels"])).item()
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(r.stdout.splitlines()[-1])}


def test_the_runner_loads_neither_jax_nor_the_jax_package():
    names = [w["name"] for w in cells.benchmark()["workloads"]]
    top = _modules(RUNNER.format(src=ROOT + "/src", root=ROOT, names=names))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    top = _modules(REFERENCE.format(root=ROOT))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_runner_names_what_it_finds():
    from perfbench import run

    sys.modules["repro.fake_for_test"] = sys.modules[__name__]
    try:
        assert "repro.fake_for_test" in run.forbidden_modules()
    finally:
        del sys.modules["repro.fake_for_test"]
    assert all(m.split(".")[0] in run.FORBIDDEN
               for m in run.forbidden_modules())
