"""The port's training driver on one card (``repro_torch.launch.train``:
``TrainRun``, ``train``, ``main``) on the CPU, at qwen2-0.5b's smoke
config (2 layers, d_model 64, tied embeddings, bf16).

The reference's end-to-end restart tests
(``test_fault_tolerance.py::TestEndToEndRestart``) fail under the mesh on
this jax (ROADMAP §C).  Their cases run here on the port: a run crashed
at step 12 and restarted from its step-10 checkpoint gives the losses of
an uninterrupted run bit for bit, and a run re-invoked on its directory
runs only the new steps.  Against the reference: a state that the
reference's unsharded ``model_init`` + ``adamw.init`` drew and its
``CheckpointManager`` wrote as step 0 is resumed by the port's
``train``, whose losses are held to a hand-driven loop of the
reference's unsharded ``jax.jit(make_train_step)`` over
``repro.data.pipeline.batch_for_model`` at ``test_torch_lm_train.py``'s
bf16 tolerances (loss rtol 3e-2; parameters atol = rtol = 3e-2), and the
port's last checkpoint restores in the reference."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.optim import adamw as JA

from repro_torch.configs import registry as treg
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.optim import adamw as TA
from repro_torch.tree import tree_flatten_with_path

import chip_smoke
from _torch_port import REPO, flat, to_np

ARCH = "qwen2-0.5b"
COMMON = dict(arch=ARCH, smoke=True, batch=2, seq=32, lr=1e-3, log_every=0,
              seed=3, device="cpu")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_bit_exact_loss_continuity(tmp_path, grad_accum):
    """A run crashed at step 12 and restarted from its step-10 checkpoint
    replays steps 10 and 11 and gives the losses of an uninterrupted run,
    bit for bit."""
    kw = dict(COMMON, steps=20, ckpt_every=5, grad_accum=grad_accum)
    clean = TT.train(ckpt_dir=str(tmp_path / "clean"), **kw)
    crashy = TT.train(ckpt_dir=str(tmp_path / "crashy"), fail_at=(12,), **kw)
    assert clean["final_step"] == crashy["final_step"] == 20
    assert len(clean["losses"]) == 20 and len(crashy["losses"]) == 22
    lc, lk = clean["losses"], crashy["losses"]
    assert lk[:12] + lk[14:] == lc                 # exact float equality
    assert lk[12:14] == lc[10:12]                  # the replayed steps
    assert all(np.isfinite(lc))
    # the card's check of the same contract (chip_smoke's train_resilient)
    assert chip_smoke.restart_replays(lc, lk, fail_at=12, restored_from=10)
    assert not chip_smoke.restart_replays(lc, lk, fail_at=12,
                                          restored_from=5)


@pytest.mark.parametrize("fault", ["value", "order", "no_replay", "extra"])
def test_restart_replays_catches_a_wrong_log(fault):
    clean = [float(i) for i in range(8)]
    crashed = clean[:6] + clean[4:6] + clean[6:]
    assert chip_smoke.restart_replays(clean, crashed, fail_at=6,
                                      restored_from=4)
    bad = list(crashed)
    if fault == "value":
        bad[7] = np.nextafter(bad[7], 99.0)        # one ulp
    elif fault == "order":
        bad[6], bad[7] = bad[7], bad[6]
    elif fault == "no_replay":
        bad = list(clean)
    else:
        bad = bad + [8.0]
    assert not chip_smoke.restart_replays(clean, bad, fail_at=6,
                                          restored_from=4)


def test_need_free_disk(tmp_path, monkeypatch):
    import shutil
    import types

    where = tmp_path / "ckpt"
    monkeypatch.setattr(shutil, "disk_usage",
                        lambda p: types.SimpleNamespace(free=10e9))
    assert chip_smoke.need_free_disk(str(where), 9e9) == 10e9
    assert where.is_dir()
    with pytest.raises(RuntimeError, match=r"10\.00 GB free.*need 12\.50 GB"):
        chip_smoke.need_free_disk(str(where), 12.5e9)


def test_resume_from_existing_dir(tmp_path):
    """Train 10 steps, stop; re-invoke for 20 → resumes at 10."""
    kw = dict(COMMON, ckpt_every=5, ckpt_dir=str(tmp_path))
    first = TT.train(steps=10, **kw)
    second = TT.train(steps=20, **kw)
    assert first["final_step"] == 10 and second["final_step"] == 20
    # the resumed run executed only steps 10..19
    assert len(second["losses"]) == 10
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000010", "step_000000015", "step_000000020"]


def test_without_a_checkpoint_dir_nothing_is_saved(tmp_path):
    out = TT.train(steps=3, ckpt_dir=None, fail_at=(), **COMMON)
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert set(out) == {"final_step", "losses", "straggler_flags",
                        "median_step_s"}


def test_fresh_state_and_template():
    """Fresh parameters come from a generator seeded with ``seed`` on the
    device; the restore template holds their shapes and dtypes (and the
    moments') as ``meta`` tensors."""
    cfg = treg.get_config(ARCH, smoke=True)
    opt = TA.AdamWConfig()
    run = TT.TrainRun(cfg=cfg, shape=None, opt_cfg=opt,
                      device=torch.device("cpu"), ckpt=None,
                      data_cfg=None, seed=3)
    step, (params, state) = run.fresh_state()
    assert step == 0 and int(state.step) == 0
    want = TS.model_init(torch.Generator().manual_seed(3), cfg)
    for (p, a), (_, b) in zip(flat(params), flat(want)):
        assert torch.equal(a, b), p
    tmpl = run.state_template()
    live = {"params": params, "opt": state}
    got = tree_flatten_with_path(tmpl)
    have = tree_flatten_with_path(live)
    assert [p for p, _ in got] == [p for p, _ in have]
    for (path, t), (_, x) in zip(got, have):
        assert t.device.type == "meta", path
        assert (t.shape, t.dtype) == (x.shape, x.dtype), path
    assert run.restore_state() is None


def test_a_mesh_waits_for_distributed_training():
    """``train(mesh=...)`` trains on a mesh of ranks
    (``test_torch_mesh_train.py``); a mesh that is its shape alone, with
    no process group behind it, raises before any step."""
    from repro_torch.launch.mesh import Mesh

    with pytest.raises(RuntimeError, match="no ranks"):
        TT.train(steps=1, ckpt_dir=None, mesh=Mesh((1, 1), ("data", "model")),
                 **COMMON)


def test_the_default_device_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TT.train(steps=1, ckpt_dir=str(tmp_path),
                 **dict(COMMON, device=None))


def test_cli_exits_0(tmp_path):
    """``python -m repro_torch.launch.train`` with a crash at step 2 on
    the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--fail-at", "2",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    summary = json.loads(lines[-2])
    assert summary["final_step"] == 3 and "losses" not in summary
    assert lines[-1].startswith("[train] first loss")
    assert sorted(os.listdir(tmp_path))[-1] == "step_000000003"


def test_cli_on_a_finished_directory_runs_no_step(tmp_path, capsys):
    """A second ``main`` on a directory that already holds the last step
    resumes there, runs nothing and still exits 0 (the reference's
    ``main`` indexes the empty loss list)."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
            "--device", "cpu"]
    assert TT.main(argv) == 0
    capsys.readouterr()
    assert TT.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2])["final_step"] == 2
    assert lines[-1].startswith("[train] no step run")


def test_resumes_a_reference_checkpoint_and_matches_its_train_steps(tmp_path):
    steps, lr, seed, batch, seq = 5, 3e-4, 3, 2, 32
    jcfg = jreg.get_config(ARCH, smoke=True)          # blockwise attention
    opt = JA.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                         total_steps=steps)
    jp = JS.model_init(jax.random.key(seed), jcfg)
    js = JA.init(jp, opt)
    JManager(str(tmp_path)).save(0, {"params": jp, "opt": js},
                                 extra={"step": 0})

    out = TT.train(arch=ARCH, smoke=True, steps=steps, batch=batch, seq=seq,
                   ckpt_dir=str(tmp_path), ckpt_every=10, lr=lr,
                   log_every=0, seed=seed, device="cpu")
    assert out["final_step"] == steps and len(out["losses"]) == steps

    step_fn = jax.jit(JS.make_train_step(jcfg, opt))
    shape = JShape("train_cli", seq, batch, "train")
    data = JP.DataConfig(seed=seed, vocab_size=jcfg.vocab_size, seq_len=seq,
                         global_batch=batch)
    losses = []
    for s in range(steps):
        jp, js, m = step_fn(jp, js, JP.batch_for_model(jcfg, shape, data, s))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], losses, rtol=3e-2)

    # the port's final checkpoint, read by the reference
    tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        {"params": jp, "opt": js})
    got, extra = JManager(str(tmp_path)).restore(steps, tmpl)
    assert extra == {"step": steps} and int(got["opt"].step) == steps
    for (path, a), (_, b) in zip(flat(jax.tree.map(to_np, got["params"])),
                                 flat(jax.tree.map(to_np, jp))):
        np.testing.assert_allclose(a, b, atol=3e-2, rtol=3e-2, err_msg=path)


def test_the_restart_phases_attention_shape_is_a_checked_backward_case():
    """``chip_smoke.py``'s ``train_resilient`` runs the attention backward
    at qwen2-0.5b's train shape; ``attn_bwd_check`` holds the kernel
    against its plain version at that shape, on the ``"wgmma"`` route."""
    from repro_torch.core import dse

    cfg = treg.get_config(chip_smoke.RESILIENT_ARCH)
    run = chip_smoke.RESILIENT_RUN
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (run["batch"], h, kv, run["seq"], run["seq"], d, True, 0)
    assert shape in [case[1:] for case in chip_smoke.ATTN_BWD_CASES]
    plan = dse.plan_attn_bwd_blocks(
        batch_heads_q=run["batch"] * h, heads_q=h, heads_kv=kv,
        seq_q=run["seq"], seq_k=run["seq"], head_dim=d, dtype="bfloat16",
        aligned=True)
    assert plan.route == "wgmma"


def test_the_restart_phase_cuts_the_depth_of_the_registered_config():
    """``chip_smoke.py``'s ``train_resilient`` trains qwen2-0.5b at
    ``RESILIENT_LAYERS`` layers through ``launch.train.train``, which
    resolves its config by name: inside ``config_cut`` the name gives the
    cut config, width kept, and after it the published one again."""
    full = treg.get_config(chip_smoke.RESILIENT_ARCH)
    assert full.num_layers == 24
    with chip_smoke.config_cut(chip_smoke.RESILIENT_ARCH,
                               num_layers=chip_smoke.RESILIENT_LAYERS) as cut:
        got = treg.get_config(chip_smoke.RESILIENT_ARCH)
        assert got is cut and got == full.with_(
            num_layers=chip_smoke.RESILIENT_LAYERS)
        run = TT.build_run(cfg=got, steps=1, batch=1, seq=8, ckpt_dir=None,
                           device="cpu")
        wq = run.state_template()["params"]["blocks"]["b0"]["attn"]["wq"]
        assert wq.shape == (chip_smoke.RESILIENT_LAYERS, 896, 896)
    assert treg.get_config(chip_smoke.RESILIENT_ARCH) is full
