"""Training driver in PyTorch: the port of the reference's
``launch/train.py``.

Wires together:

  config registry  → model init (stacked params, drawn on the device)
  sharding rules   → params and optimizer state as DTensors on a device
                     mesh (``mesh=...``; ``distributed/sharding.py``)
  train step       → ``launch.steps.make_train_step`` (eager: loss,
                     autograd through the hand-written kernels, AdamW),
                     or ``make_sharded_train_step`` on a mesh
  data pipeline    → deterministic batches keyed by (seed, step); on a
                     mesh each rank draws only its own rows
  checkpointing    → atomic, async, the reference's on-disk layout,
                     restored onto any mesh (elastic re-mesh)
  resilience       → crash-restart loop + straggler watchdog

``mesh=None`` trains on one card without a process group.  A run
crashed at any step and restarted from its latest checkpoint gives the
losses of an uninterrupted run, bit for bit; a 1 × 1 mesh gives the
``mesh=None`` losses bit for bit.

Usage::

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 8 \\
      --batch 4 --seq 1024 --ckpt-dir build/ckpt --fail-at 6   # the card
  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --steps 20 \\
      --batch 2 --seq 32 --ckpt-dir build/ckpt_cpu --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --steps 8 --batch 4 --seq 1024   # a (2, 1) mesh

Under ``torchrun`` the world is a (world size, 1) ``data`` × ``model``
mesh, NCCL on the cards, gloo with ``--device cpu``; every rank trains
its rows and only rank 0 prints.  A run resumes from the latest
checkpoint in ``--ckpt-dir``: start from an empty directory (``rm -rf
build/ckpt``) to train from step 0.  The three latest checkpoints stay
there (qwen2-0.5b's are 4.9 GB each).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.optim import adamw
from repro_torch.runtime.resilience import (
    FailureInjector,
    StragglerWatchdog,
    run_resilient,
)


@dataclasses.dataclass
class TrainRun:
    """Everything a (re)start needs — built once per process.  With a
    ``mesh`` the state lives as DTensors placed by the sharding rules
    (``p_shard``, ``o_shard``) and a step computes this rank's rows."""

    cfg: ModelConfig
    shape: ShapeConfig
    opt_cfg: adamw.AdamWConfig
    device: torch.device
    ckpt: Optional[CheckpointManager]
    data_cfg: DataConfig
    grad_accum: int = 1
    seed: int = 0
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self._template = None
        if self.mesh is None:
            self.p_shard = self.o_shard = None
            self.step_fn = ST.make_train_step(
                self.cfg, self.opt_cfg, grad_accum=self.grad_accum)
            return
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"{self.mesh!r} trains on {self.device}")
        tmpl = self.state_template()
        self.p_shard = shd.make_param_shardings(self.mesh, tmpl["params"],
                                                self.cfg)
        self.o_shard = shd.make_opt_shardings(self.mesh, tmpl["opt"],
                                              self.p_shard)
        self.step_fn = ST.make_sharded_train_step(
            self.cfg, self.opt_cfg, self.mesh,
            global_batch=self.shape.global_batch, grad_accum=self.grad_accum)

    # -- state construction / restore ---------------------------------------

    def state_template(self) -> dict:
        """``{"params", "opt"}`` as ``meta`` tensors: the shapes and dtypes
        a checkpoint restores into."""
        if self._template is None:
            params = specs.params_specs(self.cfg)
            self._template = {"params": params,
                              "opt": adamw.init(params, self.opt_cfg)}
        return self._template

    def fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = ST.model_init(gen, self.cfg)
        opt_state = adamw.init(params, self.opt_cfg)
        if self.mesh is not None:       # every rank drew the same values
            params = shd.distribute_tree(params, self.p_shard)
            opt_state = shd.distribute_tree(opt_state, self.o_shard)
        return 0, (params, opt_state)

    def restore_state(self):
        if self.ckpt is None:
            return None
        # a checkpoint still being written is the latest one: finish it
        self.ckpt.wait()
        step = self.ckpt.latest_step()
        if step is None:
            return None
        shardings = None if self.mesh is None else \
            {"params": self.p_shard, "opt": self.o_shard}
        tree, _ = self.ckpt.restore(step, self.state_template(),
                                    device=self.device, shardings=shardings)
        return step, (tree["params"], tree["opt"])

    def save_state(self, step: int, state):
        if self.ckpt is None:
            return
        params, opt_state = state
        shardings = None if self.mesh is None else \
            {"params": self.p_shard, "opt": self.o_shard}
        self.ckpt.save_async(
            step, {"params": params, "opt": opt_state}, extra={"step": step},
            shardings=shardings)

    # -- one step -------------------------------------------------------------

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``; on a mesh this rank's rows
        (``steps.batch_rows``), each span drawn as a host draws its rows."""
        if self.mesh is None:
            return batch_for_model(self.cfg, self.shape, self.data_cfg, step,
                                   device=self.device)
        return self.rows_at(step, ST.batch_rows(
            self.mesh, self.shape.global_batch, self.grad_accum))

    def rows_at(self, step: int, spans) -> dict:
        """The rows ``spans`` (``[(start, end), ...]``) of ``step``'s
        batch, each span drawn as a host draws its rows, joined in
        order."""
        parts = [batch_for_model(
            self.cfg, self.shape,
            dataclasses.replace(self.data_cfg, host_row_start=a,
                                host_row_end=b), step, device=self.device)
            for a, b in spans]
        return {name: torch.cat([b[name] for b in parts],
                                dim=ST.SPLIT_AXIS.get(name, 0))
                for name in parts[0]}

    def run_step(self, step: int, state):
        params, opt_state = state
        params, opt_state, metrics = self.step_fn(params, opt_state,
                                                  self.batch_at(step))
        return (params, opt_state), metrics


def build_run(*, cfg: ModelConfig, steps: int, batch: int, seq: int,
              ckpt_dir: Optional[str], lr: float = 3e-4,
              grad_accum: int = 1, seed: int = 0, device=None,
              mesh: Optional[Mesh] = None) -> TrainRun:
    """The ``TrainRun`` that :func:`train` drives: AdamW warming up over
    ``max(steps // 20, 5)`` steps and decaying to ``steps``, batches of
    ``batch`` × ``seq`` tokens keyed by ``seed``, checkpoints under
    ``ckpt_dir`` (``None``: none), on ``mesh`` (``None``: one device)."""
    return TrainRun(
        cfg=cfg,
        shape=ShapeConfig("train_cli", seq, batch, "train"),
        opt_cfg=adamw.AdamWConfig(
            lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps
        ),
        device=resolve_device(device),
        ckpt=CheckpointManager(ckpt_dir) if ckpt_dir else None,
        data_cfg=DataConfig(seed=seed, vocab_size=cfg.vocab_size,
                            seq_len=seq, global_batch=batch),
        grad_accum=grad_accum,
        seed=seed,
        mesh=mesh,
    )


def train(
    *,
    arch: str,
    smoke: bool,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: Optional[str],
    ckpt_every: int = 10,
    lr: float = 3e-4,
    grad_accum: int = 1,
    fail_at: tuple[int, ...] = (),
    mesh=None,
    log_every: int = 10,
    seed: int = 0,
    device=None,
) -> dict:
    """Returns {"final_step", "losses", "straggler_flags", ...}.
    ``device=None`` is the CUDA card (and raises without one); ``mesh``
    (``launch.mesh``) trains on a device mesh of that device type, every
    rank calling ``train`` with the same arguments: each logs its steps,
    only rank 0 prints."""
    run = build_run(cfg=get_config(arch, smoke=smoke), steps=steps,
                    batch=batch, seq=seq, ckpt_dir=ckpt_dir, lr=lr,
                    grad_accum=grad_accum, seed=seed, device=device,
                    mesh=mesh)
    log_every = log_every if _rank() == 0 else 0

    injector = FailureInjector(fail_at_steps=fail_at)
    watchdog = StragglerWatchdog()
    losses: list[float] = []

    def run_step(step, state):
        injector.check(step)
        watchdog.start()
        state, metrics = run.run_step(step, state)
        loss = float(metrics["loss"])          # waits for the device
        watchdog.stop(step)
        losses.append(loss)
        if log_every and (step % log_every == 0):
            print(
                f"[train] step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({watchdog.median*1e3:.0f} ms/step median)",
                flush=True,
            )
        return state, metrics

    final_step, state = run_resilient(
        total_steps=steps,
        make_state=run.fresh_state,
        restore_state=run.restore_state,
        run_step=run_step,
        save_state=run.save_state,
        checkpoint_every=ckpt_every,
    )
    if run.ckpt is not None:
        run.ckpt.wait()
    return {
        "final_step": final_step,
        "losses": losses,
        "straggler_flags": list(watchdog.flagged),
        "median_step_s": watchdog.median,
    }


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_for(args) -> Optional[Mesh]:
    """The mesh of a command-line run: under ``torchrun`` (``WORLD_SIZE``
    set) every rank along ``data``, after starting the process group from
    torchrun's environment; otherwise none."""
    if "WORLD_SIZE" not in os.environ:
        return None
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    return make_host_mesh((dist.get_world_size(), 1), ("data", "model"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mesh = _mesh_for(args)
    rank = _rank()
    try:
        out = train(
            arch=args.arch, smoke=args.smoke, steps=args.steps,
            batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, lr=args.lr,
            grad_accum=args.grad_accum, fail_at=tuple(args.fail_at),
            mesh=mesh, seed=args.seed, device=args.device,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return 0
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
    if out["losses"]:
        print(f"[train] first loss {out['losses'][0]:.4f} "
              f"last loss {out['losses'][-1]:.4f}")
    else:
        print(f"[train] no step run: {args.ckpt_dir} already holds step "
              f"{out['final_step']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
