"""End-to-end training on the PyTorch/CUDA port: ``examples/train_lm.py``
through ``repro_torch``.

A 46.1M-param llama-family model (llama3.2-1b narrowed to 4 layers,
d_model 512, f32) trained for a few hundred steps by
``repro_torch.launch.train``, with a checkpoint every 50 steps, an
injected mid-run crash (auto-restart from the latest checkpoint), and
loss-curve verification.  On the CUDA card every attention layer runs
the hand-written flash-attention kernel forward
(``kernels/csrc/flash_attention.cu``) and backward
(``kernels/csrc/flash_attention_bwd.cu``), in f32 on the CUDA cores.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]   # the CUDA card
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20 \\
          --batch 2 --seq 64        # no card: ~10 s a step at the full size
"""
import argparse
import tempfile
from typing import Optional

from repro_torch.configs.base import ModelConfig, count_params
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import train

#: the name the example's config is registered under for ``train``
ARCH = "_example100m"
CKPT_EVERY = 50
LR = 6e-4
LOG_EVERY = 20


def example_config() -> ModelConfig:
    """The reference example's narrowing of the llama3.2-1b family
    (46.1M params; its docstring says ~100M)."""
    return get_config("llama3.2-1b").with_(
        num_layers=4, d_model=512, num_heads=8, num_kv_heads=4, d_ff=1536,
        vocab_size=32768, attn_block_q=128, attn_block_k=128, loss_chunk=128,
        dtype="float32",
    )


def train_lm(*, steps: int, batch: int, seq: int, device) -> dict:
    """The run on ``device``: ``train``'s result, with the config it
    trained (``cfg``), the step the crash was injected at (``fail_at``)
    and the tokens a step (``tokens_per_step``)."""
    cfg = example_config()
    n = count_params(cfg)
    print(f"model: {n/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model} ff={cfg.d_ff} v={cfg.vocab_size})")

    import repro_torch.configs.llama3_2_1b as mod
    import repro_torch.configs.registry as registry

    # register the custom config under a temp name for ``train``
    registry.ARCHS[ARCH] = "llama3_2_1b"
    orig = mod.CONFIG
    mod.CONFIG = cfg
    fail_at = steps // 2
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            out = train(
                arch=ARCH, smoke=False, steps=steps, batch=batch, seq=seq,
                ckpt_dir=ckpt, ckpt_every=CKPT_EVERY, lr=LR,
                fail_at=(fail_at,), log_every=LOG_EVERY, device=device,
            )
    finally:
        mod.CONFIG = orig
        registry.ARCHS.pop(ARCH)
    return dict(out, cfg=cfg, fail_at=fail_at, tokens_per_step=batch * seq)


def main(argv=None, out: Optional[dict] = None) -> int:
    """``out``, when given, receives :func:`train_lm`'s result and the
    first and last 10-loss means (``first``, ``last``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # no card → raises here
    res = train_lm(steps=args.steps, batch=args.batch, seq=args.seq,
                   device=device)

    losses = res["losses"]
    first = sum(losses[:10]) / 10
    last = sum(losses[-10:]) / 10
    if out is not None:
        out.update(res, first=first, last=last)
    print(f"\nfirst-10 mean loss {first:.4f} -> last-10 mean loss {last:.4f}")
    print(f"survived injected crash at step {res['fail_at']}; "
          f"median step {res['median_step_s']*1e3:.0f} ms; "
          f"stragglers flagged: {len(res['straggler_flags'])}")
    assert last < first - 0.3, "model failed to learn"
    print("OK — loss decreased through a mid-run crash + restart")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
