"""Batched LM server (prefill + decode with bounded KV caches).

A small but real engine on one card:

* ``ServeEngine`` holds the parameters on the device and runs the
  prefill / decode steps of ``repro_torch.launch.steps`` eagerly.  There
  is no mesh: one card serves (the distributed launch is ROADMAP §A
  item 6).
* Requests are processed in *waves* (static-batch continuous batching):
  a wave of B prompts is prefilled together — through the hand-written
  flash-attention kernel (dense family) or SSD kernel (Mamba-2), one
  launch per layer — then decoded lock-step against caches padded to
  ``max_len`` (KV caches) or carried as they are (conv line buffer and
  SSD state).
* Greedy or temperature sampling; deterministic under a seed.

Usage::

  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \\
      --prompt-len 1024 --max-new 32            # on the card
  python -m repro_torch.launch.serve --arch mamba2-1.3b    # on the card
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
      --batch 4 --prompt-len 64 --max-new 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import steps as ST


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int
    tokens_per_s: float


class ServeEngine:
    """Serve ``cfg`` on ``device`` (``None``: the CUDA card; raises
    without one).  Parameters are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the device — or taken as given (``params``, e.g. from
    :func:`repro_torch.models.lm.lm_params_from_numpy`)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        device=None,
        max_len: int = 256,
        seed: int = 0,
        int8_weights: bool = False,
        params: dict | None = None,
    ) -> None:
        if int8_weights:
            raise NotImplementedError(
                "int8 weights wait for the port of quant/ptq.py (ROADMAP §A "
                "item 5)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = ST.model_init(gen, cfg)
        self.params = params
        self._prefill_step = ST.make_prefill_step(cfg)
        self._decode_step = ST.make_decode_step(cfg)

    # -- wave serving -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, prompts) -> tuple[torch.Tensor, dict]:
        """Prefill a wave of (B, P) token prompts → (last-token logits
        (B, V) f32 on the device, tight stacked KV caches)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                 device=self.device)
        return self._prefill_step(self.params, {"tokens": tokens})

    @torch.inference_mode()
    def generate(
        self,
        prompts: np.ndarray,       # (B, P) int token prompts
        *,
        max_new: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> tuple[np.ndarray, ServeStats]:
        """Prefill the wave, then decode ``max_new`` tokens lock-step →
        ((B, max_new) int32 tokens, stats).

        Greedy (``temperature <= 0``) takes the ``argmax``.  Sampling draws
        from ``torch.multinomial`` on a generator seeded with ``seed``:
        deterministic for a seed, but not the tokens the reference's
        ``jax.random.categorical`` draws for it.  The decode caches are
        updated in place."""
        cfg = self.cfg
        bsz, plen = prompts.shape
        if plen + max_new > self.max_len:
            raise ValueError(
                f"prompt {plen} + {max_new} new tokens exceed max_len "
                f"{self.max_len}")
        if cfg.embeds_input:
            raise NotImplementedError(
                "stub-frontend archs serve via decode-only cells"
            )
        dev = self.device
        t0 = time.perf_counter()
        logits, caches = self.prefill(prompts)
        # re-lay the prefill caches into the bounded decode cache
        cache = self._expand_cache(caches, bsz, plen)
        synchronize(dev)
        t1 = time.perf_counter()

        gen = torch.Generator(device=dev).manual_seed(seed)
        out = np.zeros((bsz, max_new), np.int32)
        token = self._sample(logits, temperature, gen)
        out[:, 0] = token.cpu().numpy()
        for i in range(1, max_new):
            logits, cache = self._decode_step(self.params, cache, token,
                                              plen + i - 1)
            token = self._sample(logits, temperature, gen)
            out[:, i] = token.cpu().numpy()
        synchronize(dev)
        t2 = time.perf_counter()
        stats = ServeStats(
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            tokens_out=bsz * max_new,
            tokens_per_s=bsz * max_new / max(t2 - t1, 1e-9),
        )
        return out, stats

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    def _expand_cache(self, prefill_caches: dict, bsz: int, plen: int):
        """Prefill returns tight caches; decode needs the bounded max_len
        layout.  As in the reference, a leaf whose shape differs from the
        decode cache's (k / v: ``plen`` positions of ``max_len``) fills
        the leading corner of the zeroed leaf; a leaf of the same shape
        (the conv line buffer, the SSD state) is copied whole."""
        full = ST.model_init_cache(self.cfg, bsz, self.max_len,
                                   device=self.device)
        for name, leaves in full.items():
            for leaf, dst in leaves.items():
                src = prefill_caches[name][leaf]
                if src.shape != dst.shape:
                    dst[tuple(slice(0, s) for s in src.shape)] = src
                else:
                    dst.copy_(src)
        return full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    engine = ServeEngine(cfg, device=args.device,
                         max_len=args.prompt_len + args.max_new,
                         seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
    )
    out, stats = engine.generate(
        prompts, max_new=args.max_new, temperature=args.temperature,
        seed=args.seed,
    )
    print(json.dumps(dataclasses.asdict(stats)))
    print(f"[serve] first row tokens: {out[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
