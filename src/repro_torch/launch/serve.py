"""Batched LM server (prefill + decode with bounded KV caches).

A small but real engine on one card:

* ``ServeEngine`` holds the parameters on the device and runs the
  prefill / decode steps of ``repro_torch.launch.steps`` eagerly, on one
  device or (``mesh=...``) on a device mesh: the parameters as DTensors
  placed by ``distributed.sharding.make_param_shardings``, the decode
  caches by ``make_cache_shardings``, and each rank computing its rows
  of ``data`` on its shard of ``model`` — heads, ``d_ff``, experts, the
  vocabulary and the Mamba mixer's heads (``distributed/tp.py``).  A
  call gathers the params along the data axes one superblock at a time,
  as the superblock runs (``tp.gather_data``), as the reference's
  scanned ``jit`` does.  The hand-written kernels see only plain local
  tensors.
* Requests are processed in *waves* (static-batch continuous batching):
  a wave of B prompts is prefilled together — through the hand-written
  flash-attention kernel (each attention layer of the dense, MoE and
  hybrid families) or SSD kernel (each Mamba-2 layer of the SSM and
  hybrid families), one launch per layer — then decoded lock-step
  against caches padded to ``max_len`` (KV caches) or carried as they
  are (conv line buffer and SSD state).  The encoder–decoder family
  (frame embeddings in, ``embeds_input``) is refused by ``generate``, as
  in the reference: it is driven through ``steps.model_prefill`` /
  ``model_decode``.
* Greedy or temperature sampling; deterministic under a seed.
* ``int8_weights=True``: weight-only int8 (``repro_torch.quant``), the
  reference's regime.  The engine quantizes once, at construction, on the
  device, and holds int8 weights with f32 per-channel scales; each
  prefill and decode call dequantizes them to ``cfg.param_dtype`` — on
  a mesh a superblock's at a time, right after its gather, so that a
  rank never holds the whole model dequantized.  The reference's ``jit``
  fuses that convert into the consumers; here it runs eagerly and writes
  a transient copy of the weights.

Usage::

  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \\
      --prompt-len 1024 --max-new 32            # on the card
  python -m repro_torch.launch.serve --arch mamba2-1.3b    # on the card
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --smoke \\
      --batch 2 --prompt-len 16 --max-new 4 --device cpu
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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.launch import steps as ST
from repro_torch.quant.ptq import (dequantize_params, quantize_params,
                                   quantized_param_shardings)


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
    :func:`repro_torch.models.lm.lm_params_from_numpy`).  With
    ``int8_weights`` they are quantized once, here, and ``self.params``
    holds the int8 tree.

    On ``mesh`` (``launch.mesh``, with ranks; every rank builds the engine
    with the same arguments) the whole parameters — the same on every
    rank — are placed as DTensors by ``make_param_shardings`` (int8
    leaves and scales by ``quantized_param_shardings``) and each rank
    keeps its shard.  A call computes on the rank's ``model`` shard and
    gathers each superblock's leaves along the data axes when it runs
    (int8 ones dequantized right after); prompts go over the data axes
    where they divide them.  ``generate`` emits on every rank the tokens
    one device emits: the last-token logits are gathered to the whole
    (B, V) and every rank samples them alike."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        device=None,
        mesh=None,
        max_len: int = 256,
        seed: int = 0,
        int8_weights: bool = False,
        params: dict | None = None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"{mesh!r} serves on {self.device}")
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = ST.model_init(gen, cfg)
        self.int8_weights = int8_weights
        whole = params
        if int8_weights:
            # weight-only PTQ: int8 weights + per-channel scales, on the
            # device (of the whole leaves: a scale is an absmax over the
            # contraction axis); dequantized in each prefill and decode
            # call
            params = quantize_params(params)
        if mesh is not None:
            p_shard = shd.make_param_shardings(mesh, whole, cfg)
            if int8_weights:
                p_shard = quantized_param_shardings(p_shard, whole)
            params = shd.distribute_tree(params, p_shard)
        self.params = params
        self._prefill_step = ST.make_prefill_step(cfg, mesh)
        self._decode_step = ST.make_decode_step(cfg, mesh)

    def model_params(self) -> dict:
        """The parameters a step takes: ``self.params``, or with int8
        weights a fresh copy dequantized to ``cfg.param_dtype``.  On a
        mesh the placed tree as it is: the step gathers and dequantizes
        one superblock at a time."""
        if self.int8_weights and self.mesh is None:
            return dequantize_params(self.params, self.cfg.param_dtype)
        return self.params

    # -- wave serving -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, prompts) -> tuple[torch.Tensor, dict]:
        """Prefill a wave of (B, P) token prompts → (last-token logits
        (B, V) f32 on the device, tight stacked KV caches)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                 device=self.device)
        return self._prefill_step(self.model_params(), {"tokens": tokens})

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
        updated in place; on a mesh every rank samples the whole batch
        alike, and the decode step takes the token placed by
        ``make_batch_shardings`` (``steps.place_token``)."""
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
            logits, cache = self._decode_step(
                self.model_params(), cache, ST.place_token(self.mesh, token),
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
        (the conv line buffer, the SSD state, an encoder memory's K/V as
        long as ``max_len``) is copied whole.  A hybrid's tree holds both
        kinds under one root.  On a mesh the decode cache is a tree of
        DTensors placed by ``make_cache_shardings``, each rank's block
        filled from its prefill caches (``tp.cache_from_prefill``)."""
        if self.mesh is not None:
            shapes = ST.model_init_cache(self.cfg, bsz, self.max_len,
                                         device="meta")
            return tp.cache_from_prefill(
                prefill_caches, shapes,
                shd.make_cache_shardings(self.mesh, shapes, self.cfg),
                self.mesh)
        full = ST.model_init_cache(self.cfg, bsz, self.max_len,
                                   device=self.device)

        def merge(src, dst):
            if isinstance(dst, dict):      # any depth: the LM's per-block
                for k, d in dst.items():   # tree, the encdec's flat one
                    merge(src[k], d)
            elif src.shape != dst.shape:
                dst[tuple(slice(0, s) for s in src.shape)] = src
            else:
                dst.copy_(src)

        merge(prefill_caches, full)
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
