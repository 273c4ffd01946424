"""Deterministic sharded synthetic data pipeline, in PyTorch: the port of
the reference's ``data/pipeline.py``.

Batches are keyed by (seed, step): every host can generate exactly its
rows with no data server, and resuming from step N regenerates batch
N + 1 bit for bit.  The draws are NumPy's (``SeedSequence([seed, step,
host_row_start])``), as in the reference, so tokens, labels, stub
embeddings and M-RoPE positions are bit-identical across the two
packages; only :func:`batch_for_model` hands tensors to a device.

Token stream: a Zipf-ish unigram mix with induced bigram structure, so
losses are non-degenerate (a model can learn next-token statistics).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    seq_len: int = 1_024
    global_batch: int = 8
    # sharding: this host generates rows [host_row_start, host_row_end)
    host_row_start: int = 0
    host_row_end: Optional[int] = None


def _batch_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """Deterministic (rows, seq+1) token block for a step."""
    end = cfg.host_row_end if cfg.host_row_end is not None else cfg.global_batch
    rows = end - cfg.host_row_start
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_row_start])
    )
    v = cfg.vocab_size
    # zipf-ish unigram draw
    base = rng.zipf(1.3, size=(rows, cfg.seq_len + 1)).astype(np.int64)
    base = (base - 1) % v
    # induce bigram structure: with p=0.5, next token = f(prev)
    follow = (base[:, :-1] * 2654435761 % v).astype(np.int64)
    coin = rng.random((rows, cfg.seq_len)) < 0.5
    base[:, 1:] = np.where(coin, follow, base[:, 1:])
    return base.astype(np.int32)


def lm_batch(cfg: DataConfig, step: int) -> dict:
    """{"tokens": (rows, S), "labels": (rows, S)} int32 NumPy —
    next-token shifted."""
    block = _batch_tokens(cfg, step)
    return {"tokens": block[:, :-1], "labels": block[:, 1:]}


class LmDataIterator:
    """Stateful iterator with an explicit, checkpointable cursor."""

    def __init__(self, cfg: DataConfig, start_step: int = 0) -> None:
        self.cfg = cfg
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = lm_batch(self.cfg, self.step)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


def batch_for_model(cfg: ModelConfig, shape: ShapeConfig, data: DataConfig,
                    step: int, device=None) -> dict:
    """The model family's batch on ``device`` (None: the CUDA card, which
    raises without one): ``labels`` (B, S) int32 and ``tokens`` (B, S)
    int32, or for a stub-frontend arch ``embeds`` (B, S, D) in
    ``cfg.param_dtype`` (NumPy normals keyed by (seed, 7, step), cast to
    nearest even) and, with M-RoPE, ``mrope_positions`` (3, B, S)."""
    dev = resolve_device(device)
    b = lm_batch(dataclasses.replace(
        data, vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch), step)
    out: dict = {"labels": torch.from_numpy(b["labels"].copy()).to(dev)}
    if cfg.embeds_input:
        # stub frontend: hash tokens into embeddings deterministically
        rng = np.random.default_rng(np.random.SeedSequence([data.seed, 7, step]))
        emb = rng.normal(size=(*b["tokens"].shape, cfg.d_model)).astype(np.float32)
        out["embeds"] = torch.from_numpy(emb).to(dev).to(cfg.param_dtype)
        if cfg.mrope_sections:
            s = b["tokens"].shape[1]
            pos = np.broadcast_to(
                np.arange(s, dtype=np.int32), (3, b["tokens"].shape[0], s)
            )
            out["mrope_positions"] = torch.from_numpy(pos.copy()).to(dev)
    else:
        out["tokens"] = torch.from_numpy(b["tokens"].copy()).to(dev)
    return out
