"""Token draws keyed by (seed, key): a frozen copy of the token stream of
the port's ``data/pipeline.py`` (``_batch_tokens``): a Zipf-like unigram
draw with every other token, at random, a fixed function of the one
before, so that a model can learn next-token statistics."""
from __future__ import annotations

import numpy as np


def token_block(seed: int, key: int, rows: int, length: int, vocab: int,
                stream: int = 0) -> np.ndarray:
    """(rows, length) int32 tokens drawn from ``SeedSequence([seed, key,
    stream])``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, key, stream]))
    base = rng.zipf(1.3, size=(rows, length)).astype(np.int64)
    base = (base - 1) % vocab
    follow = (base[:, :-1] * 2654435761 % vocab).astype(np.int64)
    coin = rng.random((rows, length - 1)) < 0.5
    base[:, 1:] = np.where(coin, follow, base[:, 1:])
    return base.astype(np.int32)


def lm_batch(seed: int, step: int, rows: int, seq: int, vocab: int) -> dict:
    """A training batch: ``tokens`` and next-token ``labels``, (rows, seq)
    each, from one (rows, seq + 1) block keyed by (seed, step)."""
    block = token_block(seed, step, rows, seq + 1, vocab)
    return {"tokens": block[:, :-1], "labels": block[:, 1:]}
