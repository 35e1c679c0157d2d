"""The one generator of the benchmark's traffic. A mix is a JSON file under
``perfbench/traffic/`` whose ``kind`` says what it drives:

- ``train``: a training job. The corpus is ``corpus_tokens`` ids drawn
  from the seed with LM-like statistics (:func:`corpus`); the job's
  batch, sequence length, optimizer and schedule are the file's.
- ``serve_batch``: a closed loop of fixed-shape batches. Batch i's
  prompts (``batch`` x ``prompt_len`` ids) are :func:`prompts` (seed, i);
  every request asks for ``new_tokens`` tokens and never stops early.

The same seed gives the same inputs; every seed gives the same sizes.
"""
from __future__ import annotations

import numpy as np

WARM_UP = -1            # the batch index of a serving cell's warm-up batch


def corpus(n_tokens: int, vocab: int, seed: int, zipf_a: float = 1.2,
           follow_share: float = 0.3) -> np.ndarray:
    """Zipf-distributed ids (rank r drawn with weight r ** -zipf_a) where
    ``follow_share`` of the positions repeat a bigram rule instead (token
    t is followed by (7 t + 3) mod vocab), as int64."""
    rng = np.random.default_rng((int(seed), 0))
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -zipf_a
    cdf = np.cumsum(w / w.sum())
    base = np.minimum(np.searchsorted(cdf, rng.random(n_tokens)), vocab - 1)
    follow = (base * 7 + 3) % vocab
    mask = rng.random(n_tokens) < follow_share
    out = base.copy()
    out[1:][mask[1:]] = follow[:-1][mask[1:]]
    return out.astype(np.int64)


def prompts(mix: dict, vocab: int, seed: int, index: int) -> np.ndarray:
    """(batch, prompt_len) int32 ids, uniform over the vocabulary."""
    rng = np.random.default_rng((int(seed), 1, index + 1))
    return rng.integers(0, vocab, (mix["batch"], mix["prompt_len"]),
                        dtype=np.int64).astype(np.int32)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """k of n indices, drawn from the seed without replacement, sorted."""
    rng = np.random.default_rng((int(seed), 2))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def entries(n: int, k: int, seed: int, leaf: int) -> np.ndarray:
    """Up to k distinct flat indices of a tensor of n entries, drawn from
    the seed and the leaf's number, sorted."""
    rng = np.random.default_rng((int(seed), 3, leaf))
    return np.unique(rng.integers(0, n, size=min(k, n)))
