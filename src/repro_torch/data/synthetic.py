"""Synthetic corpora with LM-like statistics (Zipf unigram + short-range
structure) for examples, benchmarks, and the end-to-end serving runs."""
from __future__ import annotations

import numpy as np


def synthetic_corpus(n_tokens: int, vocab: int, seed: int = 0,
                     zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed ids with a Markov-ish repetition structure so the
    model has something learnable (repeats + local bigram patterns)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -zipf_a
    probs /= probs.sum()
    base = rng.choice(vocab, size=n_tokens, p=probs)
    # inject learnable bigrams: token t follows (t*7+3) % vocab 30% of time
    follow = (base * 7 + 3) % vocab
    mask = rng.random(n_tokens) < 0.3
    out = base.copy()
    out[1:][mask[1:]] = follow[:-1][mask[1:]]
    return out.astype(np.int64)
