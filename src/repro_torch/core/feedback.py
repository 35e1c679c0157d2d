"""Analytics-cycle feedback (paper §7, Fig 2).

The paper's architecture stores learned artifacts back into the columnar
database so later analyses reuse them:

- trained embedding tables -> learned ADVs (``store_embedding``)
- model-inferred bucketizations (the 'ML G1 / DL G2' columns of Table 5)
  -> learned ADVs (``learn_bucketization``)
- feature importance/ranking feedback (``rank_features``)

Host-side numpy, as in the JAX package; a trained tensor is handed over as
a numpy array.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.adv import AugmentedDictionary


def store_embedding(aug: AugmentedDictionary, name: str,
                    table: np.ndarray, analysis: str = "") -> None:
    """Persist a trained (K, dim) embedding as a learned ADV for transfer reuse."""
    aug.add_learned(name, table, params={"analysis": analysis,
                                         "kind_hint": "embedding"})


def learn_bucketization(aug: AugmentedDictionary, name: str,
                        scores: np.ndarray, n_buckets: int,
                        analysis: str = "") -> np.ndarray:
    """Derive a new bucketization from per-dictionary-entry model scores.

    ``scores``: (K,) scalar the analysis assigned each dictionary value (e.g. a
    learned 1-d projection of its embedding, or its average predicted logit).
    Buckets are count-weighted quantiles of the scores, so each bucket holds
    roughly equal data mass — the paper's 'new bucketizations learned during
    the course of analysis'. Returns the (K,) bucket-index table written back.
    """
    scores = np.asarray(scores, np.float64).reshape(-1)
    counts = aug.dictionary.counts
    if scores.size != counts.size:
        raise ValueError("scores must have one entry per dictionary value")
    order = np.argsort(scores)
    cdf = np.cumsum(counts[order]) / max(counts.sum(), 1)
    bucket_of_sorted = np.minimum((cdf * n_buckets).astype(np.int64),
                                  n_buckets - 1)
    buckets = np.empty(scores.size, np.float32)
    buckets[order] = bucket_of_sorted.astype(np.float32)
    aug.add_learned(name, buckets,
                    params={"analysis": analysis, "n_buckets": n_buckets,
                            "kind_hint": "bucketize"})
    return buckets


def rank_features(grads: dict[str, np.ndarray]) -> list[tuple[str, float]]:
    """Feature importance from gradient magnitudes (paper §7 'importance/
    ranking/relevance of each feature'). Input: feature-name -> grad slice."""
    scores = {name: float(np.sqrt(np.mean(np.square(g))))
              for name, g in grads.items()}
    return sorted(scores.items(), key=lambda kv: -kv[1])
