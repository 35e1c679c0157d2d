"""Featurization catalog (paper §6.1 / Table 6) in the *dictionary domain*.

Every transform here maps a dictionary's K values to K feature values (shape
``(K,)`` or ``(K, F)``, float32). Applying a transform to the N-row column is
then a gather of the K-row result through the code stream — that gather is the
ADV fast path (paper §6.3) and is what ``repro_torch.kernels.adv_gather``
executes on device. The functions are deliberately pure numpy-over-dictionary
so they can be (a) precomputed once into ADVs and (b) used as
recompute-baselines in benchmarks.
"""
from __future__ import annotations

import numpy as np

from repro_torch.columnar.dictionary import Dictionary


# -- §6.1.1 numeric type conversion -------------------------------------------
def to_float(d: Dictionary) -> np.ndarray:
    """Float cast of dictionary values ('Age FP' ADV in paper Table 5)."""
    d._require_numeric("to_float")
    return d.values.astype(np.float32)


# -- §6.1.2 normalization ------------------------------------------------------
# Scale constants come from count metadata (§6.2) — no row scan.
def minmax_scale(d: Dictionary) -> np.ndarray:
    v = to_float(d)
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    return ((v - lo) / span).astype(np.float32)


def mean_normalize(d: Dictionary) -> np.ndarray:
    v = to_float(d)
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    return ((v - d.mean()) / span).astype(np.float32)


def zscore(d: Dictionary) -> np.ndarray:
    v = to_float(d)
    sd = d.std() or 1.0
    return ((v - d.mean()) / sd).astype(np.float32)


def log_scale(d: Dictionary) -> np.ndarray:
    v = to_float(d)
    if (v < 0).any():
        raise ValueError("log_scale requires non-negative values")
    return np.log1p(v).astype(np.float32)


# -- §6.1.3 one-hot -------------------------------------------------------------
def onehot(d: Dictionary, max_cardinality: int = 4096) -> np.ndarray:
    """(K, K) one-hot rows; stored as an ADV only for low-cardinality columns."""
    k = d.cardinality
    if k > max_cardinality:
        raise ValueError(f"one-hot of cardinality {k} > {max_cardinality}; "
                         "use embedding or hash buckets (paper §6.1.5/§6.1.4)")
    return np.eye(k, dtype=np.float32)


# -- §6.1.4 binarizer / quantile / hash buckets / bucketization -----------------
def binarize(d: Dictionary, threshold: float) -> np.ndarray:
    return (to_float(d) > threshold).astype(np.float32)


def quantile_bucket(d: Dictionary, q: int) -> np.ndarray:
    """Bucket index per dictionary value using count-metadata quantile edges."""
    edges = d.quantile_edges(q)
    return np.searchsorted(edges, to_float(d), side="right").astype(np.float32)


def hash_bucket(d: Dictionary, n_buckets: int, salt: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic modulo hash of dictionary values (paper §6.1.4)."""
    if d.is_numeric():
        h = d.values.astype(np.uint64)
        with np.errstate(over="ignore"):
            h = h * np.uint64(0x9E3779B97F4A7C15) + np.uint64(salt)
        h = np.bitwise_xor(h, h >> np.uint64(31)).astype(np.int64)
        h = np.abs(h)
    else:
        h = np.array([hash((salt, str(v))) for v in d.values.tolist()],
                     dtype=np.int64)
    return (np.abs(h) % n_buckets).astype(np.float32)


def bucketize(d: Dictionary, boundaries: np.ndarray) -> np.ndarray:
    """Non-linear bucketization with explicit boundary vector (paper Table 6)."""
    b = np.asarray(boundaries, dtype=np.float64)
    if (np.diff(b) <= 0).any():
        raise ValueError("boundaries must be strictly increasing")
    return np.searchsorted(b, to_float(d), side="right").astype(np.float32)


def bucketize_categorical(d: Dictionary, mapping: dict, default: float = 0.0) -> np.ndarray:
    """Categorical bucketization, e.g. state -> census region (paper Table 4)."""
    return np.array([float(mapping.get(v, default)) for v in d.values.tolist()],
                    dtype=np.float32)


# -- §6.1.5 embeddings -----------------------------------------------------------
def embedding_init(d: Dictionary, dim: int, seed: int = 0) -> np.ndarray:
    """(K, dim) learned-ADV initializer; training updates it, feedback.py
    writes the trained table back into the dictionary (paper §7)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d.cardinality, dim)) /
            np.sqrt(dim)).astype(np.float32)


# -- row-space application (the gather the ADV path replaces with a kernel) ------
def apply_feature(feature_table: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Gather dictionary-domain features to row space: out[i] = table[codes[i]]."""
    return np.asarray(feature_table)[np.asarray(codes)]


def onehot_rows(codes: np.ndarray, cardinality: int) -> np.ndarray:
    """Materialized row-space one-hot (recompute baseline for benchmarks)."""
    out = np.zeros((np.asarray(codes).size, cardinality), dtype=np.float32)
    out[np.arange(out.shape[0]), np.asarray(codes)] = 1.0
    return out
