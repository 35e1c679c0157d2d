"""Count-metadata accelerated statistics (paper §6.2) + scan baselines.

Each ``*_from_dictionary`` touches K dictionary entries; each ``*_scan``
baseline decodes and scans all N rows. Benchmarks compare the two to quantify
the paper's 'no scan required' claim.
"""
from __future__ import annotations

import numpy as np

from repro_torch.columnar.column import Column


# -- dictionary-path (K-cost) ------------------------------------------------
def sum_from_dictionary(col: Column) -> float:
    return col.dictionary.sum()


def mean_from_dictionary(col: Column) -> float:
    return col.dictionary.mean()


def std_from_dictionary(col: Column) -> float:
    return col.dictionary.std()


def histogram_from_dictionary(col: Column) -> tuple[np.ndarray, np.ndarray]:
    return col.dictionary.histogram()


def minmax_from_dictionary(col: Column) -> tuple[float, float]:
    d = col.dictionary
    return float(d.vmin), float(d.vmax)


# -- scan baselines (N-cost; what the paper's technique avoids) -----------------
def sum_scan(col: Column) -> float:
    return float(col.decode().astype(np.float64).sum())


def mean_scan(col: Column) -> float:
    return float(col.decode().astype(np.float64).mean())


def std_scan(col: Column) -> float:
    return float(col.decode().astype(np.float64).std())


def histogram_scan(col: Column) -> tuple[np.ndarray, np.ndarray]:
    vals, counts = np.unique(col.decode(), return_counts=True)
    return vals, counts


def minmax_scan(col: Column) -> tuple[float, float]:
    v = col.decode().astype(np.float64)
    return float(v.min()), float(v.max())
