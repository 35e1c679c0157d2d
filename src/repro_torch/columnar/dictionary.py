"""Column dictionary with min/max and count metadata (paper §5.1, §6.2).

Each distinct column value gets an integer *encoding* (code). Encodings are
internal to the store and need not follow the value ordering (paper Table 1/5
note) — we support both load-order and sorted assignment. The dictionary
carries:

- ``values``: code -> original value (numpy array, any dtype incl. object/str)
- ``counts``: code -> number of occurrences (paper §6.2) — lets sums / means /
  stds / histograms / min-max scaling constants be computed from K dictionary
  entries instead of N rows
- ``vmin/vmax``: column min/max metadata used for predicate pruning
- ADV columns are attached by :class:`repro_torch.core.adv.AugmentedDictionary`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.columnar.bitpack import bits_needed


@dataclass
class Dictionary:
    values: np.ndarray          # code -> value, length K
    counts: np.ndarray          # code -> count, int64, length K
    name: str = "col"
    sorted_codes: bool = False  # True if codes follow value order

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values)
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.values.shape[0] != self.counts.shape[0]:
            raise ValueError("values/counts length mismatch")
        self._index: dict[Any, int] | None = None
        # bumped on any insert/delete — count-derived statistics (mean, std,
        # quantiles) are only valid for a fixed version, so ADV maintenance
        # uses it to spot stale count-sensitive tables
        self.version = 0

    # -- construction -------------------------------------------------------
    @classmethod
    def from_data(cls, data: np.ndarray, name: str = "col",
                  sort_values: bool = False) -> tuple["Dictionary", np.ndarray]:
        """Build a dictionary from raw column data; returns (dict, codes).

        ``sort_values=False`` assigns codes in first-appearance (load) order,
        matching the paper's note that encodings are internal and unordered.
        """
        data = np.asarray(data)
        if sort_values:
            values, codes, counts = np.unique(data, return_inverse=True,
                                              return_counts=True)
        else:
            values, first_idx, codes, counts = np.unique(
                data, return_index=True, return_inverse=True, return_counts=True)
            order = np.argsort(first_idx)          # load order of first appearance
            rank = np.empty_like(order)
            rank[order] = np.arange(order.size)
            values = values[order]
            counts = counts[order]
            codes = rank[codes]
        return cls(values=values, counts=counts, name=name,
                   sorted_codes=sort_values), codes.astype(np.int32)

    # -- basic metadata ------------------------------------------------------
    @property
    def cardinality(self) -> int:
        return int(self.values.shape[0])

    @property
    def bits(self) -> int:
        return bits_needed(self.cardinality)

    @property
    def n_rows(self) -> int:
        return int(self.counts.sum())

    @property
    def vmin(self) -> Any:
        return self.values.min()

    @property
    def vmax(self) -> Any:
        return self.values.max()

    def is_numeric(self) -> bool:
        return np.issubdtype(self.values.dtype, np.number)

    # -- lookup --------------------------------------------------------------
    def code_of(self, value: Any) -> int:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values.tolist())}
        return self._index[value]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(codes)]

    # -- count-metadata statistics (paper §6.2) -------------------------------
    # All of these touch K dictionary entries, never the N-row code stream.
    def count_total(self) -> int:
        return self.n_rows

    def sum(self) -> float:
        self._require_numeric("sum")
        return float(np.dot(self.values.astype(np.float64), self.counts))

    def mean(self) -> float:
        return self.sum() / self.n_rows

    def var(self) -> float:
        self._require_numeric("var")
        v = self.values.astype(np.float64)
        mu = self.mean()
        return float(np.dot((v - mu) ** 2, self.counts) / self.n_rows)

    def std(self) -> float:
        return float(np.sqrt(self.var()))

    def histogram(self) -> tuple[np.ndarray, np.ndarray]:
        """(values, counts) — the dictionary IS the histogram (paper §6.2)."""
        return self.values, self.counts

    def quantile_edges(self, q: int) -> np.ndarray:
        """q-quantile edges from counts (no data scan). Numeric columns only."""
        self._require_numeric("quantile_edges")
        order = np.argsort(self.values)
        v = self.values[order].astype(np.float64)
        c = self.counts[order]
        cdf = np.cumsum(c) / self.n_rows
        targets = np.arange(1, q) / q
        idx = np.searchsorted(cdf, targets, side="left")
        return v[np.clip(idx, 0, v.size - 1)]

    # -- maintenance (inserts/updates/deletes, paper §6.3 last ¶) -------------
    def add_rows(self, data: np.ndarray) -> np.ndarray:
        """Insert new rows; extends the dictionary as needed. Returns codes."""
        data = np.asarray(data)
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values.tolist())}
        codes = np.empty(data.shape[0], dtype=np.int32)
        new_vals: list[Any] = []
        for i, v in enumerate(data.tolist()):
            code = self._index.get(v)
            if code is None:
                code = self.cardinality + len(new_vals)
                self._index[v] = code
                new_vals.append(v)
            codes[i] = code
        if new_vals:
            self.values = np.concatenate(
                [self.values, np.asarray(new_vals, dtype=self.values.dtype)])
            self.counts = np.concatenate(
                [self.counts, np.zeros(len(new_vals), dtype=np.int64)])
            self.sorted_codes = False
        np.add.at(self.counts, codes, 1)
        self.version += 1
        return codes

    def remove_rows(self, codes: np.ndarray) -> None:
        np.subtract.at(self.counts, np.asarray(codes), 1)
        if (self.counts < 0).any():
            raise ValueError("count underflow: removing rows not present")
        self.version += 1

    def _require_numeric(self, op: str) -> None:
        if not self.is_numeric():
            raise TypeError(f"{op} requires a numeric dictionary "
                            f"(column {self.name!r} is {self.values.dtype})")
