"""A columnar table: named Columns + row count (paper §5/§6 substrate)."""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from repro_torch.columnar.column import Column


class Table:
    def __init__(self, columns: Mapping[str, Column]):
        self.columns: dict[str, Column] = dict(columns)
        lengths = {c.n_rows for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged table: row counts {lengths}")
        self.n_rows = lengths.pop() if lengths else 0

    @classmethod
    def from_data(cls, data: Mapping[str, np.ndarray], sort_values: bool = False,
                  use_rle: bool = True, imcu_rows: int | None = None) -> "Table":
        kw = {} if imcu_rows is None else {"imcu_rows": imcu_rows}
        return cls({name: Column.from_data(np.asarray(arr), name=name,
                                           sort_values=sort_values,
                                           use_rle=use_rle, **kw)
                    for name, arr in data.items()})

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def names(self) -> list[str]:
        return list(self.columns)

    def select(self, names: Iterable[str]) -> "Table":
        """Columnar projection — only the named columns are touched (paper §5)."""
        return Table({n: self.columns[n] for n in names})

    @property
    def total_nbytes(self) -> int:
        return sum(c.total_nbytes for c in self.columns.values())

    def raw_nbytes(self, assume_csv: bool = False) -> int:
        return sum(c.raw_nbytes(assume_csv=assume_csv)
                   for c in self.columns.values())

    def summary(self) -> str:
        lines = [f"Table[{self.n_rows} rows, {len(self.columns)} cols, "
                 f"{self.total_nbytes}B packed vs {self.raw_nbytes()}B raw]"]
        for n, c in self.columns.items():
            d = c.dictionary
            lines.append(
                f"  {n}: K={d.cardinality} bits={d.bits} "
                f"packed={c.packed_nbytes}B dict={c.dictionary_nbytes}B "
                f"ratio={c.compression_ratio:.1f}x")
        return "\n".join(lines)
