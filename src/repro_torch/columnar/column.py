"""A dictionary-encoded column stored as bit-packed IMCUs (paper §5.1).

Mirrors Oracle In-Memory Compression Units: the code stream is chunked into
IMCUs of up to 2**19 rows; each IMCU is bit-packed at the column's dictionary
width and optionally RLE'd when profitable. Per-IMCU min/max code metadata
supports predicate pruning without touching the packed words.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.columnar.bitpack import pack_bits, unpack_bits, packed_nbytes
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar.rle import rle_encode, rle_decode, rle_nbytes
from repro_torch.kernels.bitunpack.kernel import tpu_width

IMCU_ROWS = 1 << 19  # 512K rows, paper §5.1


@dataclass
class _IMCU:
    n: int
    packed: np.ndarray | None          # uint32 words, or None if RLE-stored
    rle: tuple[np.ndarray, np.ndarray] | None
    code_min: int
    code_max: int
    # device views: words repacked ONCE at a device width (bits | 32), keyed by
    # that width — what the packed fast path ships instead of int32 codes
    device_views: dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        if self.rle is not None:
            return 4 * (self.rle[0].size + self.rle[1].size)
        return int(self.packed.nbytes)

    def device_words(self, bits: int, db: int) -> np.ndarray:
        """This IMCU's packed slice at device width ``db`` (bits | 32).

        Repacked once and cached; when the storage width already divides 32
        the stored words ARE the device view (zero-copy — fields never
        straddle words, so exact and device layouts coincide).
        """
        view = self.device_views.get(db)
        if view is None:
            if self.rle is not None:
                view = pack_bits(rle_decode(*self.rle), db)
            elif bits == db:
                view = self.packed                 # zero-copy: layouts agree
            else:
                view = pack_bits(unpack_bits(self.packed, bits, self.n), db)
            self.device_views[db] = view
        return view


class Column:
    """Dictionary-encoded, bit-packed column."""

    def __init__(self, dictionary: Dictionary, codes: np.ndarray,
                 use_rle: bool = True, imcu_rows: int = IMCU_ROWS):
        self.dictionary = dictionary
        self.n_rows = int(np.asarray(codes).size)
        self.imcu_rows = imcu_rows
        self._imcus: list[_IMCU] = []
        codes = np.asarray(codes, dtype=np.int32)
        bits = dictionary.bits
        for start in range(0, self.n_rows, imcu_rows):
            chunk = codes[start:start + imcu_rows]
            cmin, cmax = (int(chunk.min()), int(chunk.max())) if chunk.size else (0, 0)
            imcu = _IMCU(n=chunk.size, packed=None, rle=None,
                         code_min=cmin, code_max=cmax)
            if use_rle:
                vals, lens = rle_encode(chunk)
                if rle_nbytes(vals, lens, bits) < packed_nbytes(chunk.size, bits):
                    imcu.rle = (vals, lens)
            if imcu.rle is None:
                imcu.packed = pack_bits(chunk, bits)
            self._imcus.append(imcu)

    @classmethod
    def from_data(cls, data: np.ndarray, name: str = "col",
                  sort_values: bool = False, use_rle: bool = True,
                  imcu_rows: int = IMCU_ROWS) -> "Column":
        d, codes = Dictionary.from_data(data, name=name, sort_values=sort_values)
        return cls(d, codes, use_rle=use_rle, imcu_rows=imcu_rows)

    # -- access ---------------------------------------------------------------
    @property
    def n_imcus(self) -> int:
        return len(self._imcus)

    def imcu_bounds(self) -> list[tuple[int, int]]:
        """Row range [start, stop) of each IMCU."""
        bounds, start = [], 0
        for imcu in self._imcus:
            bounds.append((start, start + imcu.n))
            start += imcu.n
        return bounds

    def imcu_codes(self, i: int) -> np.ndarray:
        """Decompress a single IMCU's code stream (partition-local access).

        Lets per-IMCU feature plans touch only their own partition instead of
        materializing the full N-row stream.
        """
        imcu = self._imcus[i]
        if imcu.rle is not None:
            return rle_decode(*imcu.rle)
        return unpack_bits(imcu.packed, self.dictionary.bits, imcu.n)

    def codes(self) -> np.ndarray:
        """Materialize the int32 code stream (decompress all IMCUs)."""
        parts = [self.imcu_codes(i) for i in range(len(self._imcus))]
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    # -- device views (packed fast path) ----------------------------------------
    def imcu_device_words(self, i: int, db: int | None = None) -> np.ndarray:
        """One IMCU's packed words at the device width, without int32 codes.

        Cached on the IMCU, so per-IMCU shard plans and full-column plans
        share the same repacked buffers.
        """
        db = tpu_width(self.dictionary.bits) if db is None else db
        return self._imcus[i].device_words(self.dictionary.bits, db)

    def device_words(self, db: int | None = None) -> tuple[np.ndarray, int]:
        """Whole-column device-width word stream; returns (words, db).

        Per-IMCU views concatenate word-exactly when every interior IMCU's
        row count is a multiple of 32/db (fields at divisor widths never
        straddle words); otherwise the column is repacked in one pass.
        """
        db = tpu_width(self.dictionary.bits) if db is None else db
        s = 32 // db
        if not self._imcus:
            return np.zeros(0, np.uint32), db
        if all(m.n % s == 0 for m in self._imcus[:-1]):
            return np.concatenate(
                [self.imcu_device_words(i, db)
                 for i in range(len(self._imcus))]), db
        return pack_bits(self.codes(), db), db

    def decode(self) -> np.ndarray:
        """Materialize original values (the expensive thing the paper avoids)."""
        return self.dictionary.decode(self.codes())

    # -- storage accounting (paper Table 2 / §5 claims) ------------------------
    @property
    def packed_nbytes(self) -> int:
        return sum(i.nbytes for i in self._imcus)

    @property
    def dictionary_nbytes(self) -> int:
        v = self.dictionary.values
        if v.dtype == object:
            data = sum(len(str(x)) for x in v.tolist())
        else:
            data = v.nbytes
        return int(data + self.dictionary.counts.nbytes)

    @property
    def total_nbytes(self) -> int:
        return self.packed_nbytes + self.dictionary_nbytes

    def raw_nbytes(self, assume_csv: bool = False) -> int:
        """Size of the unencoded column (binary, or CSV text per paper §6.1.1)."""
        v = self.dictionary.values
        if assume_csv:
            per_row = np.zeros(self.dictionary.cardinality, dtype=np.int64)
            for i, x in enumerate(v.tolist()):
                per_row[i] = len(str(x)) + 1  # value chars + delimiter
            return int(np.dot(per_row, self.dictionary.counts))
        if v.dtype == object:
            lens = np.array([len(str(x)) for x in v.tolist()], dtype=np.int64)
            return int(np.dot(lens, self.dictionary.counts))
        return int(v.dtype.itemsize) * self.n_rows

    @property
    def compression_ratio(self) -> float:
        return self.raw_nbytes() / max(self.total_nbytes, 1)

    # -- predicate pruning ------------------------------------------------------
    def prune_imcus(self, code_set: np.ndarray) -> list[int]:
        """IMCU indices that might contain any code in ``code_set`` (min/max prune)."""
        code_set = np.asarray(code_set)
        lo, hi = int(code_set.min()), int(code_set.max())
        return [i for i, m in enumerate(self._imcus)
                if not (m.code_max < lo or m.code_min > hi)]
