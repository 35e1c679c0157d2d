"""Wrappers for predicate pushdown on the resident packed words.

- :class:`ScanTerm` — one column's predicate in code space (from
  :func:`repro_torch.columnar.query.compile_predicate`); :func:`pack_terms`
  turns a term list into one small device term table and one flat device
  LUT (:class:`PackedTerms`), built once per compiled predicate.
- :func:`predicate_scan` — compiled terms over the flat resident stream ->
  ``(n,)`` bool selection mask and its match count, from ONE launch of the
  CUDA scan kernel (``predicate_scan.cu``), which reads the stream in place.
- :func:`compact_rows` — mask -> ascending matching row indices at a static
  length, on the mask's device, feeding the packed rows gather directly.
  Library ops (cumsum + searchsorted), as in the reference, where this step
  is not a Pallas kernel either.
- :func:`masked_counts` — the masked per-code histogram
  (:mod:`repro_torch.kernels.hist`), the aggregate core of pushdown.

For CPU tensors the scan runs its plain version (``ref.py``); for CUDA
tensors it launches the kernel on the current stream and raises if the
launch fails — there is no fallback. ``LAUNCHES`` counts kernel launches
(only real launches, never plain-version calls).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist.ops import masked_counts
from repro_torch.kernels.launch import check, device_kind, raise_on, stream_ptr
from repro_torch.kernels.predicate_scan import ref

LAUNCHES = {"predicate_scan": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "predicate_scan": ([_P, _I64, _P, _P, _I, _P, _I64, _I, _P, _P, _P], _I),
    "predicate_scan_error_string": ([_I], ctypes.c_char_p),
}

__all__ = ["LAUNCHES", "ScanTerm", "PackedTerms", "pack_terms",
           "predicate_scan", "compact_rows", "masked_counts",
           "reset_launches"]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class ScanTerm:
    """One column's compiled code-space predicate term.

    ``kind`` 0 matches the contiguous code range ``[lo, hi]`` (an empty
    range, ``hi < lo``, matches nothing); kind 1 matches where
    ``lut[code] != 0`` (``lut`` has one entry per dictionary code; codes
    past its end probe its last entry).
    """
    col: int
    kind: int
    lo: int = 0
    hi: int = -1
    lut: np.ndarray | None = field(default=None, compare=False)


@dataclass(frozen=True)
class PackedTerms:
    """A term list as the scan kernel reads it."""
    table: torch.Tensor        # (T, 6) int32: col, kind, lo, hi, lut_off, lut_len
    lut: torch.Tensor          # (L,) int32: every LUT term's table back to back
    cols: tuple[int, ...]      # each term's column (host copy)

    @property
    def n_terms(self) -> int:
        return len(self.cols)

    @property
    def nbytes(self) -> int:
        return 4 * (int(self.table.numel()) + int(self.lut.numel()))


def pack_terms(terms, dbs, device) -> PackedTerms:
    """Pack ``terms`` for repeated scans of a plan whose columns have device
    widths ``dbs``: one (T, 6) term table and one flat LUT on ``device``.
    A deployed filter family scans on every request, so executors cache the
    result per compiled predicate."""
    if not terms:
        raise ValueError("need at least one predicate term")
    table = np.zeros((len(terms), 6), np.int32)
    luts, off = [], 0
    for t, term in enumerate(terms):
        if not 0 <= term.col < len(dbs):
            raise ValueError(f"term column {term.col} outside plan "
                             f"(C={len(dbs)})")
        if term.kind == 0:
            table[t] = (term.col, 0, term.lo, term.hi, 0, 1)
        elif term.kind == 1:
            lut = np.asarray(term.lut, np.int32).reshape(-1)
            if lut.shape[0] == 0:
                raise ValueError("LUT term needs a K-entry table")
            table[t] = (term.col, 1, 0, -1, off, lut.shape[0])
            luts.append(lut)
            off += lut.shape[0]
        else:
            raise ValueError(f"unknown term kind {term.kind}")
    flat_lut = np.concatenate(luts) if luts else np.zeros(1, np.int32)
    return PackedTerms(table=torch.from_numpy(table).to(device),
                       lut=torch.from_numpy(flat_lut).to(device),
                       cols=tuple(int(t.col) for t in terms))


def predicate_scan(flat_words: torch.Tensor, wmeta: torch.Tensor,
                   packed: PackedTerms, n: int,
                   combine: str = "and") -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [0, n) of the resident stream under ``packed`` ->
    ``((n,) bool mask, match count)``, both on the stream's device.

    ``flat_words`` (int32 storage of uint32 words) holds every column's
    words; ``wmeta`` row c gives column c's word offset and device width.
    On the card the count is an int32 scalar from the same launch as the
    mask (one host sync reads both the count and the compaction's length);
    on the CPU it is the plain version's int64 sum.
    """
    if combine not in ("and", "or"):
        raise ValueError(f"unknown combinator {combine!r}")
    device = flat_words.device
    check("flat_words", flat_words, torch.int32, 1, device)
    check("wmeta", wmeta, torch.int32, 2, device)
    check("packed.table", packed.table, torch.int32, 2, device)
    check("packed.lut", packed.lut, torch.int32, 1, device)
    if wmeta.shape[1] != 2 or packed.table.shape != (packed.n_terms, 6):
        raise ValueError("wmeta must be (C, 2) and the term table (T, 6)")
    if not packed.n_terms or max(packed.cols) >= wmeta.shape[0]:
        raise ValueError(f"terms read columns {packed.cols} of a "
                         f"{wmeta.shape[0]}-column stream")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if n and flat_words.numel() == 0:
        raise ValueError("flat_words is empty")
    if device_kind(device) == "cpu":
        return ref.predicate_scan_ref(flat_words, wmeta, packed, n, combine)
    mask = torch.empty(n, dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    if n == 0:
        return mask, count
    lib = build.load("predicate_scan", _SIGNATURES)
    raise_on(lib.predicate_scan(
        flat_words.data_ptr(), flat_words.numel(), wmeta.data_ptr(),
        packed.table.data_ptr(), packed.n_terms, packed.lut.data_ptr(), n,
        int(combine == "or"), mask.data_ptr(), count.data_ptr(),
        stream_ptr(device)),
        lib.predicate_scan_error_string, "predicate_scan")
    LAUNCHES["predicate_scan"] += 1
    return mask, count


def compact_rows(mask: torch.Tensor, cap: int,
                 fill: int = 0) -> torch.Tensor:
    """Bitmap -> (cap,) int32 ascending matching row indices, on the mask's
    device. Entries past the match count hold ``fill`` (a valid row index,
    so the vector can feed the rows gather as is; callers slice the valid
    prefix off the output). The j-th match is the first row whose running
    count reaches j + 1."""
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    rows = torch.searchsorted(c, want, side="left")
    return torch.where(rows < mask.shape[0], rows,
                       torch.full_like(rows, fill)).to(torch.int32)
