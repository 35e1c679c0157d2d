"""Wrappers for the ADV gather kernels (``adv_gather.cu``).

- :func:`fuse_tables` lays C per-column (K_c, F_c) ADV tables back to back
  in one resident float32 buffer, with the per-column metadata the kernels
  index it by (:class:`FusedTables`). The reference's block-diagonal
  super-table (sum K x sum F, sized for a one-hot matmul) has no
  counterpart: a direct gather needs only the tables themselves, so no
  plan is too large for the kernel path.
- :func:`adv_gather_packed_rows` — arbitrary row indices against the
  resident packed word stream -> concatenated features (kernel 1).
- :func:`adv_gather_packed` — K word-aligned ranges of ``batch`` rows from
  the same stream (kernel 2).
- :func:`gather_fused_parts` — (C, n) int32 codes -> features, the clamp
  fused into the kernel (kernel 3).
- :func:`adv_gather` — one (K, F) ADV table, float32 or bfloat16, gathered
  by int32 codes of any shape, each clamped to [0, K - 1] (kernel 4, the
  Table 6 featurization path). One kernel serves every K: the reference's
  switch to ``jnp.take`` past K = 2**16 computed the same function.

Each wrapper checks its inputs and raises on anything the kernel does not
take. For CPU tensors it computes the plain version (``ref.py``); for CUDA
tensors it launches the kernel on the current stream and raises if the
launch fails — there is no fallback. ``LAUNCHES`` counts kernel launches
per wrapper (only real launches, never plain-version calls).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.adv_gather import ref
from repro_torch.kernels.launch import check, device_kind, raise_on, stream_ptr

LAUNCHES = {"adv_gather_packed_rows": 0, "adv_gather_packed": 0,
            "gather_fused_parts": 0, "adv_gather": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "adv_gather_packed_rows": ([_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _I,
                                _I, _P], _I),
    "adv_gather_packed": ([_P, _I, _I, _P, _I64, _P, _P, _P, _P, _P, _I, _P],
                          _I),
    "gather_fused_parts": ([_P, _I64, _P, _P, _P, _P, _I, _P], _I),
    "adv_gather": ([_P, _I64, _P, _I, _I64, _I, _P, _P], _I),
    "adv_gather_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = (1 << 31) - 1
_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class FusedTables:
    """C per-column ADV tables, resident back to back, plus the metadata
    the kernels index them by. Built once per plan refresh."""
    tables: torch.Tensor      # (sum K_c*F_c,) float32, table c row-major
    meta: torch.Tensor        # (C, 4) int32: K_c - 1, base, F_c, col offset
    col_of: torch.Tensor      # (out_dim,) int32: source table of each column
    dims: tuple[int, ...]     # per-table feature width F_c
    cards: tuple[int, ...]    # per-table cardinality K_c

    @property
    def n_tables(self) -> int:
        return len(self.dims)

    @property
    def out_dim(self) -> int:
        return int(sum(self.dims))

    @property
    def nbytes(self) -> int:
        return int(self.tables.numel()) * 4


def fuse_tables(tables, device) -> FusedTables:
    """Lay C (K_c, F_c) host tables back to back on ``device``."""
    tables = [np.asarray(t, np.float32) for t in tables]
    cards = tuple(int(t.shape[0]) for t in tables)
    dims = tuple(int(t.shape[1]) for t in tables)
    meta = np.zeros((len(tables), 4), np.int32)
    base = col = 0
    for c, t in enumerate(tables):
        if t.shape[0] < 1:
            raise ValueError(f"table {c} is empty")
        meta[c] = (t.shape[0] - 1, base, t.shape[1], col)
        base += t.size
        col += t.shape[1]
    if base > _INT32_MAX:
        raise ValueError(f"{base} table floats exceed the kernels' int32 "
                         "offsets")
    flat = (np.concatenate([t.reshape(-1) for t in tables]) if tables
            else np.zeros(0, np.float32))
    col_of = np.repeat(np.arange(len(tables), dtype=np.int32), dims)
    return FusedTables(tables=torch.from_numpy(flat).to(device),
                       meta=torch.from_numpy(meta).to(device),
                       col_of=torch.from_numpy(col_of).to(device),
                       dims=dims, cards=cards)


def word_meta(word_offs, dbs, device) -> torch.Tensor:
    """(C, 2) int32 stream metadata: column c's first word in the flat
    resident stream and its device width (which must divide 32)."""
    if len(word_offs) != len(dbs):
        raise ValueError("one word offset per device width required")
    for db in dbs:
        if db not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"device width {db} does not divide 32")
    if any(off > _INT32_MAX for off in word_offs):
        raise ValueError("word offsets exceed int32")
    return torch.tensor(list(zip(word_offs, dbs)), dtype=torch.int32,
                        device=device).reshape(len(dbs), 2)


# -- argument checks ------------------------------------------------------------


def _check_fused(fused: FusedTables, device: torch.device) -> None:
    check("fused.tables", fused.tables, torch.float32, 1, device)
    check("fused.meta", fused.meta, torch.int32, 2, device)
    check("fused.col_of", fused.col_of, torch.int32, 1, device)
    if fused.meta.shape != (fused.n_tables, 4) or \
            fused.col_of.shape[0] != fused.out_dim:
        raise ValueError("fused table metadata does not match its dims")


def _check_words(flat_words, wmeta, fused, device) -> None:
    check("flat_words", flat_words, torch.int32, 1, device)
    check("wmeta", wmeta, torch.int32, 2, device)
    if wmeta.shape != (fused.n_tables, 2):
        raise ValueError(f"wmeta must be ({fused.n_tables}, 2), got "
                         f"{tuple(wmeta.shape)}")
    if fused.n_tables and flat_words.numel() == 0:
        raise ValueError("flat_words is empty")


def _lib() -> ctypes.CDLL:
    return build.load("adv_gather", _SIGNATURES)


# -- kernel 1: packed rows ----------------------------------------------------------


def adv_gather_packed_rows(flat_words: torch.Tensor, wmeta: torch.Tensor,
                           fused: FusedTables,
                           rows: torch.Tensor) -> torch.Tensor:
    """Arbitrary rows -> (n, out_dim) float32 features.

    ``flat_words`` (int32 storage of uint32 words) concatenates every
    column's resident stream; ``wmeta`` row c gives column c's word offset
    and device width; ``rows`` (n,) int32 are table row indices. Per row
    and column: word ``off_c + row // s``, field ``(row % s) * db``, clamp
    to ``K_c - 1``, copy the table row. The only per-call input that
    scales with the request is the index vector.
    """
    device = rows.device
    check("rows", rows, torch.int32, 1, device)
    _check_fused(fused, device)
    _check_words(flat_words, wmeta, fused, device)
    if device_kind(device) == "cpu":
        return ref.adv_gather_packed_rows_ref(flat_words, wmeta, fused, rows)
    n = rows.shape[0]
    out = torch.empty((n, fused.out_dim), dtype=torch.float32, device=device)
    if n == 0 or fused.out_dim == 0:
        return out
    lib = _lib()
    raise_on(lib.adv_gather_packed_rows(
        rows.data_ptr(), n, flat_words.data_ptr(), flat_words.numel(),
        wmeta.data_ptr(), fused.meta.data_ptr(), fused.col_of.data_ptr(),
        fused.tables.data_ptr(), out.data_ptr(), fused.out_dim,
        fused.n_tables, stream_ptr(device)),
        lib.adv_gather_error_string, "adv_gather_packed_rows")
    LAUNCHES["adv_gather_packed_rows"] += 1
    return out


# -- kernel 2: packed ranges --------------------------------------------------------


def adv_gather_packed(flat_words: torch.Tensor, wmeta: torch.Tensor,
                      fused: FusedTables, starts: torch.Tensor,
                      batch: int) -> torch.Tensor:
    """K ranges of ``batch`` rows -> (K * batch, out_dim) float32.

    ``starts`` (K,) int32 holds each range's first row; range k fills
    output rows ``k * batch`` onward. Word alignment of the ranges is the
    caller's contract (the executor's ``start % 32 == 0``); the kernel
    reads whatever words the rows map to.
    """
    device = starts.device
    check("starts", starts, torch.int32, 1, device)
    _check_fused(fused, device)
    _check_words(flat_words, wmeta, fused, device)
    k = starts.shape[0]
    if batch < 1 or batch > _INT32_MAX:
        raise ValueError(f"batch must be in [1, 2**31), got {batch}")
    if k > 65535:
        raise ValueError(f"at most 65535 ranges per launch, got {k}")
    if device_kind(device) == "cpu":
        return ref.adv_gather_packed_ref(flat_words, wmeta, fused, starts,
                                         batch)
    out = torch.empty((k * batch, fused.out_dim), dtype=torch.float32,
                      device=device)
    if k == 0 or fused.out_dim == 0:
        return out
    lib = _lib()
    raise_on(lib.adv_gather_packed(
        starts.data_ptr(), k, batch, flat_words.data_ptr(),
        flat_words.numel(), wmeta.data_ptr(), fused.meta.data_ptr(),
        fused.col_of.data_ptr(), fused.tables.data_ptr(), out.data_ptr(),
        fused.out_dim, stream_ptr(device)),
        lib.adv_gather_error_string, "adv_gather_packed")
    LAUNCHES["adv_gather_packed"] += 1
    return out


# -- kernel 3: int32 codes ----------------------------------------------------------


def gather_fused_parts(fused: FusedTables,
                       codes: torch.Tensor) -> torch.Tensor:
    """codes (C, n) int32 (codes[c] indexes table c) -> (n, out_dim).

    Out-of-range codes clamp into their own table (never the next one's
    rows), matching the reference's clamp before its kernel.
    """
    device = codes.device
    check("codes", codes, torch.int32, 2, device)
    _check_fused(fused, device)
    if codes.shape[0] != fused.n_tables:
        raise ValueError(f"expected {fused.n_tables} code rows, got "
                         f"{codes.shape[0]}")
    if device_kind(device) == "cpu":
        return ref.gather_fused_parts_ref(fused, codes)
    n = codes.shape[1]
    out = torch.empty((n, fused.out_dim), dtype=torch.float32, device=device)
    if n == 0 or fused.out_dim == 0:
        return out
    lib = _lib()
    raise_on(lib.gather_fused_parts(
        codes.data_ptr(), n, fused.meta.data_ptr(), fused.col_of.data_ptr(),
        fused.tables.data_ptr(), out.data_ptr(), fused.out_dim,
        stream_ptr(device)),
        lib.adv_gather_error_string, "gather_fused_parts")
    LAUNCHES["gather_fused_parts"] += 1
    return out


# -- kernel 4: one table, codes of any shape ----------------------------------------


def adv_gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table (K, F) float32 or bfloat16, codes int32 of any shape ->
    (*codes.shape, F) in the table's dtype: ``out[..., :] =
    table[clamp(codes[...], 0, K - 1), :]``, the table's rows bit for bit."""
    device = table.device
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    check("table", table, table.dtype, 2, device)
    check("codes", codes, torch.int32, codes.dim(), device)
    k, f = table.shape
    if not 1 <= k <= _INT32_MAX:
        raise ValueError(f"the table needs 1 to 2**31 - 1 rows, got {k}")
    if device_kind(device) == "cpu":
        return ref.adv_gather_ref(codes, table)
    out = torch.empty((*codes.shape, f), dtype=table.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    raise_on(lib.adv_gather(
        codes.data_ptr(), codes.numel(), table.data_ptr(), k, f,
        table.element_size(), out.data_ptr(), stream_ptr(device)),
        lib.adv_gather_error_string, "adv_gather")
    LAUNCHES["adv_gather"] += 1
    return out
