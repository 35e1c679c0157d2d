"""Wrappers for the two counts kernels (``hist.cu``).

- :func:`hist` is the count-metadata build of paper §6.2: the (k,)
  per-code counts of an int32 code stream of any shape.
- :func:`masked_counts` is the aggregate core of predicate pushdown: the
  (k,) per-code counts of a resident column under a selection mask, from
  which count, sum and mean follow on K dictionary entries.

Both drop codes outside [0, k). For CPU tensors each computes the plain
version (``ref.py``); for CUDA tensors it launches the kernel on the
current stream and raises if the launch fails — there is no fallback.
``LAUNCHES`` counts kernel launches (only real launches, never
plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist import ref
from repro_torch.kernels.launch import check, device_kind, raise_on, stream_ptr

LAUNCHES = {"hist": 0, "masked_counts": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "counts": ([_P, _I64, _I, _P, _P], _I),
    "masked_counts": ([_P, _I64, _I, _I, _P, _I64, _I, _P, _P], _I),
    "hist_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = (1 << 31) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_k(k: int) -> None:
    if not 1 <= k <= _INT32_MAX:
        raise ValueError(f"k must be in [1, 2**31), got {k}")


def hist(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) int32 counts of each code in [0, k) among ``codes``, an int32
    tensor of any shape (contiguous); codes outside [0, k) are dropped."""
    device = codes.device
    check("codes", codes, torch.int32, codes.dim(), device)
    _check_k(k)
    if device_kind(device) == "cpu":
        return ref.hist_ref(codes, k)
    out = torch.zeros(k, dtype=torch.int32, device=device)
    if codes.numel() == 0:
        return out
    lib = build.load("hist", _SIGNATURES)
    raise_on(lib.counts(codes.data_ptr(), codes.numel(), k, out.data_ptr(),
                        stream_ptr(device)),
             lib.hist_error_string, "hist")
    LAUNCHES["hist"] += 1
    return out


def masked_counts(flat_words: torch.Tensor, off: int, db: int,
                  mask: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(k,) int32 counts, by code, of the rows in [0, n) whose ``mask``
    entry is set, for the column whose ``db``-bit words start at word
    ``off`` of ``flat_words`` (int32 storage of uint32 words). Codes >= k
    are dropped. ``mask`` is a bool vector of at least ``n`` entries."""
    device = flat_words.device
    check("flat_words", flat_words, torch.int32, 1, device)
    check("mask", mask, torch.bool, 1, device)
    if db not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"device width {db} does not divide 32")
    _check_k(k)
    if not 0 <= n <= mask.shape[0]:
        raise ValueError(f"n={n} outside the mask's {mask.shape[0]} rows")
    if n and not 0 <= off < min(flat_words.numel(), _INT32_MAX + 1):
        raise ValueError(f"word offset {off} outside the stream's "
                         f"{flat_words.numel()} words")
    if device_kind(device) == "cpu":
        return ref.masked_counts_ref(flat_words, off, db, mask, k, n)
    out = torch.zeros(k, dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = build.load("hist", _SIGNATURES)
    raise_on(lib.masked_counts(
        flat_words.data_ptr(), flat_words.numel(), off, db, mask.data_ptr(),
        n, k, out.data_ptr(), stream_ptr(device)),
        lib.hist_error_string, "masked_counts")
    LAUNCHES["masked_counts"] += 1
    return out
